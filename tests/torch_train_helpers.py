"""Shared set-up of the training tests: small UNet, MDM and DiT pairs (JAX
model and the port's with the same weights), a batch from a seed, and the JAX
train step's draws, dropout masks included, replayed into the port's step."""

import numpy as np
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from condmdi_tpu.models.dit import MDM_DiT as JaxDiT
from condmdi_tpu.models.mdm import MDM as JaxMDM
from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu.training.keyframes import get_keyframes_mask as jax_keyframes_mask
from condmdi_tpu_torch.models.dit import MDM_DiT as TorchDiT
from condmdi_tpu_torch.models.mdm import MDM as TorchMDM
from condmdi_tpu_torch.models.unet import MDM_UNET as TorchUNet
from condmdi_tpu_torch.weights import load_flax_params

F = 263
B, T = 4, 24
STEPS = 20  # diffusion steps of the training schedule
UNET = dict(njoints=F, latent_dim=32, dim_mults=(1, 2), keyframe_conditioned=True,
            pad_frames_to=24, zero=False)
MDM = dict(njoints=F, latent_dim=32, ff_size=64, num_layers=2, num_heads=4)
DIT = MDM  # the default arch, dit_prenorm


def make_batch(seed=0, B=B, T=T):
    rng = np.random.default_rng(seed)
    motion = (0.5 * rng.standard_normal((B, T, F))).astype(np.float32)
    lengths = np.full((B,), T, np.int32)
    lengths[1] = T - 6
    time_mask = np.arange(T)[None, :] < lengths[:, None]
    motion = motion * time_mask[..., None]
    return {"motion": motion, "time_mask": time_mask, "lengths": lengths,
            "text_embed": rng.standard_normal((B, 512)).astype(np.float32)}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() if k == "lengths"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def model_pair(kind, seed=0, perturb=0.05, **overrides):
    """(JAX module, its params as numpy, the port's module with them) for "unet",
    "mdm" or "dit"; the params perturbed so that zero-initialised layers carry
    signal."""
    batch = make_batch(seed)
    x, text = jnp.asarray(batch["motion"]), jnp.asarray(batch["text_embed"])
    t = jnp.zeros((B,), jnp.int32)
    if kind == "unet":
        cfg = {**UNET, **overrides}
        jm = JaxUNet(**cfg)
        kw = dict(obs_x0=x, obs_mask=jnp.zeros((B, T, F), bool)) if cfg["keyframe_conditioned"] \
            else {}
        params = jm.init(jax.random.key(seed), x, t, {"text_embed": text}, **kw)
        torch_cfg = {k: v for k, v in cfg.items() if k not in ("zero_keyframe_loss",)}
        tm = TorchUNet(**torch_cfg, device="cpu", seed=None)
    else:
        cfg = {**(MDM if kind == "mdm" else DIT), **overrides}
        jax_cls, torch_cls = (JaxMDM, TorchMDM) if kind == "mdm" else (JaxDiT, TorchDiT)
        jm = jax_cls(**cfg)
        params = jm.init(jax.random.key(seed), x, t, {"text_embed": text})
        tm = torch_cls(**cfg, device="cpu", seed=None)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda p: (p + perturb * rng.standard_normal(p.shape)).astype(np.float32), params)
    tm.load_state_dict(load_flax_params(params))
    return jm, params, tm


class ReplayModelDraws:
    """The port's TrainDraws interface with JAX's condition-dropout keep vector
    and its dropout masks, the masks handed out in JAX's call order; `used`
    counts the masks taken."""

    def __init__(self, cond_keep, dropout_masks):
        self.cond_keep, self.dropout_masks, self.used = cond_keep, dropout_masks, 0

    def keep(self, shape, keep_prob, device):
        if tuple(shape) == tuple(self.cond_keep.shape):
            return self.cond_keep.to(device)
        if self.used == len(self.dropout_masks):
            raise AssertionError(f"a dropout draw of shape {shape} that JAX did not make")
        mask = self.dropout_masks[self.used]
        if tuple(shape) != tuple(mask.shape):
            raise AssertionError(f"dropout draw {self.used}: shape {shape}, JAX's {mask.shape}")
        self.used += 1
        return mask.to(device)


class ReplayDraws:
    """The port's StepDraws interface returning the draws of one JAX step."""

    def __init__(self, t, noise, obs_mask, drop, cond_keep, dropout_masks):
        self.t, self.noise_, self.obs_mask, self.drop = t, noise, obs_mask, drop
        self.cond_keep, self.dropout_masks = cond_keep, dropout_masks
        self.model_draws = None

    def keyframe_mask(self, lengths, T, scheme):
        return self.obs_mask

    def keyframe_drop(self, B, prob, device):
        return self.drop.to(device)

    def timesteps(self, loss_aware, B, num_timesteps, device):
        return self.t.to(device), torch.ones(B)

    def noise(self, shape, dtype, device):
        return self.noise_.to(device=device, dtype=dtype)

    def model(self):
        self.model_draws = ReplayModelDraws(self.cond_keep, self.dropout_masks)
        return self.model_draws


def jax_dropout_masks(jm, params, rngs, batch, tcfg):
    """The dropout masks of JAX's training forward under `rngs`, in call order.
    A Flax mask depends on the rng, the module's path and the input's shape
    alone, so the model is applied here in training mode with the step's rngs,
    and each nn.Dropout with a rate reads its mask from ones (kept entries
    come back as 1 / keep_prob, dropped ones as 0)."""
    if not getattr(jm, "dropout", 0.0):
        return []
    masks = []

    def intercept(next_fun, args, kwargs, context):
        module = context.module
        if not (isinstance(module, fnn.Dropout) and context.method_name == "__call__"
                and module.rate > 0.0):
            return next_fun(*args, **kwargs)
        x = args[0]
        mask = next_fun(jnp.ones_like(x), *args[1:], **kwargs) != 0
        masks.append(torch.from_numpy(np.array(mask)))
        return jnp.where(mask, x / (1.0 - module.rate), jnp.zeros_like(x))

    x = jnp.asarray(batch["motion"])
    if tcfg.use_bf16:
        x = x.astype(jnp.bfloat16)
    t = jnp.zeros((x.shape[0],), jnp.int32)
    with fnn.intercept_methods(intercept):
        jm.apply(params, x, t, {"text_embed": jnp.asarray(batch["text_embed"])}, train=True,
                 rngs=rngs)
    return masks


def jax_step_draws(jm, params, rng, batch, tcfg, num_timesteps):
    """What `make_train_step`'s step draws from `rng`, split as it splits it
    (condmdi_tpu/training/loop.py), as a ReplayDraws."""
    rng_t, rng_kf, rng_drop, rng_loss = jax.random.split(rng, 4)
    Bn, Tn = batch["motion"].shape[:2]
    obs_mask = np.zeros((Bn, Tn, F), bool)
    drop = np.zeros((Bn, 1, 1), bool)
    if tcfg.keyframe_conditioned:
        obs_mask = np.asarray(jax_keyframes_mask(rng_kf, jnp.asarray(batch["lengths"]), Tn,
                                                 edit_mode=tcfg.keyframe_selection_scheme))
        if tcfg.keyframe_mask_prob > 0.0:
            drop = np.asarray(jax.random.bernoulli(rng_drop, tcfg.keyframe_mask_prob, (Bn, 1, 1)))
    t = np.asarray(jax.random.randint(rng_t, (Bn,), 0, num_timesteps))
    rng_noise, rng_model = jax.random.split(rng_loss)
    noise = np.asarray(jax.random.normal(rng_noise, batch["motion"].shape, jnp.float32))
    # the keep vector mask_cond draws from the "cond_mask" stream, through the
    # module's own method so that make_rng derives the same key
    ones = jnp.ones((Bn, 512), jnp.float32)
    kept = jm.apply(params, ones, False, True, method=type(jm).mask_cond,
                    rngs={"cond_mask": rng_model})
    cond_keep = torch.from_numpy(np.asarray(kept[:, :1]) > 0)
    masks = jax_dropout_masks(jm, params, {"cond_mask": rng_model,
                                           "dropout": jax.random.fold_in(rng_model, 1)},
                              batch, tcfg)
    return ReplayDraws(torch.from_numpy(t).long(), torch.from_numpy(noise),
                       torch.from_numpy(obs_mask), torch.from_numpy(drop), cond_keep, masks)


def assert_close(got, want, tol):
    """|got - want| <= tol * (1 + |want|) elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    assert np.all(err <= tol * (1 + np.abs(want))), float(err.max())
