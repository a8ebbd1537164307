"""The model options that the action-to-motion and unconstrained protocols and the
UNet's unconstrained training need, against the JAX package on the CPU in float32:

  * the Flax-init replica (`models/flax_init.flax_params`) of MDM `gru` with
    `action` (EmbedAction's normal table, the GRU cells' lecun and orthogonal
    kernels, the bias-less recurrent Dense), MDM `trans_enc_large` (grouped
    convolutions) and the UNet with `attention` and `action` (LinearAttention's
    bias-less to_qkv, ChannelLayerNorm), against `init(jax.random.key(seed))`
    within 1e-6 of each leaf's scale (1e-5 for the orthogonal kernels, whose
    float32 QR may differ in the last bits);
  * the weight round trip: `to_flax_params(load_flax_params(tree))` gives the tree;
  * forwards with JAX's weights carried across, within 1e-5: `gru`,
    `trans_enc_large` and `trans_dec_large` (out_mult 1 and 2), the UNet's
    `action`, `no_cond` and `attention`, and the attention UNet in an int8 mode
    and through its float twin;
  * 6-step DDPM samples from JAX's x_T with `zero_noise` through both
    SamplePipelines (gru, the attention UNet), within 2e-4;
  * three train steps of the keyframe-conditioned `no_cond` UNet with
    `attention` against `make_train_step(raw=True)`, JAX's draws replayed.
"""

import functools

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from condmdi_tpu.diffusion import DiffusionConfig as JaxDCfg
from condmdi_tpu.diffusion import DiffusionSchedule as JaxSched
from condmdi_tpu.diffusion import get_named_beta_schedule
from condmdi_tpu.diffusion import sampling as jsampling
from condmdi_tpu.models.mdm import MDM as JaxMDM
from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu.sampling.pipeline import SamplePipeline as JaxPipeline
from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule, SamplerConfig
from condmdi_tpu_torch.models import flax_init
from condmdi_tpu_torch.models.mdm import MDM as TorchMDM
from condmdi_tpu_torch.models.unet import MDM_UNET as TorchUNet
from condmdi_tpu_torch.models.unet import float_twin
from condmdi_tpu_torch.ops.quant import calibration
from condmdi_tpu_torch.sampling.pipeline import SamplePipeline
from condmdi_tpu_torch.weights import load_flax_params, to_flax_params
from torch_eval_helpers import few_torch_threads  # noqa: F401 (module fixture)

FWD_TOL = 1e-5
TRAJ_TOL = 2e-4
INIT_TOL, ORTHO_TOL = 1e-6, 1e-5
F, NUM_ACTIONS = 150, 12  # the a2m features: 25 joints x rot6d
MDM_SMALL = dict(njoints=25, nfeats=6, latent_dim=32, ff_size=64, num_layers=2, num_heads=4)
UNET_SMALL = dict(njoints=25, nfeats=6, latent_dim=16, dim_mults=(1, 2), pad_frames_to=24,
                  zero=False)

MODELS = {
    "gru_action": (JaxMDM, TorchMDM, dict(MDM_SMALL, arch="gru", cond_mode="action",
                                          num_actions=NUM_ACTIONS)),
    "gru_no_cond": (JaxMDM, TorchMDM, dict(MDM_SMALL, arch="gru", cond_mode="no_cond")),
    "trans_enc_large": (JaxMDM, TorchMDM, dict(MDM_SMALL, arch="trans_enc_large",
                                               cond_mode="action", num_actions=NUM_ACTIONS)),
    "trans_enc_large_x2": (JaxMDM, TorchMDM, dict(MDM_SMALL, arch="trans_enc_large",
                                                  cond_mode="no_cond", out_mult=2)),
    "trans_dec_large": (JaxMDM, TorchMDM, dict(MDM_SMALL, arch="trans_dec_large",
                                               cond_mode="no_cond", latent_dim=300)),
    "unet_action": (JaxUNet, TorchUNet, dict(UNET_SMALL, cond_mode="action",
                                             num_actions=NUM_ACTIONS)),
    "unet_no_cond": (JaxUNet, TorchUNet, dict(UNET_SMALL, cond_mode="no_cond")),
    "unet_attention": (JaxUNet, TorchUNet, dict(UNET_SMALL, cond_mode="action", attention=True,
                                                num_actions=NUM_ACTIONS)),
    "unet_attention_keyframes": (JaxUNet, TorchUNet, dict(
        UNET_SMALL, cond_mode="no_cond", attention=True, keyframe_conditioned=True)),
}


def inputs(B, T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    action = rng.integers(0, NUM_ACTIONS, (B,)).astype(np.int32)
    t = rng.integers(0, 1000, (B,)).astype(np.int32)
    obs = rng.standard_normal((B, T, F)).astype(np.float32)
    mask = rng.random((B, T, F)) < 0.3
    return x, action, t, obs, mask


def kwargs_of(cfg, obs, mask, conv):
    return dict(obs_x0=conv(obs), obs_mask=conv(mask)) if cfg.get("keyframe_conditioned") else {}


@functools.lru_cache(maxsize=None)  # Flax's init compiles each model: once a (model, seed)
def jax_init(name, seed=0, B=2, T=20):
    jax_cls, _, cfg = MODELS[name]
    x, action, t, obs, mask = inputs(B, T, seed)
    jm = jax_cls(**cfg)
    params = jm.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(t),
                     {"action": jnp.asarray(action)}, **kwargs_of(cfg, obs, mask, jnp.asarray))
    return jm, jax.tree_util.tree_map(np.asarray, params)


def pair(name, seed=0, **extra):
    """(JAX module, perturbed params, the port's module with them)."""
    jm, params = jax_init(name, seed)
    rng = np.random.default_rng(seed + 100)  # so zero-initialised layers carry signal too
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.05 * rng.standard_normal(p.shape)).astype(np.float32), params)
    _, torch_cls, cfg = MODELS[name]
    tm = torch_cls(**cfg, **extra, device="cpu", seed=None)
    flax_init.load_params(tm, load_flax_params(params))  # an int8_static model's amax apart
    return jm, params, tm


def flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree).items()}


# --------------------------------------------------------------------------- #
# the Flax-init replica and the weight round trip
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["gru_action", "trans_enc_large", "unet_attention",
                                  "unet_attention_keyframes"])
def test_flax_init_replica_matches_flax(name):
    _, params = jax_init(name, seed=3)
    want = flat(params["params"])
    _, torch_cls, cfg = MODELS[name]
    got = flax_init.flax_params(torch_cls(**cfg, device="cpu", seed=None), 3, "cpu")
    assert set(got) == set(want)
    for key, value in want.items():
        tol = ORTHO_TOL if key[-2] in ("hr", "hz", "hn") and key[-1] == "kernel" else INIT_TOL
        scale = np.abs(value).max() + 1e-12
        assert np.abs(got[key].numpy() - value).max() <= tol * scale, key
    # the GRU's tree: cells at the model's scope, hr/hz without a bias
    if name.startswith("gru"):
        assert ("GRUCell_1", "hn", "bias") in want and ("GRUCell_0", "hr", "bias") not in want


def test_flax_init_loads_into_the_model():
    """`load_flax_init` fills every parameter of an action MDM from a seed."""
    tm = TorchMDM(**MODELS["gru_action"][2], device="cpu", seed=None)
    flax_init.load_flax_init(tm, 5)
    _, params = jax_init("gru_action", seed=5)
    np.testing.assert_allclose(tm.embed_action.action_embedding.detach().numpy(),
                               params["params"]["embed_action"]["action_embedding"],
                               atol=INIT_TOL * 5, rtol=0)


@pytest.mark.parametrize("name", ["gru_action", "trans_enc_large_x2", "unet_attention"])
def test_weights_round_trip(name):
    _, params = jax_init(name, seed=1)
    _, torch_cls, cfg = MODELS[name]
    tm = torch_cls(**cfg, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(params))  # strict: the tree covers the model
    back, want = flat(to_flax_params(tm.state_dict())["params"]), flat(params["params"])
    assert set(back) == set(want)
    for key in want:
        assert np.array_equal(back[key], want[key]), key


# --------------------------------------------------------------------------- #
# forwards
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(name):
    jm, params, tm = pair(name)
    cfg = MODELS[name][2]
    B, T = 3, 17
    x, action, t, obs, mask = inputs(B, T, seed=1)
    y = {"action": action, "text_embed": np.ones((B, 512), np.float32)}
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t),
                               {k: jnp.asarray(v) for k, v in y.items()},
                               **kwargs_of(cfg, obs, mask, jnp.asarray)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 {k: torch.from_numpy(v) for k, v in y.items()},
                 **kwargs_of(cfg, obs, mask, torch.from_numpy)).numpy()
    assert got.shape == (B, T, F) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=FWD_TOL * (1 + np.abs(want).max()), rtol=0)


def test_action_and_uncond_change_the_output():
    """The action reaches the UNet's embedding, and `uncond` rows drop it."""
    _, _, tm = pair("unet_action")
    x, action, t, _, _ = inputs(2, 16, seed=2)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        a = tm(xt, tt, {"action": torch.tensor([0, 0])})
        b = tm(xt, tt, {"action": torch.tensor([5, 0])})
        c = tm(xt, tt, {"action": torch.tensor([5, 0]), "uncond": torch.tensor([True, False])})
        d = tm(xt, tt, {})
    assert not torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(c[0], d[0])


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_attention_unet_in_int8_modes_and_float_twin(mode):
    """The int8 modes carry LinearAttention and ChannelLayerNorm (float, as in JAX);
    the float twin shares them and computes the float forward."""
    jm, params, tm = pair("unet_attention", precision_mode=mode)
    tfloat = TorchUNet(**MODELS["unet_attention"][2], device="cpu", seed=None)
    tfloat.load_state_dict(load_flax_params(params))
    x, action, t, _, _ = inputs(2, 16, seed=4)
    args = (torch.from_numpy(x), torch.from_numpy(t), {"action": torch.from_numpy(action)})
    with torch.no_grad():
        if mode == "int8_static":
            with calibration(tm):
                tm(*args)
        q = tm(*args)
        twin = float_twin(tm)
        want = tfloat(*args)
        got = twin(*args)
    assert twin.unet.mid_attn.to_qkv.weight is tm.unet.mid_attn.to_qkv.weight
    assert twin.unet.down0_attn_norm.g is tm.unet.down0_attn_norm.g
    assert torch.equal(got, want)
    assert torch.isfinite(q).all() and (q - want).abs().max() < 0.2 * want.abs().max()


# --------------------------------------------------------------------------- #
# samples from JAX's x_T
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["gru_action", "unet_attention"])
def test_ddpm_sample_matches_jax(name):
    jm, params, tm = pair(name, seed=3)
    B, T = 2, 16
    rng = np.random.default_rng(9)
    xT = rng.standard_normal((B, T, F)).astype(np.float32)
    action = np.array([1, 7], np.int32)
    betas = get_named_beta_schedule("cosine", 1000)
    use = range(0, 1000, 167)  # 6 respaced steps
    jpipe = JaxPipeline(lambda x, t, y, **_: jm.apply(params, x, t, y), JaxSched.create(betas, use),
                        JaxDCfg(), jsampling.SamplerConfig(method="ddpm", zero_noise=True))
    tpipe = SamplePipeline(lambda x, t, y, **_: tm(x, t, y), DiffusionSchedule.create(betas, use),
                           DiffusionConfig(), SamplerConfig(method="ddpm", zero_noise=True),
                           device="cpu")
    want = np.asarray(jpipe.sample(jax.random.key(0), (B, T, F), {"action": jnp.asarray(action)},
                                   noise=jnp.asarray(xT)))
    got = tpipe.sample((B, T, F), {"action": torch.from_numpy(action)},
                       noise=torch.from_numpy(xT)).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=0)


# --------------------------------------------------------------------------- #
# the unconstrained attention UNet's train step against JAX's
# --------------------------------------------------------------------------- #
def test_unconstrained_attention_unet_train_steps_match_jax():
    from test_torch_train_step import STEP_CONFIGS, STEP_TOL, flat as flat_paths, setup_pair
    from torch_train_helpers import (
        STEPS,
        assert_close,
        jax_batch,
        jax_step_draws,
        make_batch,
        torch_batch,
    )

    jm, params, tm, jtc, jstep, jstate, tstep, tstate = setup_pair(
        "unet", cond_mode="no_cond", attention=True)
    assert not hasattr(tm, "embed_text") and hasattr(tm.unet, "mid_attn")
    for i in range(3):
        batch = make_batch(30 + i)
        rng = jax.random.key(40 + i)
        draws = jax_step_draws(jm, params, rng, batch, jtc, STEPS)
        jstate, jm_metrics = jstep(jstate, jax_batch(batch), rng)
        tm_metrics = tstep(tstate, torch_batch(batch), draws)
        assert set(tm_metrics) == set(jm_metrics)
        for k in jm_metrics:
            assert_close(float(tm_metrics[k]), float(jm_metrics[k]), STEP_TOL)
    got_p, want_p = flat_paths(to_flax_params(tm.state_dict())), flat_paths(jstate.params)
    got_e, want_e = flat_paths(to_flax_params(tstate.ema)), flat_paths(jstate.ema_params)
    assert set(got_p) == set(want_p) == set(got_e)
    assert any("mid_attn" in p for p in want_p)
    assert STEP_CONFIGS["unet"]["lr"] > 0
    for path in want_p:
        assert_close(got_p[path], want_p[path], STEP_TOL)
        assert_close(got_e[path], want_e[path], STEP_TOL)
