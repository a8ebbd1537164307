"""The port's int8 serving path against the JAX package, on the CPU.

Inputs come from numpy seeds and go through the JAX function and the port's.
Tolerances:
  * per op: int8 codes equal exactly; outputs within 1e-6 * (1 + |ref|) in
    float32 (the integer sums are exact on both sides; what is left is the
    order of two float32 roundings in the epilogue);
  * per module (small keyframe UNet in every QConv mode, 2-layer MDM in int8):
    mean |Δ| / mean |ref| <= 1e-4, and at most 0.1% of the elements beyond
    1e-3 * (1 + |ref|): an activation code moves by one where the float32
    rounding of the layers before it differs by an ulp (GroupNorm's variance
    is summed another way), and that code's weight row moves its outputs;
  * calibration: one pass, or the q_sample passes, record amaxes within 5e-2
    relative at the largest and 1e-4 at the median, for the same reason (one
    moved code moved a channel's largest input by 2.5% here); a whole
    dynamic-int8 trajectory fed JAX's own noise sequence within 5e-2 at the
    largest and 2e-3 at the median: there code moves compound over the steps,
    and on the port alone a 1e-6 relative change of x_T moves the amaxes by
    up to 2.5%.
The port's Flax-initialisation replica (condmdi_tpu_torch/models/flax_init.py) is held
to Flax's `init` at 1e-6 relative.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.diffusion import DiffusionConfig as JaxDCfg
from condmdi_tpu.diffusion import DiffusionSchedule as JaxSched
from condmdi_tpu.diffusion import get_named_beta_schedule
from condmdi_tpu.models.mdm import MDM as JaxMDM
from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu.ops import quant as jq
from condmdi_tpu_torch import bench as tbench
from condmdi_tpu_torch.models import flax_init
from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule
from condmdi_tpu_torch.diffusion.sampling import at_model_step
from condmdi_tpu_torch.models.mdm import MDM as TorchMDM
from condmdi_tpu_torch.models.unet import (
    MDM_UNET as TorchUNet,
    MixedStepDenoiser,
    QConv,
    cast_weights,
    float_twin,
)
from condmdi_tpu_torch.ops import quant as tq
from condmdi_tpu_torch.weights import load_flax_params

REPO = Path(__file__).resolve().parent.parent
OP_TOL = 1e-6
F = 263


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy: JAX's host arrays are read-only


def assert_op_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= OP_TOL * (1 + np.abs(want))), np.abs(got - want).max()


def assert_amax_close(state_dict, want, max_rel, median_rel):
    """Recorded amaxes (scalars or per-channel vectors) against JAX's, by the
    largest and the median relative difference over all their elements."""
    assert want and set(want) <= set(state_dict)
    rel = np.concatenate([np.abs(state_dict[k].numpy() / v.numpy() - 1).ravel()
                          for k, v in want.items()])
    assert rel.max() <= max_rel and np.median(rel) <= median_rel, (rel.max(), np.median(rel))


def assert_module_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    mean_rel = np.abs(got - want).mean() / np.abs(want).mean()
    outside = np.mean(np.abs(got - want) > 1e-3 * (1 + np.abs(want)))
    assert mean_rel <= 1e-4, mean_rel
    assert outside <= 1e-3, outside


# --------------------------------------------------------------------------- #
# per op
# --------------------------------------------------------------------------- #
def conv_case(k, stride, seed=0, B=2, T=19, cin=40, cout=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, cin)).astype(np.float32)
    kernel = (rng.standard_normal((k, cin, cout)) / np.sqrt(cin * k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, kernel, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_per_channel(dtype):
    _, kernel, _ = conv_case(5, 1)
    kj = jnp.asarray(kernel, dtype)
    wq_j, s_j = jq.quantize_weight_per_channel(kj)
    wq_t, s_t = tq.quantize_weight_per_channel(t(kernel).to(getattr(torch, dtype)).permute(2, 1, 0))
    assert np.array_equal(wq_t.permute(2, 1, 0).numpy(), np.asarray(wq_j))
    assert_op_close(s_t.float().numpy(), np.asarray(s_j, np.float32))


def test_quantize_activation_codes_and_ties():
    x, _, _ = conv_case(5, 1)
    x[0, 0, :4] = [0.5, 1.5, -2.5, 126.5]  # ties once amax is 127
    x[0, 1, 0] = 127.0
    xq_j, s_j = jq.quantize_activation(jnp.asarray(x))
    xq_t, s_t = tq.quantize_activation(t(x))
    assert np.array_equal(xq_t.numpy(), np.asarray(xq_j))
    assert s_t.item() == float(s_j)
    assert xq_t[0, 0, :4].tolist() == [0, 2, -2, 126]  # round half to even


@pytest.mark.parametrize("a_scale", ["dynamic", "static"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_int8_conv1d(k, stride, with_bias, a_scale):
    x, kernel, bias = conv_case(k, stride, seed=k + stride)
    pad = k // 2
    wq, ws = jq.quantize_weight_per_channel(jnp.asarray(kernel))
    s = None if a_scale == "dynamic" else jnp.float32(0.021)
    want = jq.int8_conv1d(jnp.asarray(x), wq, ws, jnp.asarray(bias) if with_bias else None,
                          stride=stride, padding=pad, a_scale=s)
    before = tq.int8_conv1d.launches
    got = tq.int8_conv1d(t(x), t(wq).permute(2, 1, 0).contiguous(), t(ws),
                         t(bias) if with_bias else None, stride, pad,
                         None if s is None else torch.tensor(0.021, dtype=torch.float32))
    assert tq.int8_conv1d.launches == before  # the CPU takes the plain version
    assert_op_close(got.numpy(), want)


@pytest.mark.parametrize("a_scale", ["dynamic", "scalar", "per_channel"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_quant_conv1d_from_f32(k, stride, a_scale):
    x, kernel, bias = conv_case(k, stride, seed=10 + k)
    cin = x.shape[-1]
    s = {"dynamic": None, "scalar": np.float32(0.03),
         "per_channel": (0.01 + 0.02 * np.random.default_rng(3).random(cin)).astype(np.float32)}[a_scale]
    want = jq.quant_conv1d_from_f32(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
                                    stride=stride, padding=k // 2,
                                    a_scale=None if s is None else jnp.asarray(s))
    got = tq.quant_conv1d_from_f32(t(x), t(kernel).permute(2, 1, 0), t(bias), stride, k // 2,
                                   None if s is None else torch.as_tensor(s))
    assert_op_close(got.numpy(), want)


def test_conv_reads_only_cin_channels_of_a_wider_x():
    """The UNet's first block hands its 528-channel buffer to a 526-channel conv."""
    x, kernel, bias = conv_case(5, 1)
    wide = np.concatenate([x, np.full(x.shape[:2] + (3,), 50.0, np.float32)], axis=-1)
    wq, ws = tq.quantize_weight_per_channel(t(kernel).permute(2, 1, 0))
    a = tq.int8_conv1d(t(wide), wq, ws, t(bias), 1, 2)
    b = tq.int8_conv1d(t(x), wq, ws, t(bias), 1, 2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_matmul(dtype, with_bias):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 48)).astype(np.float32)
    kernel = (rng.standard_normal((48, 40)) / 7).astype(np.float32)
    bias = (0.1 * rng.standard_normal(40)).astype(np.float32)
    dt = getattr(jnp, dtype)
    want = jq.int8_matmul(jnp.asarray(x), jnp.asarray(kernel, dt),
                          jnp.asarray(bias, dt) if with_bias else None)
    tdt = getattr(torch, dtype)
    got = tq.int8_matmul(t(x), t(kernel).to(tdt).t(), t(bias).to(tdt) if with_bias else None)
    assert_op_close(got.numpy(), np.asarray(want, np.float32))


def test_pack_int8_weight_layout():
    """The kernel's weight layout: [Cout, k * Cin_pad128], K index j * Cin_pad + c,
    zeros past Cin."""
    wq = torch.randint(-127, 128, (70, 100, 3), dtype=torch.int8)
    packed = tq.pack_int8_weight(wq)
    assert packed.shape == (70, 3 * 128) and packed.is_contiguous()
    unpacked = packed.reshape(70, 3, 128).permute(0, 2, 1)
    assert torch.equal(unpacked[:, :100], wq)
    assert not unpacked[:, 100:].any()


@pytest.mark.parametrize("B,T,cin,cout,k,stride,pad,want", [
    # UNet-XL at B=8 on 132 SMs: one wave of 128-row tiles, or the K steps split
    (8, 200, 1024, 1024, 5, 1, 2, dict(t_pad=204, m_tiles=13, n_tiles=8, split=1, steps=40)),
    (8, 25, 1024, 1024, 5, 1, 2, dict(t_pad=29, m_tiles=2, n_tiles=8, split=4, steps=40)),
    (8, 50, 1024, 1024, 5, 1, 2, dict(t_pad=54, m_tiles=4, n_tiles=8, split=3, steps=40)),
    (8, 200, 1024, 1024, 3, 2, 1, dict(t_pad=202, m_tiles=7, n_tiles=8, split=2, steps=24)),
    (8, 200, 526, 1024, 1, 1, 0, dict(t_pad=200, m_tiles=13, n_tiles=8, split=1, steps=5)),
    (8, 200, 1024, 263, 1, 1, 0, dict(t_pad=200, m_tiles=13, n_tiles=3, split=3, steps=8)),
    (1, 128 * 197, 512, 1536, 1, 1, 0, dict(t_pad=25216, m_tiles=197, n_tiles=12, split=1,
                                            steps=4)),
    (3, 17, 40, 24, 3, 2, 1, dict(t_pad=20, m_tiles=1, n_tiles=1, split=3, steps=3)),
    (1, 40, 1024, 128, 3, 1, 1, dict(t_pad=42, m_tiles=1, n_tiles=1, split=8, steps=24)),
])
def test_int8_plan_folds_the_batch_and_splits_small_grids(B, T, cin, cout, k, stride, pad, want):
    """The halo rows, the tiles of the batch-folded M and the split of the K steps,
    at most one cluster of 8 (csrc/quant.cu `make_plan`; the card test holds it to
    the library's)."""
    assert tq.int8_plan(B, T, cin, cout, k, stride, pad, 132) == want


def test_quantized_weight_cache_follows_weight_and_amax():
    conv = QConv(8, 6, 3, padding=1, precision_mode="int8_static_pc", device="cpu")
    torch.nn.init.normal_(conv.weight)
    conv.bias.data.zero_()
    with torch.no_grad():
        conv.amax.copy_(torch.linspace(0.5, 2.0, 8))
    first = conv.quantized.get(conv.weight, conv.bias, conv.amax, mode="static_pc")
    assert conv.quantized.get(conv.weight, conv.bias, conv.amax, mode="static_pc") is first
    with torch.no_grad():
        conv.amax.mul_(2.0)  # a recalibration
    second = conv.quantized.get(conv.weight, conv.bias, conv.amax, mode="static_pc")
    assert second is not first and not torch.equal(second.a_scale, first.a_scale)
    with torch.no_grad():
        conv.weight.mul_(-1.0)
    third = conv.quantized.get(conv.weight, conv.bias, conv.amax, mode="static_pc")
    assert torch.equal(third.wq, -second.wq)


# --------------------------------------------------------------------------- #
# per module
# --------------------------------------------------------------------------- #
B, T = 2, 28
UNET_CFG = dict(njoints=F, latent_dim=32, dim_mults=(1, 2), keyframe_conditioned=True,
                pad_frames_to=32)


def unet_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    obs = (0.5 * rng.standard_normal((B, T, F))).astype(np.float32)
    mask = np.zeros((B, T, F), bool)
    mask[:, ::5] = True
    text = rng.standard_normal((B, 512)).astype(np.float32)
    tt = np.array([10, 700])
    return x, obs, mask, text, tt


def jax_unet(mode, seed=0):
    """(JAX model, variables with calibrated act_scale where the mode has one, inputs)."""
    x, obs, mask, text, tt = unet_inputs(seed)
    jm = JaxUNet(**UNET_CFG, precision_mode=mode)
    kw = dict(obs_x0=jnp.asarray(obs), obs_mask=jnp.asarray(mask))
    y = {"text_embed": jnp.asarray(text)}
    fm = JaxUNet(**UNET_CFG, precision_mode="int8_static")  # float weights, as checkpoints hold
    v = fm.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(tt), y, **kw)
    rng = np.random.default_rng(seed + 100)  # so zero-initialised layers carry signal too
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.standard_normal(p.shape), jnp.float32),
        v["params"])
    variables = {"params": params}
    if mode in ("int8_static", "int8_static_pc", "int8_prequant"):
        if mode == "int8_prequant":
            _, upd = fm.apply({"params": params}, jnp.asarray(x), jnp.asarray(tt), y, **kw,
                              mutable=["act_scale"])
            variables = {"params": jq.quantize_params_tree(params), **upd}
        else:
            _, upd = jm.apply(variables, jnp.asarray(x), jnp.asarray(tt), y, **kw,
                              mutable=["act_scale"])
            variables = {**variables, **upd}
    return jm, variables, (x, obs, mask, text, tt)


def torch_unet(mode, variables):
    """The port's model with the converted variables; amaxes the variables do
    not hold start at zero, as a Flax init makes them."""
    tm = TorchUNet(**UNET_CFG, precision_mode=mode, device="cpu", seed=None)
    sd = load_flax_params(jax.tree_util.tree_map(np.asarray, variables))
    tm.load_state_dict({**{k: v for k, v in tm.state_dict().items() if k.endswith("amax")}, **sd})
    return tm.requires_grad_(False)


@pytest.mark.parametrize("mode", ["float", "int8", "int8_static", "int8_static_pc",
                                  "int8_prequant"])
def test_unet_forward_matches_jax(mode):
    jm, variables, (x, obs, mask, text, tt) = jax_unet(mode)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(tt), {"text_embed": jnp.asarray(text)},
                    obs_x0=jnp.asarray(obs), obs_mask=jnp.asarray(mask))
    tm = torch_unet(mode, variables)
    got = tm(t(x), t(tt), {"text_embed": t(text)}, obs_x0=t(obs), obs_mask=t(mask))
    assert_module_close(got.numpy(), want)


@pytest.mark.parametrize("mode", ["int8_static", "int8_static_pc"])
def test_unet_calibration_pass_matches_jax(mode):
    """One pass in the calibration state (Flax's mutable act_scale): the same
    output (dynamic int8) and the same recorded amaxes."""
    jm, variables, (x, obs, mask, text, tt) = jax_unet(mode, seed=1)
    kw = dict(obs_x0=jnp.asarray(obs), obs_mask=jnp.asarray(mask))
    y = {"text_embed": jnp.asarray(text)}
    want, upd = jm.apply({"params": variables["params"]}, jnp.asarray(x), jnp.asarray(tt), y,
                         **kw, mutable=["act_scale"])
    tm = torch_unet(mode, {"params": variables["params"]})
    with torch.no_grad(), tq.calibration(tm):
        got = tm(t(x), t(tt), {"text_embed": t(text)}, obs_x0=t(obs), obs_mask=t(mask))
    assert_module_close(got.numpy(), want)
    assert_amax_close(tm.state_dict(), load_flax_params(jax.tree_util.tree_map(np.asarray, upd)),
                      5e-2, 1e-4)


def test_mdm_int8_forward_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    text = rng.standard_normal((B, 512)).astype(np.float32)
    tt = np.array([3, 500])
    cfg = dict(njoints=F, latent_dim=64, ff_size=128, num_layers=2, num_heads=4,
               precision_mode="int8")
    jm = JaxMDM(**cfg)
    y = {"text_embed": jnp.asarray(text)}
    v = jm.init(jax.random.key(4), jnp.asarray(x), jnp.asarray(tt), y)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(tt), y)
    tm = TorchMDM(**cfg, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(jax.tree_util.tree_map(np.asarray, v)))
    got = tm(t(x), t(tt), {"text_embed": t(text)})
    assert_module_close(got.detach().numpy(), want)


# --------------------------------------------------------------------------- #
# calibration with JAX's noise sequence
# --------------------------------------------------------------------------- #
def jax_noise_sequence(seed, shape, steps):
    """x_T = normal(key(seed)), then one split per step, as the JAX calibration draws them."""
    rng = jax.random.key(seed)
    x_T = np.asarray(jax.random.normal(rng, shape))
    zs = []
    for _ in range(steps):
        rng, nrng = jax.random.split(rng)
        zs.append(t(np.asarray(jax.random.normal(nrng, shape))))
    return t(x_T), zs


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_calibrate_act_scales_trajectory_matches_jax(guidance):
    jm, variables, (x, obs, mask, text, tt) = jax_unet("int8_static", seed=2)
    betas = get_named_beta_schedule("cosine", 1000)
    use = range(0, 1000, 125)  # 8 respaced steps
    shape = (B, T, F)
    want = jq.calibrate_act_scales_trajectory(
        jm, {"params": variables["params"]}, JaxSched.create(betas, use), JaxDCfg(), shape,
        {"text_embed": jnp.asarray(text)}, guidance_param=guidance, obs_x0=jnp.asarray(obs),
        obs_mask=jnp.asarray(mask), seed=100)
    tm = torch_unet("int8_static", variables)
    x_T, zs = jax_noise_sequence(100, shape, 8)
    tq.calibrate_act_scales_trajectory(
        tm, DiffusionSchedule.create(betas, use), DiffusionConfig(), shape,
        {"text_embed": t(text)}, guidance_param=guidance, obs_x0=t(obs), obs_mask=t(mask),
        noise=x_T, step_noise=zs)
    flat = load_flax_params(jax.tree_util.tree_map(np.asarray, {"act_scale": want["act_scale"]}))
    sd = tm.state_dict()
    assert len(flat) == sum(k.endswith(".amax") for k in sd)
    assert_amax_close(sd, flat, 5e-2, 2e-3)


def test_calibrate_act_scales_matches_jax():
    jm, variables, (x, obs, mask, text, tt) = jax_unet("int8_static_pc", seed=3)
    betas = get_named_beta_schedule("cosine", 1000)
    kw = dict(obs_x0=jnp.asarray(obs), obs_mask=jnp.asarray(mask))
    x0 = (0.5 * np.random.default_rng(9).standard_normal((B, T, F))).astype(np.float32)
    fracs = (0.999, 0.5, 0.0)
    want = jq.calibrate_act_scales(jm, {"params": variables["params"]}, JaxSched.create(betas),
                                   jnp.asarray(x0), {"text_embed": jnp.asarray(text)},
                                   t_fracs=fracs, seed=100, **kw)
    noise = [t(np.asarray(jax.random.normal(jax.random.key(100 + i), x0.shape)))
             for i in range(len(fracs))]
    tm = torch_unet("int8_static_pc", variables)
    tq.calibrate_act_scales(tm, DiffusionSchedule.create(betas), t(x0), {"text_embed": t(text)},
                            t_fracs=fracs, noise=noise, obs_x0=t(obs), obs_mask=t(mask))
    assert_amax_close(tm.state_dict(), load_flax_params(
        jax.tree_util.tree_map(np.asarray, {"act_scale": want["act_scale"]})), 5e-2, 1e-4)


def test_calibration_state_ends_and_static_scales_serve():
    """After calibration the model serves on the recorded static scales: its
    output equals a fresh model's with the same weights and amaxes."""
    _, variables, (x, obs, mask, text, tt) = jax_unet("int8_static", seed=5)
    tm = torch_unet("int8_static", {"params": variables["params"]})
    y = {"text_embed": t(text)}
    kw = dict(obs_x0=t(obs), obs_mask=t(mask))
    x2 = t(unet_inputs(6)[0])
    with torch.no_grad():
        with tq.calibration(tm):
            tm(t(x), t(tt), y, **kw)
        served = tm(x2, t(tt), y, **kw)
        fresh = TorchUNet(**UNET_CFG, precision_mode="int8_static", device="cpu", seed=None)
        fresh.load_state_dict(tm.state_dict())
        again = fresh(x2, t(tt), y, **kw)
        with tq.calibration(fresh):
            dynamic = fresh(x2, t(tt), y, **kw)
    assert not any(m.calibrating for m in tm.modules() if isinstance(m, QConv))
    assert torch.equal(served, again)
    assert not torch.equal(served, dynamic)


# --------------------------------------------------------------------------- #
# the float-tail mixed-step denoiser
# --------------------------------------------------------------------------- #
def test_mixed_step_branches_on_the_model_timestep():
    """Either side of K the mixed denoiser IS the single-mode model's output:
    a scheduler, not a third numeric path (tests/test_quant.py pins the JAX
    side the same way)."""
    K = 100
    _, variables, (x, obs, mask, text, _) = jax_unet("int8_static", seed=6)
    tm = torch_unet("int8_static", variables)
    mixed = MixedStepDenoiser(tm, K)
    y = {"text_embed": t(text)}
    kw = dict(obs_x0=t(obs), obs_mask=t(mask))
    late, early = torch.full((B,), K - 1), torch.full((B,), K)
    with torch.no_grad():
        # the branch is the sampler's host step (at_model_step), as a sampler loop sets it
        with at_model_step(K - 1):
            assert torch.equal(mixed(t(x), late, y, **kw), mixed.twin(t(x), late, y, **kw))
        with at_model_step(K):
            assert torch.equal(mixed(t(x), early, y, **kw), tm(t(x), early, y, **kw))
        of, o8 = mixed.twin(t(x), early, y, **kw), tm(t(x), early, y, **kw)
    assert mixed.for_step(K - 1) is mixed.twin and mixed.for_step(K) is tm
    assert (of - o8).abs().mean() / of.abs().mean() > 1e-3


def test_float_twin_shares_the_parameters():
    _, variables, _ = jax_unet("int8_static", seed=7)
    tm = torch_unet("int8_static", variables)
    twin = float_twin(tm)
    own = dict(tm.named_parameters())
    pairs = list(twin.named_parameters())
    assert len(pairs) == len(own) and all(p is own[n] for n, p in pairs)
    assert twin.precision_mode == "float" and not any(b.is_meta for b in twin.buffers())
    w = tm.unet.down0_res1.block1.conv.weight
    with torch.no_grad():
        w.mul_(0.5)
    assert twin.unet.down0_res1.block1.conv.weight.data_ptr() == w.data_ptr()


@pytest.mark.parametrize("mode", ["float", "int8_prequant"])
def test_mixed_step_rejects_modes_without_an_int8_leg_to_mix(mode):
    tm = TorchUNet(**UNET_CFG, precision_mode=mode, device="cpu")
    with pytest.raises(ValueError, match="k_float"):
        MixedStepDenoiser(tm, 250)
    assert MixedStepDenoiser(tm, 0).twin is None  # no float tail: the model alone


def test_cast_weights_keeps_amax_float32():
    tm = TorchUNet(**UNET_CFG, precision_mode="int8_static", device="cpu")
    cast_weights(tm, torch.bfloat16)
    assert tm.unet.final_conv.weight.dtype == torch.bfloat16
    assert tm.unet.final_conv.amax.dtype == torch.float32
    tm.to(torch.bfloat16)  # rounds the amaxes too: the QConv refuses them
    x = torch.zeros((1, 4, F), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="cast_weights"):
        tm(x, torch.zeros(1, dtype=torch.long), {"text_embed": torch.zeros(1, 512)},
           obs_x0=x, obs_mask=torch.zeros(x.shape, dtype=torch.bool))


# --------------------------------------------------------------------------- #
# the int8_prequant weight bridge
# --------------------------------------------------------------------------- #
def test_prequant_bridge_keeps_codes_and_the_scale_names_apart():
    _, variables, _ = jax_unet("int8_prequant", seed=8)
    sd = load_flax_params(jax.tree_util.tree_map(np.asarray, variables))
    kq = np.asarray(variables["params"]["unet"]["down0_res1"]["block1"]["conv"]["kernel_q"])
    got = sd["unet.down0_res1.block1.conv.weight_q"]
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), kq.transpose(2, 1, 0))
    # the QConv's `scale` is its weight scale; the GroupNorm's `scale` beside it is a norm weight
    assert "unet.down0_res1.block1.conv.weight_scale" in sd
    assert "unet.down0_res1.block1.conv.weight" not in sd
    assert "unet.down0_res1.block1.norm.weight" in sd
    assert "unet.down0_res1.block1.conv.amax" in sd


def test_port_quantize_params_tree_matches_jax():
    _, variables, _ = jax_unet("int8_static", seed=9)
    jax_tree = jq.quantize_params_tree(variables["params"])
    want = load_flax_params(jax.tree_util.tree_map(np.asarray, {"params": jax_tree}))
    got = tq.quantize_params_tree(load_flax_params(
        jax.tree_util.tree_map(np.asarray, {"params": variables["params"]})))
    assert set(got) == set(want)
    for key in want:
        if want[key].dtype == torch.int8:
            assert torch.equal(got[key], want[key]), key
        else:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=0)


# --------------------------------------------------------------------------- #
# the bench counterpart
# --------------------------------------------------------------------------- #
def _jax_params_flat(params):
    return {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("model", ["unet", "unet_int8_static", "mdm_int8"])
def test_flax_init_replica_matches_flax(model):
    """condmdi_tpu_torch.models.flax_init.flax_params against `init(jax.random.key(0))`."""
    x = jnp.zeros((B, T, F))
    t0 = jnp.zeros((B,), jnp.int32)
    y = {"text_embed": jnp.zeros((B, 512))}
    if model.startswith("mdm"):
        cfg = dict(njoints=F, latent_dim=32, ff_size=64, num_layers=2, num_heads=4,
                   precision_mode="int8")
        params = JaxMDM(**cfg).init(jax.random.key(0), x, t0, y)["params"]
        tm = TorchMDM(**cfg, device="cpu", seed=None)
    else:
        mode = tbench.UNET_MODES[model]
        params = JaxUNet(**UNET_CFG, precision_mode=mode).init(
            jax.random.key(0), x, t0, y, obs_x0=x, obs_mask=jnp.zeros((B, T, F), bool))["params"]
        tm = TorchUNet(**UNET_CFG, precision_mode=mode, device="cpu", seed=None)
    want = _jax_params_flat(params)
    got = flax_init.flax_params(tm, 0, "cpu")
    assert set(got) == set(want)
    for key, value in want.items():
        scale = np.abs(value).max() + 1e-12
        assert np.abs(got[key].numpy() - value).max() <= 1e-6 * scale, key


def test_threefry_matches_jax_random_bits():
    key = jax.random.key(7)
    folded = jax.random.fold_in(key, 12345)
    want = np.asarray(jax.random.bits(folded, (1000,), jnp.uint32)).astype(np.int64)
    k = flax_init._fold_in((0, 7), 12345)
    assert k == tuple(int(v) for v in np.asarray(jax.random.key_data(folded)))
    assert np.array_equal(flax_init._random_bits(k, 1000, "cpu").numpy(), want)


def test_golden_name_and_criteria(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import bench as jax_bench  # the root bench.py, the reference for these two

    for which in tbench.BENCH_MODELS:
        assert tbench.golden_name(which) == jax_bench.golden_name(which)
    golden = np.asarray(json.loads(
        (REPO / "tests" / "golden" / "bench_traj_unet_pad200.json").read_text())["slice"])
    assert tbench.check_against_golden("unet", golden + 4e-3, 5e-3)[0] is True
    assert tbench.check_against_golden("unet", golden + 6e-3, 5e-3)[0] is False
    ok, err = tbench.check_against_golden("unet_int8_static", golden * 1.05, 5e-3)
    assert ok and abs(err - 0.05) < 1e-6
    assert tbench.check_against_golden("unet_int8_static", golden * 1.2, 5e-3)[0] is False


@pytest.mark.parametrize("which", ["mdm", "mdm_int8"])
def test_port_bench_mdm_matches_committed_golden(which):
    """The port's own bench MDM (Flax's initialisation replayed without JAX,
    bench.py's perturbation, f32 DDIM-20, B=2) against
    tests/golden/bench_traj_mdm.json: max-abs 5e-3 for float, mean-relative
    0.10 for int8, as bench.py checks them."""
    got = tbench.verify_trajectory(which, device="cpu")
    ok, err = tbench.check_against_golden(which, got, 5e-3)
    assert ok, err


@pytest.mark.slow
def test_xl_int8_static_matches_committed_golden():
    """The port's verify_trajectory('unet_int8_static') at full UNet-XL width
    (pad 200, B=2, f32 DDIM-20) against tests/golden/bench_traj_unet_pad200.json
    by check_against_golden's mean-relative 0.10. Slow: full width on the CPU."""
    import time

    t0 = time.perf_counter()
    got = tbench.verify_trajectory("unet_int8_static", device="cpu")
    ok, err = tbench.check_against_golden("unet_int8_static", got, 5e-3)
    print(f"unet_int8_static golden: mean-relative {err:.4f} in "
          f"{time.perf_counter() - t0:.1f} s on the CPU")
    assert ok, err


@pytest.mark.slow
def test_build_run_mixed_program_on_cpu(monkeypatch):
    """bench.build_run('unet_int8_mixed') end to end at B=1 on the CPU, the
    1000-step schedule respaced to 4 steps (model t 750, 500, 250, 0: three
    int8 steps, then the float twin below BENCH_FLOAT_LAST_K=250)."""
    from condmdi_tpu_torch.diffusion import schedule as sched_mod

    create = sched_mod.DiffusionSchedule.create.__func__
    monkeypatch.setattr(sched_mod.DiffusionSchedule, "create", classmethod(
        lambda cls, betas, use_timesteps=None: create(cls, betas, range(0, 1000, 250))))
    run, label = tbench.build_run("unet_int8_mixed", B=1, device="cpu")
    out = run(torch.Generator().manual_seed(0))
    assert "mixed-step" in label and "last 250 steps float" in label
    assert out.shape == (1, tbench.T, tbench.F) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
