"""Gradients through the port's kernels' autograd Functions against JAX's, on the CPU.

Reconstruction guidance differentiates the keyframe loss through the UNet.
The port carries that gradient through `ops.resblock.ConvGnMish` and
`ops.quant.Int8Conv1d` (kernel forwards on the card, backwards that
recompute the plain versions); the JAX package differentiates its unfused
layers. Here, with numpy inputs from seeds and the same converted weights:

  * per op, every input's gradient against `jax.grad` of the JAX op:
    resblock within 1e-5 * (1 + |ref|) in float32 (only the order of the
    sums differs); int8 within 1e-6 * max |ref| (the codes pass no gradient;
    what is left are float32 sums over every output, of the scales' and the
    bias's terms, taken in another order);
  * per model (the small keyframe UNet), the gradient wrt x of a keyframe
    loss and the guided p_mean_variance step with injected noise: float
    within 1e-4 * max |ref| (the forward itself agrees to 1e-4 through the
    layers, tests/test_torch_diffusion.py); int8_static exactly zero, as
    JAX's is (the round has no derivative); dynamic int8 non-zero at the same
    single element, the input's amax, within 1e-3 relative (the codes of a
    few activations may move by one between the frameworks,
    tests/test_torch_quant.py);
  * under torch.no_grad() the served forward enters neither Function.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.diffusion import gaussian as jg
from condmdi_tpu.diffusion import schedule as js
from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu.ops import quant as jq
from condmdi_tpu.ops.resblock import reference_conv_gn_mish as jax_reference
from condmdi_tpu_torch.diffusion import gaussian as tg
from condmdi_tpu_torch.diffusion import schedule as ts
from condmdi_tpu_torch.models.unet import MDM_UNET as TorchUNet
from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock, Conv1dBlock, QConv
from condmdi_tpu_torch.ops import quant as tq
from condmdi_tpu_torch.ops import resblock
from condmdi_tpu_torch.weights import load_flax_params

RESBLOCK_TOL = 1e-5
INT8_GRAD_TOL = 1e-6  # relative to the largest |gradient|
FLOAT_MODEL_TOL = 1e-4  # relative to the largest |gradient|
DYNAMIC_REL_TOL = 1e-3

F = 263
B, T = 2, 28
UNET_CFG = dict(njoints=F, latent_dim=32, dim_mults=(1, 2), keyframe_conditioned=True,
                pad_frames_to=32)
MODES = ["float", "int8_static", "int8", "int8_static_pc", "int8_prequant"]


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= tol * (1 + np.abs(want))), err.max()


def assert_close_to_largest(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# --------------------------------------------------------------------------- #
# per op
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("adagn,res", [(True, False), (False, True), (True, True)])
def test_resblock_function_gradients_match_jax(adagn, res):
    """Every input's gradient through ConvGnMish (plain forward on the CPU,
    recompute backward) against jax.grad of the JAX package's reference."""
    rng = np.random.default_rng(7)
    Bs, Ts, cin, cout = 2, 12, 24, 32
    arrays = [rng.standard_normal((Bs, Ts, cin)), 0.05 * rng.standard_normal((5, cin, cout)),
              0.1 * rng.standard_normal(cout), 1 + 0.1 * rng.standard_normal(cout),
              0.1 * rng.standard_normal(cout)]
    names = ["x", "w", "b", "gamma", "beta"]
    if adagn:
        arrays += [0.2 * rng.standard_normal((Bs, cout)), 0.2 * rng.standard_normal((Bs, cout))]
        names += ["scale", "shift"]
    if res:
        arrays.append(rng.standard_normal((Bs, Ts, cout)))
        names.append("res")
    arrays = [a.astype(np.float32) for a in arrays]
    probe = rng.standard_normal((Bs, Ts, cout)).astype(np.float32)

    def jax_loss(*args):
        kw = dict(zip(names[5:], args[5:]))
        return jnp.sum(jax_reference(*args[:5], **kw) * probe)

    want = jax.grad(jax_loss, argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    tensors = [t(a) for a in arrays]
    tensors[1] = tensors[1].permute(2, 1, 0).contiguous()  # [k, Cin, Cout] -> [Cout, Cin, k]
    for v in tensors:
        v.requires_grad_(True)
    kw = dict(zip(names[5:], tensors[5:]))
    calls = []
    apply = resblock.ConvGnMish.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resblock.ConvGnMish, "apply", lambda *a: calls.append(1) or apply(*a))
        out = resblock.fused_conv_gn_mish(*tensors[:5], **kw)
    (out * t(probe)).sum().backward()
    assert calls == [1]
    for name, v, w in zip(names, tensors, want):
        g = v.grad.permute(2, 1, 0) if name == "w" else v.grad
        assert_close(g.numpy(), w, RESBLOCK_TOL)


def conv_case(k, seed, Bs=2, Ts=19, cin=40, cout=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bs, Ts, cin)).astype(np.float32)
    kernel = (rng.standard_normal((k, cin, cout)) / np.sqrt(cin * k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    probe = rng.standard_normal((Bs, (Ts + 2 * (k // 2) - k) + 1, cout)).astype(np.float32)
    return x, kernel, bias, probe


@pytest.mark.parametrize("form", ["dynamic", "static", "per_channel"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_quant_conv_gradients_match_jax(form, k):
    """Gradients of quant_conv1d_from_f32 wrt x, the float kernel and the bias:
    JAX's autodiff passes nothing through the rounded codes, so x gets the
    amax term of a dynamic scale and nothing for a static or folded one, and
    the kernel gets the gradient of its per-channel scale."""
    x, kernel, bias, probe = conv_case(k, seed=20 + k)
    cin = x.shape[-1]
    s = {"dynamic": None, "static": np.float32(0.021),
         "per_channel": (0.01 + 0.02 * np.random.default_rng(k).random(cin)).astype(np.float32)}[form]

    def jax_loss(x, kernel, bias):
        out = jq.quant_conv1d_from_f32(x, kernel, bias, stride=1, padding=k // 2,
                                       a_scale=None if s is None else jnp.asarray(s))
        return jnp.sum(out * probe)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(kernel),
                                                 jnp.asarray(bias))
    tx, tk, tb = t(x).requires_grad_(True), t(kernel).requires_grad_(True), t(bias).requires_grad_(True)
    calls = []
    apply = tq.Int8Conv1d.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tq.Int8Conv1d, "apply", lambda *a: calls.append(1) or apply(*a))
        out = tq.quant_conv1d_from_f32(tx, tk.permute(2, 1, 0), tb, 1, k // 2,
                                       None if s is None else torch.as_tensor(s))
    (out * t(probe)).sum().backward()
    assert calls == [1]
    for got, w in zip((tx.grad, tk.grad, tb.grad), want):
        assert_close_to_largest(got.numpy(), w, INT8_GRAD_TOL)
    nonzero = int((tx.grad != 0).sum())
    assert nonzero == (1 if form == "dynamic" else 0)
    assert int((np.asarray(want[0]) != 0).sum()) == nonzero


def test_int8_matmul_gradients_match_jax():
    """MDM's int8 QDense: dynamic activations, the weight's scale in-graph."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    kernel = (rng.standard_normal((48, 40)) / 7).astype(np.float32)  # Flax [in, out]
    bias = (0.1 * rng.standard_normal(40)).astype(np.float32)
    probe = rng.standard_normal((2, 9, 40)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jq.int8_matmul(*a) * probe), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    tx, tk, tb = (t(a).requires_grad_(True) for a in (x, kernel, bias))
    (tq.int8_matmul(tx, tk.t(), tb) * t(probe)).sum().backward()
    for got, w in zip((tx.grad, tk.grad, tb.grad), want):
        assert_close_to_largest(got.numpy(), w, INT8_GRAD_TOL)


# --------------------------------------------------------------------------- #
# per model: the small keyframe UNet in both frameworks
# --------------------------------------------------------------------------- #
def unet_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    obs = (0.5 * rng.standard_normal((B, T, F))).astype(np.float32)
    mask = np.zeros((B, T, F), bool)
    mask[:, ::5] = True
    text = rng.standard_normal((B, 512)).astype(np.float32)
    return x, obs, mask, text


@functools.lru_cache(maxsize=None)
def unets(mode):
    """(mode, JAX apply(x, t), port model, inputs): the same perturbed weights,
    and for the static modes the amaxes of one calibration pass."""
    x, obs, mask, text = unet_inputs()
    y = {"text_embed": jnp.asarray(text)}
    kw = dict(obs_x0=jnp.asarray(obs), obs_mask=jnp.asarray(mask))
    tt = jnp.asarray(np.array([10, 700]))
    jm = JaxUNet(**UNET_CFG, precision_mode=mode)
    fm = JaxUNet(**UNET_CFG, precision_mode="int8_static")  # float weights, as checkpoints hold
    v = fm.init(jax.random.key(0), jnp.asarray(x), tt, y, **kw)
    rng = np.random.default_rng(100)  # so the zero-initialised layers carry signal too
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.standard_normal(p.shape), jnp.float32),
        v["params"])
    variables = {"params": params}
    if mode == "int8_prequant":
        _, upd = fm.apply(variables, jnp.asarray(x), tt, y, **kw, mutable=["act_scale"])
        variables = {"params": jq.quantize_params_tree(params), **upd}
    elif mode.startswith("int8_static"):
        _, upd = jm.apply(variables, jnp.asarray(x), tt, y, **kw, mutable=["act_scale"])
        variables = {**variables, **upd}

    def jax_apply(xx, tm):
        return jm.apply(variables, xx, tm, y, **kw)

    tm = TorchUNet(**UNET_CFG, precision_mode=mode, device="cpu", seed=None)
    sd = load_flax_params(jax.tree_util.tree_map(np.asarray, variables))
    tm.load_state_dict({**{k: v for k, v in tm.state_dict().items() if k.endswith("amax")}, **sd})
    tm.requires_grad_(False)
    return mode, jax_apply, tm, (x, obs, mask, text)


def torch_apply(tm, obs, mask, text):
    def fn(xx, tmodel):
        return tm(xx, tmodel, {"text_embed": t(text)}, obs_x0=t(obs), obs_mask=t(mask))
    return fn


def assert_model_grad(mode, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    if mode == "float":
        assert np.abs(want).max() > 0
        assert np.abs(got - want).max() <= FLOAT_MODEL_TOL * np.abs(want).max()
    elif mode == "int8":  # the amax term of the input's dynamic scale, one element
        assert np.array_equal(got != 0, want != 0) and int((want != 0).sum()) == 1
        assert np.abs(got - want).max() <= DYNAMIC_REL_TOL * np.abs(want).max()
    else:  # static, folded or stored scales: the codes pass no gradient
        assert not got.any() and not want.any()


@pytest.mark.parametrize("mode", MODES)
def test_unet_gradient_of_a_keyframe_loss_matches_jax(mode):
    """d/dx of sum((obs - model(x))^2 * mask), the reconstruction-guidance loss."""
    mode, jax_apply, tm, (x, obs, mask, text) = unets(mode)
    tt = np.array([10, 700])

    def jax_loss(xx):
        return jnp.sum((jnp.asarray(obs) - jax_apply(xx, jnp.asarray(tt))) ** 2 * mask)

    want = jax.grad(jax_loss)(jnp.asarray(x))
    z = t(x).requires_grad_(True)
    loss = ((t(obs) - torch_apply(tm, obs, mask, text)(z, t(tt))) ** 2 * t(mask)).sum()
    (got,) = torch.autograd.grad(loss, z)
    assert_model_grad(mode, got.numpy(), want)


@pytest.mark.parametrize("mode", ["float", "int8_static", "int8"])
def test_guided_p_mean_variance_step_matches_jax(mode):
    """One guided step: p_mean_variance with imputation and reconstruction
    guidance through the UNet, then x_{t-1} = mean + sigma * z with z injected.
    (int8_static_pc is not held here: at these timesteps one activation code
    of its first downsample moves by one between the frameworks and the
    output follows by 0.7% mean-relative; its gradient, zero, is held above.)"""
    mode, jax_apply, tm, (_, obs, mask, text) = unets(mode)
    betas = js.get_named_beta_schedule("cosine", 1000)
    use = js.space_timesteps(1000, "ddim10")
    jsched = js.DiffusionSchedule.create(betas, use)
    tsched = ts.DiffusionSchedule.create(betas, use)
    rng = np.random.default_rng(9)
    xt = rng.standard_normal((B, T, F)).astype(np.float32)
    z = rng.standard_normal((B, T, F)).astype(np.float32)
    tt = np.array([2, 8])
    grad_ws = (jg.get_gradient_schedule("exponential", 10) * 5.0).astype(np.float32)
    jstate = jg.InpaintingState(
        inpainted_motion=jnp.asarray(obs), inpainting_mask=jnp.asarray(mask),
        grad_weights=jnp.asarray(grad_ws), stop_imputation_at=jnp.int32(0),
        stop_recguidance_at=jnp.int32(0), imputate=True, reconstruction_guidance=True)
    tstate = tg.InpaintingState(
        inpainted_motion=t(obs), inpainting_mask=t(mask), grad_weights=t(grad_ws),
        stop_imputation_at=0, stop_recguidance_at=0, imputate=True, reconstruction_guidance=True)
    jo = jg.p_mean_variance(jax_apply, jsched, jg.DiffusionConfig(), jnp.asarray(xt),
                            jnp.asarray(tt), inpaint=jstate)
    with torch.no_grad():  # as the sampler runs it; p_mean_variance enables grad itself
        to = tg.p_mean_variance(torch_apply(tm, obs, mask, text), tsched, tg.DiffusionConfig(),
                                t(xt), t(tt), inpaint=tstate)
    want = np.asarray(jo["mean"]) + np.exp(0.5 * np.asarray(jo["log_variance"])) * z
    got = (to["mean"] + torch.exp(0.5 * to["log_variance"]) * t(z)).numpy()
    # the guidance term's own difference, where the two gradients would differ
    scale = np.abs(want).max()
    tol = FLOAT_MODEL_TOL if mode == "float" else DYNAMIC_REL_TOL
    assert np.isfinite(got).all() and np.abs(got - want).max() <= tol * scale
    np.testing.assert_allclose(to["pred_xstart"].numpy(), np.asarray(jo["pred_xstart"]),
                               atol=tol * np.abs(np.asarray(jo["pred_xstart"])).max(), rtol=0)


@pytest.mark.parametrize("mode", ["float", "int8_static"])
def test_no_grad_forward_enters_no_autograd_function(mode, monkeypatch):
    """The served step runs under torch.no_grad(): no Function.apply there (each
    would add host time to every launch); under autograd every resblock half or
    int8 conv of the forward goes through its Function."""
    calls = {"resblock": 0, "int8": 0}

    def counting(fn, key):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(resblock.ConvGnMish, "apply",
                        counting(resblock.ConvGnMish.apply, "resblock"))
    monkeypatch.setattr(tq.Int8Conv1d, "apply", counting(tq.Int8Conv1d.apply, "int8"))
    tm = TorchUNet(**UNET_CFG, precision_mode=mode, device="cpu", seed=0).requires_grad_(False)
    x, obs, mask, text = unet_inputs(1)
    fn = torch_apply(tm, obs, mask, text)
    with torch.no_grad():
        fn(t(x), t(np.array([3, 9])))
    assert calls == {"resblock": 0, "int8": 0}
    fn(t(x).requires_grad_(True), t(np.array([3, 9])))
    halves = sum(isinstance(m, (Conv1dBlock, Conv1dAdaGNBlock)) for m in tm.modules())
    convs = sum(isinstance(m, QConv) for m in tm.modules())
    assert (halves, convs) == (17, 22)  # 8 resblocks of two halves and final_block; + 5 convs
    assert calls == ({"resblock": halves, "int8": 0} if mode == "float"
                     else {"resblock": 0, "int8": convs})
