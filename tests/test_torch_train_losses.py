"""The port's training losses against the JAX package's, on the CPU.

Same inputs, made from seeds with numpy, through condmdi_tpu's functions and
condmdi_tpu_torch's:

  * diffusion/losses.py, function by function, within 1e-6 * (1 + |jax|)
    (float32 elementwise math; only exp/log/tanh's last bits differ);
  * vb_terms_bpd and calc_bpd_loop (the noise JAX draws per step replayed)
    over a fixed affine denoiser, for the variance and mean types, within
    1e-5 * (1 + |jax|);
  * training_losses in every branch (mean types, learned-range variance with
    the frozen-mean vb term, KL and rescaled losses, traj_extra_weight,
    zero_keyframe_loss, keyframes_mse, lambda_vel, time_weighted_loss,
    train_x0_as_eps, apply_zero_mask), through the small keyframe UNet and the
    small MDM with the same weights (eval-mode forwards), each term within
    1e-5 * (1 + |jax|);
  * the gradient of the mean loss wrt every parameter of both models against
    jax.grad, within 1e-4 of the largest |gradient| of that parameter (the
    forwards agree to 1e-4 through the layers, tests/test_torch_unet.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.diffusion import gaussian as jg
from condmdi_tpu.diffusion import losses as jl
from condmdi_tpu.diffusion import schedule as js
from condmdi_tpu_torch.diffusion import gaussian as tg
from condmdi_tpu_torch.diffusion import losses as tl
from condmdi_tpu_torch.diffusion import schedule as ts
from condmdi_tpu_torch.weights import to_flax_params
from torch_train_helpers import B, F, STEPS, T, assert_close, make_batch, model_pair
from torch_eval_helpers import few_torch_threads  # noqa: F401 (module fixture)

ELEMENT_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4  # of the largest |gradient| of each parameter


def t_(a):
    return torch.from_numpy(np.asarray(a))


def schedules(steps=STEPS):
    betas = js.get_named_beta_schedule("cosine", steps)
    return js.DiffusionSchedule.create(betas), ts.DiffusionSchedule.create(betas)


# --------------------------------------------------------------------------- #
# losses.py
# --------------------------------------------------------------------------- #
def test_distribution_losses_match_jax():
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.standard_normal((3, 5, 7)).astype(np.float32) for _ in range(4))
    assert_close(tl.normal_kl(t_(a), t_(b), t_(c), t_(d)).numpy(),
                 jl.normal_kl(a, b, c, d), ELEMENT_TOL)
    assert_close(tl.normal_kl(t_(a), t_(b), 0.0, 0.0).numpy(),
                 jl.normal_kl(a, b, 0.0, 0.0), ELEMENT_TOL)
    x = np.clip(rng.standard_normal((3, 5, 7)), -1.2, 1.2).astype(np.float32)
    x[0, 0, :3] = [-1.0, 1.0, 0.9995]  # both edge branches
    assert_close(tl.approx_standard_normal_cdf(t_(x)).numpy(),
                 jl.approx_standard_normal_cdf(x), ELEMENT_TOL)
    # scales where the bin's probability is not a cancellation of two cdfs
    # near 1 (there float32's last bits of tanh decide the difference)
    means, log_scales = 0.2 * a, 0.1 * b + 0.3
    got = tl.discretized_gaussian_log_likelihood(t_(x), means=t_(means),
                                                 log_scales=t_(log_scales))
    want = jl.discretized_gaussian_log_likelihood(x, means=means, log_scales=log_scales)
    assert_close(got.numpy(), want, LOSS_TOL)
    assert_close(tl.mean_flat(t_(a)).numpy(), jl.mean_flat(a), ELEMENT_TOL)
    assert_close(tl.sum_flat(t_(a)).numpy(), jl.sum_flat(a), ELEMENT_TOL)


@pytest.mark.parametrize("over_keyframes", [False, True])
@pytest.mark.parametrize("time_weights", [False, True])
def test_masked_losses_match_jax(over_keyframes, time_weights):
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((B, T, F)).astype(np.float32) for _ in range(2))
    tmask = make_batch(1)["time_mask"]
    mask = (rng.random((B, T, F)) < 0.3) & tmask[..., None] if over_keyframes else tmask
    w = (1 + rng.random((B, 1, F))).astype(np.float32)
    tw = (rng.random((B, T, F)) + 0.5).astype(np.float32) if time_weights else None
    got = tl.masked_l2_weighted(t_(a), t_(b), t_(mask), t_(w),
                                None if tw is None else t_(tw), over_keyframes=over_keyframes)
    want = jl.masked_l2_weighted(a, b, mask, w, tw, over_keyframes=over_keyframes)
    assert_close(got.numpy(), want, ELEMENT_TOL)
    assert_close(tl.masked_l2(t_(a), t_(b), t_(tmask)).numpy(), jl.masked_l2(a, b, tmask),
                 ELEMENT_TOL)


# --------------------------------------------------------------------------- #
# vb_terms_bpd, calc_bpd_loop over an affine denoiser both frameworks compute
# --------------------------------------------------------------------------- #
def affine(seed, out_feats, target=None, scale=1.0):
    """tanh(x W + c + t/1000) in both frameworks; with `target` (the prediction
    the mean type asks for), target + scale * that on the first F outputs, so
    that the decoder term at t = 0 is not a cancellation of two cdfs near 1
    (there float32's last bits of tanh decide the bin's probability)."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((F, out_feats)) / np.sqrt(F)).astype(np.float32)
    c = (0.01 * rng.standard_normal(out_feats)).astype(np.float32)
    off = np.zeros((1, 1, out_feats), np.float32) if target is None else \
        np.concatenate([target, np.zeros(target.shape[:2] + (out_feats - F,), np.float32)], -1)

    def jax_fn(x, t):
        return off + scale * jnp.tanh(x @ W + c + 1e-3 * t[:, None, None])

    def torch_fn(x, t):
        return t_(off) + scale * torch.tanh(x @ t_(W) + t_(c) + 1e-3 * t[:, None, None])

    return jax_fn, torch_fn


VARIANTS = [  # (mean type, var type)
    ("start_x", "fixed_small"), ("start_x", "fixed_large"), ("eps", "fixed_small"),
    ("prev_x", "fixed_large"), ("start_x", "learned_range"), ("eps", "learned"),
]


def configs(mean, var, **kw):
    return (jg.DiffusionConfig(model_mean_type=jg.ModelMeanType(mean),
                               model_var_type=jg.ModelVarType(var), clip_range=6.0, **kw),
            tg.DiffusionConfig(model_mean_type=tg.ModelMeanType(mean),
                               model_var_type=tg.ModelVarType(var), clip_range=6.0,
                               **{k: (tg.LossType(v.value) if isinstance(v, jg.LossType) else v)
                                  for k, v in kw.items()}))


@pytest.mark.parametrize("mean,var", VARIANTS)
def test_vb_terms_bpd_matches_jax(mean, var):
    jsched, tsched = schedules()
    jcfg, tcfg = configs(mean, var)
    rng = np.random.default_rng(4)
    x0 = np.clip(0.5 * rng.standard_normal((B, T, F)), -1, 1).astype(np.float32)
    noise = rng.standard_normal((B, T, F)).astype(np.float32)
    t = np.array([0, 3, 11, STEPS - 1])
    xt = np.asarray(jg.q_sample(jsched, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    target = {"start_x": x0, "eps": noise,
              "prev_x": np.asarray(jg.q_posterior_mean_variance(
                  jsched, jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t))[0])}[mean]
    jfn, tfn = affine(3, 2 * F if var.startswith("learned") else F, target, 0.02)
    want = jg.vb_terms_bpd(jfn, jsched, jcfg, jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t))
    got = tg.vb_terms_bpd(tfn, tsched, tcfg, t_(x0), t_(xt), t_(t))
    assert_close(got["output"].numpy(), want["output"], LOSS_TOL)
    # x0 from eps is sqrt(1/a_t) x_t - sqrt(1/a_t - 1) eps: float32 rounding grows
    # with the terms, so the bound is 1e-5 of the larger term's size
    term = np.asarray(jsched.sqrt_recip_alphas_cumprod)[t][:, None, None] * np.abs(xt)
    err = np.abs(got["pred_xstart"].numpy() - np.asarray(want["pred_xstart"]))
    assert np.all(err <= LOSS_TOL * (1 + term)), float(err.max())


def test_calc_bpd_loop_matches_jax():
    steps = 6
    jsched, tsched = schedules(steps)
    jcfg, tcfg = configs("start_x", "fixed_small")
    x0 = np.clip(0.5 * np.random.default_rng(6).standard_normal((2, 8, F)), -1, 1)
    x0 = x0.astype(np.float32)
    jfn, tfn = affine(5, F, x0, 0.02)
    key = jax.random.key(7)
    want = jg.calc_bpd_loop(jfn, jsched, jcfg, jnp.asarray(x0), key)
    noises, rng = [], key  # the scan's per-step draws
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        noises.append(np.asarray(jax.random.normal(k, x0.shape, jnp.float32)))
    got = tg.calc_bpd_loop(tfn, tsched, tcfg, t_(x0), step_noise=noises)
    for key_ in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        assert_close(got[key_].numpy(), want[key_], LOSS_TOL)


# --------------------------------------------------------------------------- #
# training_losses through the small models
# --------------------------------------------------------------------------- #
BRANCHES = {
    "start_x": dict(),
    "eps": dict(mean="eps"),
    "prev_x": dict(mean="prev_x", var="fixed_large"),
    "traj_extra_weight": dict(traj_extra_weight=3.0),
    "zero_keyframe_loss": dict(zero_keyframe_loss=True),
    "lambda_vel": dict(lambda_vel=0.7),
    "time_weighted_loss": dict(time_weighted_loss=True),
    "train_x0_as_eps": dict(train_x0_as_eps=True),
    "apply_zero_mask": dict(apply_zero_mask=True),
    "kl": dict(loss_type="kl"),
    "rescaled_kl": dict(loss_type="rescaled_kl"),
}


def loss_inputs(kind, seed=8):
    batch = make_batch(seed)
    rng = np.random.default_rng(seed)
    t = rng.integers(0, STEPS, (B,))
    noise = rng.standard_normal((B, T, F)).astype(np.float32)
    obs = (rng.random((B, T, F)) < 0.2) & batch["time_mask"][..., None] if kind == "unet" \
        else None
    return batch, t, noise, obs


def denoisers(kind, jm, params, tm, batch, obs, out_scale=1.0):
    y_j = {"text_embed": jnp.asarray(batch["text_embed"])}
    y_t = {"text_embed": t_(batch["text_embed"])}
    kw_j = dict(obs_x0=jnp.asarray(batch["motion"]), obs_mask=jnp.asarray(obs)) \
        if kind == "unet" else {}
    kw_t = dict(obs_x0=t_(batch["motion"]), obs_mask=t_(obs)) if kind == "unet" else {}

    def jfn(x, t, p=params):
        return jm.apply(p, x, t, y_j, **kw_j) * out_scale

    def tfn(x, t):
        return tm(x, t, y_t, **kw_t) * out_scale

    return jfn, tfn


# zero_keyframe_loss needs keyframes, which MDM does not take
CASES = [(kind, branch) for kind in ("unet", "mdm") for branch in sorted(BRANCHES)
         if not (kind == "mdm" and branch == "zero_keyframe_loss")]


@pytest.mark.parametrize("kind,branch", CASES)
def test_training_losses_match_jax(kind, branch):
    opts = dict(BRANCHES[branch])
    mean, var = opts.pop("mean", "start_x"), opts.pop("var", "fixed_small")
    zero_kf = opts.pop("zero_keyframe_loss", False)
    if "loss_type" in opts:
        opts["loss_type"] = jg.LossType(opts["loss_type"])
    jcfg, tcfg = configs(mean, var, **opts)
    jsched, tsched = schedules()
    jm, params, tm = model_pair(kind)
    batch, t, noise, obs = loss_inputs(kind)
    # keep the KL branches' outputs in the data range the decoder term assumes
    jfn, tfn = denoisers(kind, jm, params, tm, batch, obs, 0.1 if "kl" in branch else 1.0)
    kf = dict(obs_mask=None if obs is None else jnp.asarray(obs), zero_keyframe_loss=zero_kf,
              keyframe_conditioned=kind == "unet")
    want = jg.training_losses(jfn, jsched, jcfg, jnp.asarray(batch["motion"]), jnp.asarray(t),
                              jnp.asarray(noise), jnp.asarray(batch["time_mask"]), **kf)
    kf["obs_mask"] = None if obs is None else t_(obs)
    with torch.no_grad():
        got = tg.training_losses(tfn, tsched, tcfg, t_(batch["motion"]), t_(t), t_(noise),
                                 t_(batch["time_mask"]), **kf)
    assert set(got) == set(want)
    for key in want:
        assert_close(got[key].numpy(), want[key], LOSS_TOL)


def test_learned_range_vb_term_matches_jax():
    """The learned-variance branch: the vb term over the frozen mean, rescaled
    for RESCALED_MSE, over the affine denoiser with a 2F output."""
    jsched, tsched = schedules()
    jfn, tfn = affine(9, 2 * F)
    jcfg, tcfg = configs("start_x", "learned_range", loss_type=jg.LossType.RESCALED_MSE)
    batch, t, noise, _ = loss_inputs("mdm", seed=10)
    want = jg.training_losses(jfn, jsched, jcfg, jnp.asarray(batch["motion"]), jnp.asarray(t),
                              jnp.asarray(noise), jnp.asarray(batch["time_mask"]))
    got = tg.training_losses(tfn, tsched, tcfg, t_(batch["motion"]), t_(t), t_(noise),
                             t_(batch["time_mask"]))
    assert {"vb", "rot_mse", "loss"} <= set(got) and set(got) == set(want)
    for key in want:
        assert_close(got[key].detach().numpy(), want[key], LOSS_TOL)


def test_smpl_losses_are_skipped_without_get_xyz():
    jsched, tsched = schedules()
    _, tfn = affine(11, F)
    _, tcfg = configs("start_x", "fixed_small", lambda_rcxyz=1.0, lambda_fc=1.0)
    batch, t, noise, _ = loss_inputs("mdm", seed=12)
    got = tg.training_losses(tfn, tsched, tcfg, t_(batch["motion"]), t_(t), t_(noise),
                             t_(batch["time_mask"]))
    assert set(got) == {"rot_mse", "loss"}


@pytest.mark.parametrize("kind", ["unet", "mdm"])
def test_loss_gradients_match_jax(kind):
    """d mean(loss) / d every parameter, the port's autograd (through ConvGnMish
    for the UNet, fused_self_attention's Function is CUDA-only) against
    jax.grad of the JAX loss."""
    jcfg, tcfg = configs("start_x", "fixed_small", lambda_vel=0.5)
    jsched, tsched = schedules()
    jm, params, tm = model_pair(kind, seed=13)
    batch, t, noise, obs = loss_inputs(kind, seed=14)
    kf = dict(zero_keyframe_loss=False, keyframe_conditioned=kind == "unet")

    def jax_loss(p):
        jfn, _ = denoisers(kind, jm, p, tm, batch, obs)
        terms = jg.training_losses(jfn, jsched, jcfg, jnp.asarray(batch["motion"]),
                                   jnp.asarray(t), jnp.asarray(noise),
                                   jnp.asarray(batch["time_mask"]),
                                   obs_mask=None if obs is None else jnp.asarray(obs), **kf)
        return jnp.mean(terms["loss"])

    want = to_flax_like(jax.grad(jax_loss)(params))
    _, tfn = denoisers(kind, jm, params, tm, batch, obs)
    terms = tg.training_losses(tfn, tsched, tcfg, t_(batch["motion"]), t_(t), t_(noise),
                               t_(batch["time_mask"]),
                               obs_mask=None if obs is None else t_(obs), **kf)
    terms["loss"].mean().backward()
    got = to_flax_like(to_flax_params({n: p.grad for n, p in tm.named_parameters()}))
    assert set(got) == set(want)
    for path in want:
        g, w = got[path], want[path]
        assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-8), path


def to_flax_like(tree):
    """{path: numpy} of a nested {"params": ...} tree."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64) for p, v in leaves}
