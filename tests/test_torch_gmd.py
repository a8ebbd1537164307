"""The port's GMD guidance (sampling/gmd.py) and the xz_only trajectory UNet
against the JAX package's, on the CPU in float32.

  * keyframe patterns, obstacles, targets and the p2p trajectory: exactly;
  * CondKeyLocations / CondKeyLocationsWithSdf: the loss and its gradient
    with respect to pred_xstart (torch.autograd against jax.grad) within
    LOSS_TOL * (1 + |ref|), through the traj_only branch and through
    recover_from_ric (abs and relative root), with a keyframe past the cut
    (the mask sum is over the whole mask) and on both sides of the stop gate;
  * the xz_only UNet's forward (weights carried from the JAX tree) within
    LOSS_TOL, and the port's replay of Flax's initialisation of it exactly;
  * one guided DDPM step (the JAX scan body from its public functions), a
    whole 8-step zero-noise guided trajectory stage at scale 5, and
    `two_stage_generate` with both stages' x_T drawn with jax.random as the
    JAX function draws them, within ATOL (tests/test_torch_sampling.py's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.diffusion import DiffusionConfig as JaxDCfg
from condmdi_tpu.diffusion import DiffusionSchedule as JaxSched
from condmdi_tpu.diffusion import gaussian as jg
from condmdi_tpu.diffusion import get_named_beta_schedule
from condmdi_tpu.diffusion import sampling as jsampling
from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu.sampling import gmd as jgmd
from condmdi_tpu.sampling.pipeline import SamplePipeline as JaxPipeline
from condmdi_tpu.utils.assets import NormStats as JaxStats
from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule, SamplerConfig
from condmdi_tpu_torch.diffusion import sampling as tsampling
from condmdi_tpu_torch.models.flax_init import flax_params
from condmdi_tpu_torch.models.unet import MDM_UNET as TorchUNet
from condmdi_tpu_torch.sampling import gmd as tgmd
from condmdi_tpu_torch.sampling.pipeline import SamplePipeline
from condmdi_tpu_torch.utils.assets import NormStats
from condmdi_tpu_torch.weights import load_flax_params
from torch_eval_helpers import few_torch_threads  # noqa: F401  (module fixture)

LOSS_TOL = 1e-5
ATOL = 2e-4  # float32 over a whole 8-step trajectory of a small UNet
B, T = 2, 32
SCALE = 5.0  # guidance at large weights is chaotic on random models
# a keyframe past the 6 s cut (frame 120): it counts in the mask sum only
KFRAMES = [(1, (0.0, 0.0)), (9, (0.5, 1.5)), (20, (-1.0, 2.0)), (27, (1.0, 0.5)),
           (125, (2.0, 2.0))]
TRAJ = dict(njoints=4, latent_dim=16, dim_mults=(1, 2), pad_frames_to=T, zero=False)
MOTION = dict(njoints=263, latent_dim=16, dim_mults=(1, 2), pad_frames_to=T, zero=False)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert np.all(err <= tol * (1 + np.abs(want))), err.max()


def stats_pair(dim, seed):
    """The same random normalisation stats for both packages."""
    rng = np.random.default_rng(seed)
    mean = (0.3 * rng.standard_normal(dim)).astype(np.float32)
    std = (0.5 + rng.random(dim)).astype(np.float32)
    return JaxStats(mean, std), NormStats(mean, std)


# --------------------------------------------------------------------------- #
# patterns and targets
# --------------------------------------------------------------------------- #
def test_patterns_obstacles_and_targets_equal_jax():
    assert tgmd.KFRAME_PATTERNS == jgmd.KFRAME_PATTERNS
    assert tgmd.get_obstacles() == jgmd.get_obstacles()
    for name in jgmd.KFRAME_PATTERNS:
        for interpolate in (False, True):
            assert tgmd.get_kframes(name, interpolate=interpolate) == \
                jgmd.get_kframes(name, interpolate=interpolate)
    ground = np.random.default_rng(3).standard_normal((120, 22, 3)).astype(np.float32)
    assert tgmd.get_kframes(ground_positions=ground) == jgmd.get_kframes(ground_positions=ground)
    for kframes in (KFRAMES, jgmd.get_kframes("zigzag")):
        jt, jm = jgmd.kframes_to_target(kframes, B, T)
        tt, tm = tgmd.kframes_to_target(kframes, B, T, device="cpu")
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert tm.dtype == torch.bool
        np.testing.assert_array_equal(tgmd.interpolate_kframes_trajectory(kframes, 130),
                                      jgmd.interpolate_kframes_trajectory(kframes, 130))


# --------------------------------------------------------------------------- #
# the guidance losses and their gradients
# --------------------------------------------------------------------------- #
def guides(sdf, traj_only, abs_3d=True, use_mse_loss=False, stop_cond_from=0, n_frames=130):
    F = 4 if traj_only else 263
    jstats, tstats = stats_pair(F, 5)
    jt, jm = jgmd.kframes_to_target(KFRAMES, B, n_frames)
    tt, tm = tgmd.kframes_to_target(KFRAMES, B, n_frames, device="cpu")
    kw = dict(abs_3d=abs_3d, traj_only=traj_only, use_mse_loss=use_mse_loss,
              stop_cond_from=stop_cond_from, motion_length_cut=6.0)
    if sdf:
        # obstacles the trajectory reaches into
        obstacles = ((0.2, 0.1, 1.5), (-0.5, 0.4, 2.0))
        return (jgmd.CondKeyLocationsWithSdf(jt, jm, jstats, obstacles=obstacles, **kw),
                tgmd.CondKeyLocationsWithSdf(tt, tm, tstats, obstacles=obstacles, **kw), F)
    return (jgmd.CondKeyLocations(jt, jm, jstats, **kw),
            tgmd.CondKeyLocations(tt, tm, tstats, **kw), F)


@pytest.mark.parametrize("sdf", [False, True], ids=["keyframes", "sdf"])
@pytest.mark.parametrize("branch", ["traj_only", "ric_abs", "ric_rel", "traj_only_mse"])
def test_guidance_loss_and_gradient_match_jax(sdf, branch):
    jguide, tguide, F = guides(sdf, traj_only=branch.startswith("traj_only"),
                               abs_3d=branch != "ric_rel", use_mse_loss=branch.endswith("mse"),
                               stop_cond_from=300)
    # frames past the 120-frame cut are in the prediction and out of the loss
    pred = (0.7 * np.random.default_rng(11).standard_normal((B, 130, F))).astype(np.float32)
    for tm, gated_on in ((np.array([300, 5]), True), (np.array([299, 900]), False)):
        jloss, jgrad = jax.value_and_grad(jguide.loss_fn)(jnp.asarray(pred), jnp.asarray(tm))
        x = t(pred).requires_grad_(True)
        tloss = tguide.loss_fn(x, t(tm))
        (tgrad,) = torch.autograd.grad(tloss, x)
        assert_close(tloss.detach().numpy(), jloss, LOSS_TOL)
        assert_close(tgrad.numpy(), jgrad, LOSS_TOL)
        if gated_on:
            assert float(jloss) > 0 and np.abs(np.asarray(jgrad)).max() > 0
            assert not np.asarray(jgrad)[:, 120:].any()  # past the cut
        else:
            assert float(tloss.detach()) == 0.0 and not tgrad.any()


def test_mask_sum_counts_keyframes_past_the_cut():
    """The normaliser is the whole [B, T, 22, 3] mask's sum, as in JAX: a
    keyframe past the cut lowers the loss without adding an error term."""
    _, tguide, F = guides(False, traj_only=True)
    pred = t(np.random.default_rng(2).standard_normal((B, 130, F)).astype(np.float32))
    _, short, _ = guides(False, traj_only=True, n_frames=121)  # frame 125 dropped
    tm = t(np.array([10, 10]))
    ratio = float(tguide.loss_fn(pred, tm) / short.loss_fn(pred[:, :121], tm))
    assert abs(ratio - 8.0 / 10.0) < 1e-6  # 8 of 10 mask entries lie within the cut


# --------------------------------------------------------------------------- #
# the xz_only trajectory UNet
# --------------------------------------------------------------------------- #
def traj_unets(xz_only, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 4)).astype(np.float32)
    text = rng.standard_normal((B, 512)).astype(np.float32)
    jm = JaxUNet(**TRAJ, xz_only=xz_only)
    params = jm.init(jax.random.key(4), jnp.asarray(x), jnp.zeros((B,), jnp.int32),
                     {"text_embed": jnp.asarray(text)})
    tm = TorchUNet(**TRAJ, xz_only=xz_only, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm.requires_grad_(False), x, text


@pytest.mark.parametrize("xz_only", [True, False], ids=["xz_only", "four_features"])
def test_trajectory_unet_forward_matches_jax(xz_only):
    jm, params, tm, x, text = traj_unets(xz_only)
    steps = np.array([3, 870])
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(steps), {"text_embed": jnp.asarray(text)})
    got = tm(t(x), t(steps), {"text_embed": t(text)})
    assert got.shape == (B, T, 4)
    assert_close(got.numpy(), want, LOSS_TOL)
    if xz_only:
        assert tm.unet.down0_res1.block1.conv.weight.shape[1] == 2  # x and z in
        assert not got[..., 0].any() and not got[..., 3].any()  # rot and y out as zeros
        # a 2-feature input goes in as it is
        want2 = jm.apply(params, jnp.asarray(x[..., 1:3]), jnp.asarray(steps),
                         {"text_embed": jnp.asarray(text)})
        assert_close(tm(t(x[..., 1:3]), t(steps), {"text_embed": t(text)}).numpy(), want2,
                     LOSS_TOL)


def test_xz_only_flax_init_replay_equals_jax():
    jm, params, _, _, _ = traj_unets(True)
    tm = TorchUNet(**TRAJ, xz_only=True, device="cpu", seed=None)
    got = flax_params(tm, 4)
    want = {path: np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params["params"])[0]
            for path in [tuple(k.key for k in path)]}
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_allclose(got[path].numpy(), v, rtol=0, atol=1e-6, err_msg=str(path))


# --------------------------------------------------------------------------- #
# guided sampling
# --------------------------------------------------------------------------- #
def schedules(steps=8):
    betas = get_named_beta_schedule("cosine", 1000)
    use = range(0, 1000, 1000 // steps)
    return JaxSched.create(betas, use), DiffusionSchedule.create(betas, use)


def traj_denoisers(xz_only=True):
    jm, params, tm, _, text = traj_unets(xz_only, seed=1)
    jpipe = JaxPipeline(lambda x, tt, y, **kw: jm.apply(params, x, tt, y, **kw), None, None)
    tpipe = SamplePipeline(lambda x, tt, y, **kw: tm(x, tt, y), DiffusionSchedule.create(
        get_named_beta_schedule("cosine", 10)), DiffusionConfig(), device="cpu")
    return (jpipe.denoiser({"text_embed": jnp.asarray(text)}, 1.0),
            tpipe.denoiser({"text_embed": t(text)}, 1.0))


def stage_guides():
    jstats, tstats = stats_pair(4, 6)
    jt, jm = jgmd.kframes_to_target(KFRAMES, B, T)
    tt, tm = tgmd.kframes_to_target(KFRAMES, B, T, device="cpu")
    kw = dict(traj_only=True, motion_length_cut=T / 20.0)
    return jgmd.CondKeyLocations(jt, jm, jstats, **kw), tgmd.CondKeyLocations(tt, tm, tstats, **kw)


def test_one_guided_ddpm_step_matches_jax():
    """x_{t-1} of one guided step: the JAX scan body (ddpm_sample_loop's step)
    from its public functions, against the port's SamplerStep."""
    jsched, tsched = schedules()
    jden, tden = traj_denoisers()
    jguide, tguide = stage_guides()
    rng = np.random.default_rng(12)
    x, z = (rng.standard_normal((B, T, 4)).astype(np.float32) for _ in range(2))
    steps = np.array([5, 5])
    jt = jnp.asarray(steps)

    def neg_loss(xx):
        out = jg.p_mean_variance(jden, jsched, JaxDCfg(), xx, jt)
        return -jguide.loss_fn(out["pred_xstart"], jsched.model_t(jt)), out

    grad, out = jax.grad(neg_loss, has_aux=True)(jnp.asarray(x))
    want = (out["mean"] + out["variance"] * grad * SCALE
            + jnp.exp(0.5 * out["log_variance"]) * jnp.asarray(z))
    step = tsampling.SamplerStep("ddpm", tden, tsched, DiffusionConfig(),
                                 cond_loss_fn=tguide.loss_fn, cond_scale=SCALE)
    with torch.no_grad():
        got, pred_xstart = step(t(x), t(steps), t(z))
    assert np.abs(np.asarray(grad)).max() > 0
    assert_close(got.numpy(), want, LOSS_TOL)
    assert_close(pred_xstart.numpy(), out["pred_xstart"], LOSS_TOL)


def test_zero_noise_guided_trajectory_stage_matches_jax():
    jsched, tsched = schedules()
    jden, tden = traj_denoisers()
    jguide, tguide = stage_guides()
    xT = np.random.default_rng(13).standard_normal((B, T, 4)).astype(np.float32)
    want = jsampling.ddpm_sample_loop(
        jden, jsched, JaxDCfg(), (B, T, 4), jax.random.key(0), noise=jnp.asarray(xT),
        cond_loss_fn=jguide.loss_fn, cond_scale=SCALE,
        sampler=jsampling.SamplerConfig(zero_noise=True))
    unguided = jsampling.ddpm_sample_loop(
        jden, jsched, JaxDCfg(), (B, T, 4), jax.random.key(0), noise=jnp.asarray(xT),
        sampler=jsampling.SamplerConfig(zero_noise=True))
    got = tsampling.ddpm_sample_loop(
        tden, tsched, DiffusionConfig(), (B, T, 4), noise=t(xT),
        cond_loss_fn=tguide.loss_fn, cond_scale=SCALE, sampler=SamplerConfig(zero_noise=True))
    assert np.abs(np.asarray(want) - np.asarray(unguided)).max() > 0.1  # the guidance moved it
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_two_stage_generate_matches_jax():
    """Both stages, JAX's x_T injected: rng -> (r1, r2) as gmd.py splits it,
    each stage's x_T from the first split of its key, as ddpm_sample_loop
    draws it; zero noise on both pipelines."""
    jsched, tsched = schedules()
    rng = np.random.default_rng(14)
    text = rng.standard_normal((B, 512)).astype(np.float32)
    jtraj, jtparams, ttraj, _, _ = traj_unets(False, seed=2)
    x263 = rng.standard_normal((B, T, 263)).astype(np.float32)
    jmot = JaxUNet(**MOTION)
    jmparams = jmot.init(jax.random.key(5), jnp.asarray(x263), jnp.zeros((B,), jnp.int32),
                         {"text_embed": jnp.asarray(text)})
    tmot = TorchUNet(**MOTION, device="cpu", seed=None)
    tmot.load_state_dict(load_flax_params(jax.tree_util.tree_map(np.asarray, jmparams)))
    tmot.requires_grad_(False)
    jtstats, ttstats = stats_pair(263, 7)
    jmstats, tmstats = stats_pair(263, 8)

    zero = jsampling.SamplerConfig(zero_noise=True)
    jtp = JaxPipeline(lambda x, tt, y, **kw: jtraj.apply(jtparams, x, tt, y, **kw),
                      jsched, JaxDCfg(), zero)
    jmp = JaxPipeline(lambda x, tt, y, **kw: jmot.apply(jmparams, x, tt, y, **kw),
                      jsched, JaxDCfg(), zero)
    tzero = SamplerConfig(zero_noise=True)
    ttp = SamplePipeline(lambda x, tt, y, **kw: ttraj(x, tt, y), tsched, DiffusionConfig(),
                         tzero, device="cpu")
    tmp = SamplePipeline(lambda x, tt, y, **kw: tmot(x, tt, y), tsched, DiffusionConfig(),
                         tzero, device="cpu")
    key = jax.random.key(21)
    _, r1, r2 = jax.random.split(key, 3)
    traj_xT = np.asarray(jax.random.normal(jax.random.split(r1)[1], (B, T, 4)))
    motion_xT = np.asarray(jax.random.normal(jax.random.split(r2)[1], (B, T, 263)))

    kw = dict(classifier_scale=SCALE, obstacles=[(0.5, 1.0, 1.0)])
    jy = {"text_embed": jnp.asarray(text)}
    want_traj, want = jgmd.two_stage_generate(jtp, jmp, KFRAMES, key, B, T, jtstats, jmstats,
                                              jy, jy, **kw)
    ty = {"text_embed": t(text)}
    got_traj, got = tgmd.two_stage_generate(ttp, tmp, KFRAMES, B, T, ttstats, tmstats, ty, ty,
                                            traj_noise=t(traj_xT), motion_noise=t(motion_xT),
                                            **kw)
    np.testing.assert_allclose(got_traj.numpy(), np.asarray(want_traj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert np.abs(np.asarray(want)).max() > 0.1
