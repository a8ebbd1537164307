"""The port's diffusion math (condmdi_tpu_torch/diffusion) against the JAX
package's, on the CPU in float32: schedules and respacing, the closed-form q
and posterior terms, and p_mean_variance in its three branches (plain,
conditional imputation, reconstruction guidance through a small UNet with
the same converted weights)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.diffusion import gaussian as jg
from condmdi_tpu.diffusion import schedule as js
from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu_torch.diffusion import gaussian as tg
from condmdi_tpu_torch.diffusion import schedule as ts
from condmdi_tpu_torch.models.unet import MDM_UNET as TorchUNet
from condmdi_tpu_torch.weights import load_flax_params

SCHED_ATOL = 1e-6  # both sides compute in float64 numpy and store float32
ATOL = 1e-5        # float32 elementwise math
UNET_ATOL = 1e-4   # through the small UNet (conv sums in another order)

B, T, F = 2, 24, 263
SMALL = dict(njoints=F, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
             pad_frames_to=T, zero=False)

SCHEDULES = [
    ("cosine", 1000, None),
    ("linear", 1000, None),
    ("cosine", 1000, "ddim20"),
    ("cosine", 1000, "10,5,3"),
    ("linear", 100, "ddim10"),
]


def schedules(name, steps, respace, rescale=False):
    betas = js.get_named_beta_schedule(name, steps)
    np.testing.assert_array_equal(betas, ts.get_named_beta_schedule(name, steps))
    use = None
    if respace is not None:
        use = js.space_timesteps(steps, respace)
        assert ts.space_timesteps(steps, respace) == use
    return (js.DiffusionSchedule.create(betas, use, rescale_timesteps=rescale),
            ts.DiffusionSchedule.create(betas, use, rescale_timesteps=rescale))


@pytest.mark.parametrize("name,steps,respace", SCHEDULES)
def test_schedule_arrays_match(name, steps, respace):
    jsched, tsched = schedules(name, steps, respace)
    assert tsched.num_timesteps == jsched.num_timesteps
    assert tsched.original_num_steps == jsched.original_num_steps
    for field in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
                  "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                  "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                  "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                  "posterior_log_variance_clipped", "posterior_mean_coef1",
                  "posterior_mean_coef2", "fixed_large_variance", "fixed_large_log_variance",
                  "log_betas", "ratio_eps", "snr_weight"):
        want = np.asarray(getattr(jsched, field))
        got = getattr(tsched, field).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=SCHED_ATOL, rtol=1e-6, err_msg=field)
    np.testing.assert_array_equal(tsched.timestep_map.numpy(), np.asarray(jsched.timestep_map))


@pytest.mark.parametrize("rescale", [False, True])
def test_model_t_matches(rescale):
    jsched, tsched = schedules("cosine", 1000, "ddim20", rescale)
    t = np.array([0, 7, 19])
    np.testing.assert_allclose(tsched.model_t(torch.from_numpy(t)).numpy(),
                               np.asarray(jsched.model_t(jnp.asarray(t))), rtol=1e-6)


def test_space_timesteps_rejects_impossible_counts():
    with pytest.raises(ValueError):
        ts.space_timesteps(10, "ddim7")
    with pytest.raises(ValueError):
        ts.space_timesteps(10, [11])


@pytest.mark.parametrize("name", ["none", "first-half", "last-half", "exponential",
                                  "sigmoid", "half-sigmoid"])
def test_gradient_schedule_matches(name):
    np.testing.assert_array_equal(tg.get_gradient_schedule(name, 50),
                                  jg.get_gradient_schedule(name, 50))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, T, F)).astype(np.float32)
    xt = rng.standard_normal((B, T, F)).astype(np.float32)
    eps = rng.standard_normal((B, T, F)).astype(np.float32)
    t = np.array([3, 17])
    return x0, xt, eps, t


def test_q_and_posterior_and_predictions_match():
    jsched, tsched = schedules("cosine", 1000, "ddim20")
    x0, xt, eps, t = _data()
    j = lambda a: jnp.asarray(a)  # noqa: E731
    tt = lambda a: torch.from_numpy(a)  # noqa: E731
    pairs = [
        (jg.q_sample(jsched, j(x0), j(t), j(eps)), tg.q_sample(tsched, tt(x0), tt(t), tt(eps))),
        (jg.predict_xstart_from_eps(jsched, j(xt), j(t), j(eps)),
         tg.predict_xstart_from_eps(tsched, tt(xt), tt(t), tt(eps))),
        (jg.predict_xstart_from_xprev(jsched, j(xt), j(t), j(eps)),
         tg.predict_xstart_from_xprev(tsched, tt(xt), tt(t), tt(eps))),
        (jg.predict_eps_from_xstart(jsched, j(xt), j(t), j(x0)),
         tg.predict_eps_from_xstart(tsched, tt(xt), tt(t), tt(x0))),
    ]
    pairs += list(zip(jg.q_posterior_mean_variance(jsched, j(x0), j(xt), j(t)),
                      tg.q_posterior_mean_variance(tsched, tt(x0), tt(xt), tt(t))))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)


def _toy_denoiser(framework, learned):
    """A smooth deterministic denoiser; doubles its channels for LEARNED vars."""
    def fn(x, t):
        if framework == "jax":
            base = jnp.tanh(x) * 0.5 + (t.astype(jnp.float32) / 1000.0)[:, None, None]
            return jnp.concatenate([base, jnp.sin(x) * 0.3], -1) if learned else base
        base = torch.tanh(x) * 0.5 + (t.float() / 1000.0)[:, None, None]
        return torch.cat([base, torch.sin(x) * 0.3], -1) if learned else base
    return fn


@pytest.mark.parametrize("mean_type", ["start_x", "eps", "prev_x"])
@pytest.mark.parametrize("var_type", ["fixed_small", "fixed_large", "learned", "learned_range"])
def test_p_mean_variance_plain_branch(mean_type, var_type):
    jsched, tsched = schedules("linear", 100, "ddim10")
    x0, xt, _, t = _data(1)
    t = np.array([0, 6])
    learned = var_type.startswith("learned")
    jcfg = jg.DiffusionConfig(model_mean_type=jg.ModelMeanType(mean_type),
                              model_var_type=jg.ModelVarType(var_type), clip_range=1.5)
    tcfg = tg.DiffusionConfig(model_mean_type=tg.ModelMeanType(mean_type),
                              model_var_type=tg.ModelVarType(var_type), clip_range=1.5)
    want = jg.p_mean_variance(_toy_denoiser("jax", learned), jsched, jcfg,
                              jnp.asarray(xt), jnp.asarray(t))
    got = tg.p_mean_variance(_toy_denoiser("torch", learned), tsched, tcfg,
                             torch.from_numpy(xt), torch.from_numpy(t))
    for key in ("mean", "variance", "log_variance", "pred_xstart", "model_output"):
        w = np.broadcast_to(np.asarray(want[key]), got[key].shape)
        np.testing.assert_allclose(got[key].numpy(), w, atol=ATOL, rtol=1e-4, err_msg=key)


@pytest.fixture(scope="module")
def small_unet():
    """The small keyframe UNet in both frameworks, with the same weights."""
    rng = np.random.default_rng(5)
    text = rng.standard_normal((B, 512)).astype(np.float32)
    obs = rng.standard_normal((B, T, F)).astype(np.float32)
    mask = np.zeros((B, T, F), bool)
    mask[:, ::5] = True
    jm = JaxUNet(**SMALL)
    params = jm.init(jax.random.key(0), jnp.asarray(obs), jnp.zeros((B,), jnp.int32),
                     {"text_embed": jnp.asarray(text)}, obs_x0=jnp.asarray(obs),
                     obs_mask=jnp.asarray(mask))
    tm = TorchUNet(**SMALL, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(jax.tree_util.tree_map(np.asarray, params)))

    def jax_fn(x, t):
        return jm.apply(params, x, t, {"text_embed": jnp.asarray(text)},
                        obs_x0=jnp.asarray(obs), obs_mask=jnp.asarray(mask))

    def torch_fn(x, t):
        return tm(x, t, {"text_embed": torch.from_numpy(text)},
                  obs_x0=torch.from_numpy(obs), obs_mask=torch.from_numpy(mask))

    return jax_fn, torch_fn, obs, mask


def _inpaint_states(imputate, recg, obs, mask, steps, stop_imp=0, stop_recg=0):
    grad_ws = (jg.get_gradient_schedule("exponential", steps) * 5.0).astype(np.float32)
    jstate = jg.InpaintingState(
        inpainted_motion=jnp.asarray(obs), inpainting_mask=jnp.asarray(mask),
        grad_weights=jnp.asarray(grad_ws), stop_imputation_at=jnp.int32(stop_imp),
        stop_recguidance_at=jnp.int32(stop_recg), imputate=imputate,
        reconstruction_guidance=recg)
    tstate = tg.InpaintingState(
        inpainted_motion=torch.from_numpy(obs), inpainting_mask=torch.from_numpy(mask),
        grad_weights=torch.from_numpy(grad_ws), stop_imputation_at=stop_imp,
        stop_recguidance_at=stop_recg, imputate=imputate, reconstruction_guidance=recg)
    return jstate, tstate


@pytest.mark.parametrize("imputate,recg,stops", [
    (True, False, (0, 0)),     # conditional imputation
    (True, False, (5, 0)),     # imputation gated off for t < 5
    (False, True, (0, 0)),     # reconstruction guidance alone
    (True, True, (0, 3)),      # both, guidance gated off for t < 3
])
def test_p_mean_variance_guided_branches_through_unet(small_unet, imputate, recg, stops):
    jax_fn, torch_fn, obs, mask = small_unet
    jsched, tsched = schedules("cosine", 1000, "ddim10")
    _, xt, _, _ = _data(2)
    t = np.array([1, 8])
    jstate, tstate = _inpaint_states(imputate, recg, obs, mask, 10, *stops)
    want = jg.p_mean_variance(jax_fn, jsched, jg.DiffusionConfig(), jnp.asarray(xt),
                              jnp.asarray(t), inpaint=jstate)
    got = tg.p_mean_variance(torch_fn, tsched, tg.DiffusionConfig(), torch.from_numpy(xt),
                             torch.from_numpy(t), inpaint=tstate)
    for key in ("mean", "pred_xstart", "model_output"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   atol=UNET_ATOL, rtol=0, err_msg=key)


def test_schedule_tables_are_made_on_the_host_and_moved_by_the_pipeline():
    """`DiffusionSchedule.create` builds constants: it defaults to the CPU, takes
    a device, and `SamplePipeline` moves whatever it is given to its own device
    (the package's other entry points default to CUDA)."""
    from condmdi_tpu_torch.diffusion import DiffusionConfig
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    betas = ts.get_named_beta_schedule("cosine", 20)
    sched = ts.DiffusionSchedule.create(betas)
    assert sched.betas.device.type == "cpu" and sched.timestep_map.device.type == "cpu"
    assert "host" in ts.DiffusionSchedule.create.__doc__
    assert ts.DiffusionSchedule.create(betas, device="meta").betas.device.type == "meta"
    pipe = SamplePipeline(lambda x, t, y, **kw: x, sched, DiffusionConfig(), device="cpu")
    assert pipe.sched.betas.device.type == "cpu"
    if torch.cuda.is_available():  # the default device is the card
        assert SamplePipeline(lambda x, t, y, **kw: x, sched,
                              DiffusionConfig()).sched.betas.device.type == "cuda"
    else:  # no card: the default device refuses
        with pytest.raises(RuntimeError, match="CUDA"):
            SamplePipeline(lambda x, t, y, **kw: x, sched, DiffusionConfig())
