"""The port's PLMS sampler and DDIM reverse ODE against the JAX package's, on
the CPU in float32, through a small keyframe UNet with the same weights:

  * PLMS of orders 1-4 over 8 respaced steps from the same x_T, through the
    loop and through SamplePipeline (CFG, keyframes, conditional
    imputation), within ATOL (tests/test_torch_sampling.py's);
  * the DDIM reverse ODE x_0 -> x_T over the same steps within
    ATOL * (1 + |ref|);
  * PLMS's multistep body over its static buffers (the eps history kept in
    `PLMSBuffers`, as a CUDA graph replays it; here the body runs as it is)
    against the eager loop, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.diffusion import DiffusionConfig as JaxDCfg
from condmdi_tpu.diffusion import DiffusionSchedule as JaxSched
from condmdi_tpu.diffusion import get_named_beta_schedule
from condmdi_tpu.diffusion import sampling as jsampling
from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu.sampling.pipeline import SamplePipeline as JaxPipeline
from condmdi_tpu.sampling.pipeline import build_inpainting_state as jax_inpaint
from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule, SamplerConfig
from condmdi_tpu_torch.diffusion import sampling as tsampling
from condmdi_tpu_torch.models.unet import MDM_UNET as TorchUNet
from condmdi_tpu_torch.sampling.pipeline import (
    SamplePipeline,
    SamplingProgram,
    build_inpainting_state,
)
from condmdi_tpu_torch.weights import load_flax_params
from torch_eval_helpers import few_torch_threads  # noqa: F401  (module fixture)

ATOL = 2e-4  # float32 over a whole 8-step trajectory of the small UNet
B, T, F = 2, 24, 263
SMALL = dict(njoints=F, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
             pad_frames_to=T, zero=False)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(31)
    text = rng.standard_normal((B, 512)).astype(np.float32)
    obs = (0.5 * rng.standard_normal((B, T, F))).astype(np.float32)
    mask = np.zeros((B, T, F), bool)
    mask[:, ::5] = True
    xT = rng.standard_normal((B, T, F)).astype(np.float32)
    jm = JaxUNet(**SMALL)
    params = jm.init(jax.random.key(3), jnp.asarray(xT), jnp.zeros((B,), jnp.int32),
                     {"text_embed": jnp.asarray(text)}, obs_x0=jnp.asarray(obs),
                     obs_mask=jnp.asarray(mask))
    tm = TorchUNet(**SMALL, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(jax.tree_util.tree_map(np.asarray, params)))
    tm.requires_grad_(False)
    betas = get_named_beta_schedule("cosine", 1000)
    use = range(0, 1000, 125)  # 8 respaced steps
    return dict(jm=jm, params=params, tm=tm, text=text, obs=obs, mask=mask, xT=xT,
                jsched=JaxSched.create(betas, use), tsched=DiffusionSchedule.create(betas, use))


def denoisers(s):
    y_j, y_t = {"text_embed": jnp.asarray(s["text"])}, {"text_embed": torch.from_numpy(s["text"])}
    kj = dict(obs_x0=jnp.asarray(s["obs"]), obs_mask=jnp.asarray(s["mask"]))
    kt = dict(obs_x0=torch.from_numpy(s["obs"]), obs_mask=torch.from_numpy(s["mask"]))
    return (lambda x, t: s["jm"].apply(s["params"], x, t, y_j, **kj),
            lambda x, t: s["tm"](x, t, y_t, **kt))


def assert_matches(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_plms_loop_matches_jax(setup, order):
    s = setup
    jden, tden = denoisers(s)
    want = jsampling.plms_sample_loop(
        jden, s["jsched"], JaxDCfg(), (B, T, F), jax.random.key(0), noise=jnp.asarray(s["xT"]),
        sampler=jsampling.SamplerConfig(method="plms", order=order))
    got = tsampling.plms_sample_loop(
        tden, s["tsched"], DiffusionConfig(), (B, T, F), noise=torch.from_numpy(s["xT"]),
        sampler=SamplerConfig(method="plms", order=order))
    assert_matches(got, want)


@pytest.mark.parametrize("order", [2, 4])
def test_plms_pipeline_with_cfg_and_imputation_matches_jax(setup, order):
    s = setup
    jpipe = JaxPipeline(lambda x, t, y, **kw: s["jm"].apply(s["params"], x, t, y, **kw),
                        s["jsched"], JaxDCfg(), jsampling.SamplerConfig(method="plms", order=order))
    tpipe = SamplePipeline(s["tm"], s["tsched"], DiffusionConfig(),
                           SamplerConfig(method="plms", order=order), device="cpu")
    jinp = jax_inpaint(jnp.asarray(s["obs"]), jnp.asarray(s["mask"]), imputate=True,
                       stop_imputation_at=2, diffusion_steps=8)
    tinp = build_inpainting_state(torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"]),
                                  imputate=True, stop_imputation_at=2, diffusion_steps=8)
    want = jpipe.sample(jax.random.key(0), (B, T, F), {"text_embed": jnp.asarray(s["text"])},
                        guidance_param=2.5, obs_x0=jnp.asarray(s["obs"]),
                        obs_mask=jnp.asarray(s["mask"]), inpaint=jinp,
                        noise=jnp.asarray(s["xT"]))
    got = tpipe.sample((B, T, F), {"text_embed": torch.from_numpy(s["text"])},
                       guidance_param=2.5, obs_x0=torch.from_numpy(s["obs"]),
                       obs_mask=torch.from_numpy(s["mask"]), inpaint=tinp,
                       noise=torch.from_numpy(s["xT"]))
    assert_matches(got, want)


def test_ddim_reverse_loop_matches_jax(setup):
    """Held within ATOL * (1 + |ref|): on this random model x_T reaches
    |x| ~ 300 (each step divides by sqrt(1 - alpha_bar)), where one float32
    ulp is 3e-5 and the two frameworks' roundings add up to ~4e-4."""
    s = setup
    jden, tden = denoisers(s)
    x0 = 0.5 * s["xT"]
    want = np.asarray(jsampling.ddim_reverse_sample_loop(jden, s["jsched"], JaxDCfg(),
                                                         jnp.asarray(x0)))
    got = tsampling.ddim_reverse_sample_loop(tden, s["tsched"], DiffusionConfig(),
                                             torch.from_numpy(x0)).numpy()
    assert np.isfinite(got).all() and np.abs(got - x0).max() > 0.1  # it moved
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_plms_body_on_static_buffers_equals_the_eager_loop(setup, order):
    s = setup
    pipe = SamplePipeline(s["tm"], s["tsched"], DiffusionConfig(),
                          SamplerConfig(method="plms", order=order), device="cpu")
    args = ((B, T, F), {"text_embed": torch.from_numpy(s["text"])}, 2.5,
            torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"]), None)
    buffered = SamplingProgram(pipe, *args, buffered=True)
    eager = SamplingProgram(pipe, *args, buffered=False)
    assert buffered.buffered and not eager.buffered
    noise = torch.from_numpy(s["xT"])
    got = buffered.run(noise=noise)
    assert buffered.buffers.hist.shape == (order, B, T, F)
    want = eager.run(noise=noise)
    assert torch.equal(got, want)
    assert torch.equal(got, tsampling.plms_sample_loop(
        eager.denoise, s["tsched"], DiffusionConfig(), (B, T, F), noise=noise,
        sampler=SamplerConfig(method="plms", order=order)))


def test_guidance_and_order_are_refused_where_jax_refuses_them(setup):
    s = setup
    pipe = SamplePipeline(s["tm"], s["tsched"], DiffusionConfig(),
                          SamplerConfig(method="plms"), device="cpu")
    with pytest.raises(ValueError, match="ddpm"):
        pipe.sample((B, T, F), {"text_embed": torch.from_numpy(s["text"])},
                    obs_x0=torch.from_numpy(s["obs"]), obs_mask=torch.from_numpy(s["mask"]),
                    cond_loss_fn=lambda xs, t: xs.sum())
    with pytest.raises(ValueError, match="order"):
        tsampling.PLMSStep(lambda x, t: x, s["tsched"], DiffusionConfig(),
                           SamplerConfig(method="plms", order=5))
