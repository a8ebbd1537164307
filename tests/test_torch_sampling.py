"""The port's samplers and pipeline against the JAX package's, on the CPU in
float32: whole DDPM (zero noise) and DDIM (eta 0) trajectories through a small
keyframe UNet with the same weights and the same x_T, and the UNet-XL check
against the committed golden trajectory (slow)."""

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
from condmdi_tpu.diffusion import sampling as jsampling
from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu.sampling.pipeline import SamplePipeline as JaxPipeline
from condmdi_tpu.sampling.pipeline import build_inpainting_state as jax_inpaint
from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule, SamplerConfig
from condmdi_tpu_torch.diffusion import sampling as tsampling
from condmdi_tpu_torch.models.unet import MDM_UNET as TorchUNet
from condmdi_tpu_torch.sampling.pipeline import SamplePipeline, build_inpainting_state
from condmdi_tpu_torch.weights import load_flax_params

REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-4  # float32 over a whole 8-step trajectory of the small UNet
B, T, F = 2, 24, 263
SMALL = dict(njoints=F, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
             pad_frames_to=T, zero=False)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(8)
    text = rng.standard_normal((B, 512)).astype(np.float32)
    obs = (0.5 * rng.standard_normal((B, T, F))).astype(np.float32)
    mask = np.zeros((B, T, F), bool)
    mask[:, ::5] = True
    xT = rng.standard_normal((B, T, F)).astype(np.float32)
    jm = JaxUNet(**SMALL)
    params = jm.init(jax.random.key(2), jnp.asarray(xT), jnp.zeros((B,), jnp.int32),
                     {"text_embed": jnp.asarray(text)}, obs_x0=jnp.asarray(obs),
                     obs_mask=jnp.asarray(mask))
    tm = TorchUNet(**SMALL, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(jax.tree_util.tree_map(np.asarray, params)))
    betas = get_named_beta_schedule("cosine", 1000)
    use = range(0, 1000, 125)  # 8 respaced steps
    return dict(
        jm=jm, params=params, tm=tm, text=text, obs=obs, mask=mask, xT=xT,
        jsched=JaxSched.create(betas, use), tsched=DiffusionSchedule.create(betas, use),
    )


def _pipelines(s, method):
    jpipe = JaxPipeline(lambda x, t, y, **kw: s["jm"].apply(s["params"], x, t, y, **kw),
                        s["jsched"], JaxDCfg(),
                        jsampling.SamplerConfig(method=method, zero_noise=True))
    tpipe = SamplePipeline(s["tm"], s["tsched"], DiffusionConfig(),
                           SamplerConfig(method=method, zero_noise=True), device="cpu")
    return jpipe, tpipe


@pytest.mark.parametrize("method", ["ddpm", "ddim"])
@pytest.mark.parametrize("guidance", [1.0, 2.5])
@pytest.mark.parametrize("imputate", [False, True])
def test_pipeline_trajectory_matches_jax(setup, method, guidance, imputate):
    """Keyframe conditioning, CFG and conditional imputation over a whole loop."""
    s = setup
    jpipe, tpipe = _pipelines(s, method)
    jinp = tinp = None
    if imputate:
        jinp = jax_inpaint(jnp.asarray(s["obs"]), jnp.asarray(s["mask"]), imputate=True,
                           stop_imputation_at=2, diffusion_steps=8)
        tinp = build_inpainting_state(torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"]),
                                      imputate=True, stop_imputation_at=2, diffusion_steps=8)
    want = np.asarray(jpipe.sample(
        jax.random.key(0), (B, T, F), {"text_embed": jnp.asarray(s["text"])},
        guidance_param=guidance, obs_x0=jnp.asarray(s["obs"]),
        obs_mask=jnp.asarray(s["mask"]), inpaint=jinp, noise=jnp.asarray(s["xT"])))
    got = tpipe.sample(
        (B, T, F), {"text_embed": torch.from_numpy(s["text"])}, guidance_param=guidance,
        obs_x0=torch.from_numpy(s["obs"]), obs_mask=torch.from_numpy(s["mask"]),
        inpaint=tinp, noise=torch.from_numpy(s["xT"])).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _denoisers(s):
    y_j = {"text_embed": jnp.asarray(s["text"])}
    y_t = {"text_embed": torch.from_numpy(s["text"])}
    kj = dict(obs_x0=jnp.asarray(s["obs"]), obs_mask=jnp.asarray(s["mask"]))
    kt = dict(obs_x0=torch.from_numpy(s["obs"]), obs_mask=torch.from_numpy(s["mask"]))
    return (lambda x, t: s["jm"].apply(s["params"], x, t, y_j, **kj),
            lambda x, t: s["tm"](x, t, y_t, **kt))


@pytest.mark.parametrize("extra", ["cond_fn", "skip_timesteps", "trajectory"])
def test_ddpm_options_match_jax(setup, extra):
    s = setup
    jden, tden = _denoisers(s)
    jkw, tkw = {}, {}
    sampler = dict(zero_noise=True)
    if extra == "cond_fn":
        jkw["cond_fn"] = lambda xs, t: xs * 0.9
        tkw["cond_fn"] = lambda xs, t: xs * 0.9
    elif extra == "skip_timesteps":
        jkw = dict(skip_timesteps=3, init_image=jnp.asarray(s["obs"]))
        tkw = dict(skip_timesteps=3, init_image=torch.from_numpy(s["obs"]))
    else:
        sampler["return_trajectory"] = True
    want = jsampling.ddpm_sample_loop(
        jden, s["jsched"], JaxDCfg(), (B, T, F), jax.random.key(0),
        noise=jnp.asarray(s["xT"]), sampler=jsampling.SamplerConfig(**sampler), **jkw)
    got = tsampling.ddpm_sample_loop(
        tden, s["tsched"], DiffusionConfig(), (B, T, F), noise=torch.from_numpy(s["xT"]),
        sampler=SamplerConfig(**sampler), **tkw)
    if extra == "trajectory":
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL, rtol=0)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_ddpm_cond_loss_guidance_matches_jax(setup):
    """Mean-shift guidance: the loss gradient flows through the denoiser."""
    s = setup
    jden, tden = _denoisers(s)
    target = s["obs"][:, :, :4]
    want = jsampling.ddpm_sample_loop(
        jden, s["jsched"], JaxDCfg(), (B, T, F), jax.random.key(0),
        noise=jnp.asarray(s["xT"]), sampler=jsampling.SamplerConfig(zero_noise=True),
        cond_loss_fn=lambda xs, t: jnp.sum((xs[..., :4] - jnp.asarray(target)) ** 2),
        cond_scale=0.5)
    got = tsampling.ddpm_sample_loop(
        tden, s["tsched"], DiffusionConfig(), (B, T, F), noise=torch.from_numpy(s["xT"]),
        sampler=SamplerConfig(zero_noise=True),
        cond_loss_fn=lambda xs, t: ((xs[..., :4] - torch.from_numpy(target)) ** 2).sum(),
        cond_scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_step_noise_is_the_noise_the_loop_uses(setup):
    """Injected per-step noise replaces the generator: zeros give the
    zero-noise trajectory, and given noise is reproduced exactly."""
    s = setup
    _, tden = _denoisers(s)
    shape, xT = (B, T, F), torch.from_numpy(s["xT"])
    zeros = [torch.zeros(shape)] * 8
    a = tsampling.ddpm_sample_loop(tden, s["tsched"], DiffusionConfig(), shape, noise=xT,
                                   step_noise=zeros)
    b = tsampling.ddpm_sample_loop(tden, s["tsched"], DiffusionConfig(), shape, noise=xT,
                                   sampler=SamplerConfig(zero_noise=True))
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(4)
    noise = [torch.randn(shape, generator=gen) for _ in range(8)]
    c = tsampling.ddim_sample_loop(tden, s["tsched"], DiffusionConfig(), shape, noise=xT,
                                   sampler=SamplerConfig(method="ddim", eta=1.0),
                                   step_noise=noise)
    d = tsampling.ddim_sample_loop(tden, s["tsched"], DiffusionConfig(), shape, noise=xT,
                                   sampler=SamplerConfig(method="ddim", eta=1.0),
                                   step_noise=noise)
    assert torch.equal(c, d) and not torch.equal(c, a)


def test_marginal_imputation_keeps_keyframes(setup):
    """'marginal' replacement writes the clean keyframes at the last step."""
    s = setup
    _, tden = _denoisers(s)
    inp = build_inpainting_state(torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"]),
                                 imputate=True, replacement_distribution="marginal",
                                 diffusion_steps=8)
    out = tsampling.ddpm_sample_loop(tden, s["tsched"], DiffusionConfig(), (B, T, F),
                                     generator=torch.Generator().manual_seed(0), inpaint=inp)
    m = torch.from_numpy(s["mask"])
    assert torch.equal(out[m], torch.from_numpy(s["obs"])[m])


@pytest.mark.slow
def test_xl_matches_committed_golden():
    """UNet-XL (pad 200): bench.py's JAX-initialised, perturbed weights through
    the bridge, f32 DDIM-20, B=2, against tests/golden/bench_traj_unet_pad200.json
    at bench.py's 5e-3 max-abs. Slow: the full-width model on the CPU."""
    sys.path.insert(0, str(REPO))
    import bench

    golden = np.asarray(json.loads(
        (REPO / "tests" / "golden" / "bench_traj_unet_pad200.json").read_text())["slice"])
    Bx, Tx, Fx = 2, bench.T, bench.F
    model, params, y, obs_x0, obs_mask, _ = bench.build_bench_model("unet", Bx)
    # bench.verify_trajectory's perturbation, leaf for leaf
    leaves, treedef = jax.tree_util.tree_flatten(params["params"])
    prng = np.random.default_rng(11)
    leaves = [np.asarray(leaf) + 0.02 * prng.standard_normal(leaf.shape).astype(np.float32)
              for leaf in leaves]
    tree = jax.tree_util.tree_unflatten(treedef, leaves)
    tm = TorchUNet(njoints=Fx, latent_dim=512, dim_mults=(2, 2, 2, 2),
                   keyframe_conditioned=True, pad_frames_to=200, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params({"params": tree}))
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 1000),
                                     use_timesteps=range(0, 1000, 50))
    noise = np.random.default_rng(7).standard_normal((Bx, Tx, Fx)).astype(np.float32)
    pipe = SamplePipeline(tm, sched, DiffusionConfig(), SamplerConfig(method="ddim"),
                          device="cpu")
    out = pipe.sample((Bx, Tx, Fx), {"text_embed": torch.from_numpy(np.asarray(y["text_embed"]))},
                      obs_x0=torch.from_numpy(np.asarray(obs_x0)),
                      obs_mask=torch.from_numpy(np.asarray(obs_mask)),
                      noise=torch.from_numpy(noise)).numpy()
    got = out[:, ::7, ::13].astype(np.float64)
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= 5e-3
