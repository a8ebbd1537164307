"""The port's transformer denoisers against the JAX package's, on the CPU in
float32: MDM (`trans_enc`, `trans_dec` with and without `emb_trans_dec`; cond
modes text, action and no_cond; the `uncond` mask as a bool and as rows),
MDM_DiT in every arch key, `*_scale` and `two_head`, CFG over MDM, whole
DDPM/DDIM trajectories through SamplePipeline with imputation and
reconstruction guidance, and the full-width bench MDM against the committed
CPU golden trajectory. Weights go through weights.load_flax_params."""

import json
import sys
import time
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
from condmdi_tpu.models.cfg import make_cfg_denoiser as jax_cfg
from condmdi_tpu.models.dit import MDM_DiT as JaxDiT
from condmdi_tpu.models.mdm import MDM as JaxMDM
from condmdi_tpu.sampling.pipeline import SamplePipeline as JaxPipeline
from condmdi_tpu.sampling.pipeline import build_inpainting_state as jax_inpaint
from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule, SamplerConfig
from condmdi_tpu_torch.models.cfg import make_cfg_denoiser as torch_cfg
from condmdi_tpu_torch.models.dit import MDM_DiT as TorchDiT
from condmdi_tpu_torch.models.dit import _dispatch
from condmdi_tpu_torch.models.mdm import MDM as TorchMDM
from condmdi_tpu_torch.models.mdm import cal_multiple
from condmdi_tpu_torch.sampling.pipeline import SamplePipeline, build_inpainting_state
from condmdi_tpu_torch.weights import load_flax_params

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4  # float32 through every layer; sums run in another order
TRAJ_ATOL = 2e-4  # float32 over a whole 8-step trajectory
F, NUM_ACTIONS = 263, 5
SMALL = dict(njoints=F, latent_dim=32, ff_size=64, num_layers=2, num_heads=4)


def inputs(B, T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    text = rng.standard_normal((B, 512)).astype(np.float32)
    action = rng.integers(0, NUM_ACTIONS, (B, 1))
    t = rng.integers(0, 1000, (B,))
    return x, text, action, t


def pair(jax_cls, torch_cls, config, B=3, T=20, seed=0):
    """(JAX model, perturbed params, torch model with the converted tree)."""
    x, text, action, t = inputs(B, T, seed)
    jm = jax_cls(**config)
    y = {"text_embed": jnp.asarray(text), "action": jnp.asarray(action)}
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(t), y))
    rng = np.random.default_rng(seed + 100)  # so zero-initialised layers carry signal too
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.05 * rng.standard_normal(p.shape)).astype(np.float32), params)
    tm = torch_cls(**config, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(params))
    return jm, params, tm


def run_both(jm, params, tm, x, t, y):
    conv = lambda f: {k: f(v) if isinstance(v, np.ndarray) else v for k, v in y.items()}  # noqa: E731
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(t), conv(jnp.asarray))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), conv(torch.from_numpy))
    if isinstance(want, tuple):
        return [g.numpy() for g in got], [np.asarray(w) for w in want]
    return [got.numpy()], [np.asarray(want)]


def make_y(cond_mode, uncond, text, action, B):
    y = {}
    if "text" in cond_mode:
        y["text_embed"] = text
    if "action" in cond_mode:
        y["action"] = action
    if uncond == "all":
        y["uncond"] = True
    elif uncond == "rows":
        y["uncond"] = np.arange(B) % 2 == 1
    return y


MDM_ARCHS = [
    ("trans_enc", False),
    ("trans_dec", False),
    ("trans_dec", True),
]


@pytest.mark.parametrize("arch,emb_trans_dec", MDM_ARCHS,
                         ids=["trans_enc", "trans_dec", "trans_dec_emb"])
@pytest.mark.parametrize("cond_mode,uncond", [
    ("text", "none"), ("text", "all"), ("text", "rows"),
    ("action", "none"), ("action", "rows"), ("no_cond", "none"),
])
def test_mdm_matches_jax(arch, emb_trans_dec, cond_mode, uncond):
    config = dict(SMALL, arch=arch, emb_trans_dec=emb_trans_dec, cond_mode=cond_mode,
                  num_actions=NUM_ACTIONS)
    jm, params, tm = pair(JaxMDM, TorchMDM, config)
    B, T = 3, 17
    x, text, action, t = inputs(B, T, seed=1)
    got, want = run_both(jm, params, tm, x, t, make_y(cond_mode, uncond, text, action, B))
    assert got[0].shape == (B, T, F) and np.abs(want[0]).max() > 0
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)


def test_mdm_bridge_covers_every_parameter():
    config = dict(SMALL, arch="trans_dec", emb_trans_dec=True, cond_mode="text_action",
                  num_actions=NUM_ACTIONS)
    _, params, tm = pair(JaxMDM, TorchMDM, config)
    sd = load_flax_params(params)
    assert set(sd) == set(tm.state_dict())
    p = params["params"]
    np.testing.assert_array_equal(sd["layer0.norm1.weight"].numpy(), p["layer0"]["norm1"]["scale"])
    np.testing.assert_array_equal(sd["embed_action.action_embedding"].numpy(),
                                  p["embed_action"]["action_embedding"])
    np.testing.assert_array_equal(sd["layer1.kv_proj.weight"].numpy(),
                                  p["layer1"]["kv_proj"]["kernel"].T)


@pytest.mark.parametrize("arch,two_head", [
    ("dit_prenorm", False), ("dit_postnorm", False), ("dit_concat", False),
    ("dit_concatv2", False), ("dit_concatv3", False), ("dit_concatv2_scale", False),
    ("dit_prenorm_scale", False), ("dit", False), ("dit_concat", True),
])
def test_dit_matches_jax(arch, two_head):
    config = dict(SMALL, arch=arch, two_head=two_head)
    jm, params, tm = pair(JaxDiT, TorchDiT, config)
    assert set(load_flax_params(params)) == set(tm.state_dict())
    B, T = 3, 16
    x, text, action, t = inputs(B, T, seed=2)
    got, want = run_both(jm, params, tm, x, t, make_y("text", "rows", text, action, B))
    assert len(got) == (2 if two_head else 1)
    for g, w in zip(got, want):
        assert g.shape == (B, T, F) and np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_dit_dispatch_is_the_longest_prefix():
    assert [_dispatch(a)[0] for a in ("dit_concatv2_scale", "dit_concat", "dit", "dit_postnorm")] \
        == ["dit_concatv2", "dit_concat", "dit_prenorm", "dit_postnorm"]
    assert cal_multiple(512, 263) == 526 and cal_multiple(526, 263) == 526


@pytest.mark.parametrize("kw,match", [
    (dict(arch="gru"), "GRU"),
    (dict(arch="trans_enc_large"), "_large"),
    (dict(precision_mode="int8_static"), "int8"),
])
def test_mdm_parts_left_for_later_slices_raise(kw, match):
    """`gru` and `*_large`, once left for a later slice, are built now: the model
    holds the part named by `match` (the GRU cells, the large output head; their
    parity with JAX is in tests/test_torch_model_variants.py). A QDense precision
    mode other than float and int8, which the JAX QDense does not have, is still
    refused with a ValueError (int8 itself runs: tests/test_torch_quant.py)."""
    if "precision_mode" in kw:
        with pytest.raises(ValueError, match=match):
            TorchMDM(**{**SMALL, **kw}, device="cpu")
        return
    model = TorchMDM(**{**SMALL, **kw}, device="cpu")
    assert any(match.lower() in name.lower() for name, _ in model.named_modules())
    with torch.no_grad():
        out = model(torch.zeros(2, 6, F), torch.zeros(2, dtype=torch.long), {})
    assert out.shape == (2, 6, F) and torch.isfinite(out).all()


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_cfg_over_mdm_matches_jax(scale):
    jm, params, tm = pair(JaxMDM, TorchMDM, dict(SMALL))
    x, text, _, t = inputs(2, 15, seed=6)
    jden = jax_cfg(lambda x_, t_, y_: jm.apply(params, x_, t_, y_),
                   {"text_embed": jnp.asarray(text)}, scale)
    tden = torch_cfg(tm, {"text_embed": torch.from_numpy(text)}, scale)
    want = np.asarray(jden(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tden(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL * scale, rtol=0)


# --------------------------------------------------------------------------- #
# whole trajectories: MDM takes no obs_x0/obs_mask, so keyframes enter through
# the sampler's InpaintingState, as condmdi_tpu/sampling/edit.py drives it
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def traj_setup():
    B, T = 2, 20
    jm, params, tm = pair(JaxMDM, TorchMDM, dict(SMALL), B=B, T=T, seed=3)
    rng = np.random.default_rng(9)
    obs = (0.5 * rng.standard_normal((B, T, F))).astype(np.float32)
    mask = np.zeros((B, T, F), bool)
    mask[:, ::5] = True
    betas = get_named_beta_schedule("cosine", 1000)
    use = range(0, 1000, 125)  # 8 respaced steps
    return dict(B=B, T=T, jm=jm, params=params, tm=tm, obs=obs, mask=mask,
                text=rng.standard_normal((B, 512)).astype(np.float32),
                xT=rng.standard_normal((B, T, F)).astype(np.float32),
                jsched=JaxSched.create(betas, use), tsched=DiffusionSchedule.create(betas, use))


@pytest.mark.parametrize("method,guidance,mode", [
    ("ddpm", 2.5, "none"), ("ddim", 2.5, "none"),
    ("ddpm", 1.0, "imputate"), ("ddim", 2.5, "imputate"),
    ("ddpm", 1.0, "recguidance"),
])
def test_pipeline_trajectory_over_mdm_matches_jax(traj_setup, method, guidance, mode):
    s = traj_setup
    shape = (s["B"], s["T"], F)
    jpipe = JaxPipeline(lambda x, t, y, **_: s["jm"].apply(s["params"], x, t, y),
                        s["jsched"], JaxDCfg(),
                        jsampling.SamplerConfig(method=method, zero_noise=True))
    tpipe = SamplePipeline(lambda x, t, y, **_: s["tm"](x, t, y), s["tsched"], DiffusionConfig(),
                           SamplerConfig(method=method, zero_noise=True), device="cpu")
    jinp = tinp = None
    if mode != "none":
        kw = dict(imputate=True, stop_imputation_at=2, diffusion_steps=8)
        if mode == "recguidance":
            # at the CLI default weight 5 this random model's guided trajectory is
            # chaotic (|x0| grows past 40) and amplifies float32 rounding in both
            # frameworks alike; at 0.1 it stays well conditioned
            kw.update(reconstruction_guidance=True, reconstruction_weight=0.1)
        jinp = jax_inpaint(jnp.asarray(s["obs"]), jnp.asarray(s["mask"]), **kw)
        tinp = build_inpainting_state(torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"]),
                                      **kw)
    want = np.asarray(jpipe.sample(jax.random.key(0), shape, {"text_embed": jnp.asarray(s["text"])},
                                   guidance_param=guidance, inpaint=jinp,
                                   noise=jnp.asarray(s["xT"])))
    got = tpipe.sample(shape, {"text_embed": torch.from_numpy(s["text"])},
                       guidance_param=guidance, inpaint=tinp,
                       noise=torch.from_numpy(s["xT"])).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=TRAJ_ATOL, rtol=0)


def test_dit_xl_builds_at_the_published_widths():
    """DiT-XL/2 (facebookresearch/DiT `DiT_XL_2`: depth 28, hidden 1152, 16 heads,
    MLP ratio 4) through the port's entry points, the motion_mdm card with arch
    dit_prenorm, on the meta device: 675,855,623 parameters, 225,803,520 of them
    in the adaLN modulation Denses, every self-attention at head width 72."""
    import dataclasses

    from condmdi_tpu_torch.models.dit import _Attn
    from condmdi_tpu_torch.models.factory import create_model
    from condmdi_tpu_torch.utils.config import CARDS

    args = dataclasses.replace(CARDS["motion_mdm"](), arch="dit_prenorm", latent_dim=1152,
                               layers=28, ff_size=4608, num_heads=16)
    model = create_model(args, "meta")
    params = dict(model.named_parameters())
    assert isinstance(model, TorchDiT) and model.num_layers == 28
    assert sum(p.numel() for p in params.values()) == 675_855_623
    assert sum(p.numel() for n, p in params.items() if ".adaln." in n) == 225_803_520
    attns = [m for m in model.modules() if isinstance(m, _Attn)]
    assert len(attns) == 28
    assert all(a.num_heads == 16 and a.qkv.weight.shape == (3 * 1152, 1152) for a in attns)
    assert params["block27.mlp.fc1.weight"].shape == (4608, 1152)


def test_dit_samples_in_bf16_through_the_pipeline():
    """A dit_prenorm cast to bfloat16 by cast_weights and sampled by SamplePipeline
    under CFG 2.5 (one forward of the doubled batch a step, its conditioning in the
    program's buffers), as the offline benchmark runs DiT-XL: within 3e-2 relative
    rms of the float32 model's 8-step DDPM run from the same noise, the size of
    bfloat16's rounding (2^-8 a value) grown over two blocks and eight steps; the
    two types' runs differ (the cast took effect)."""
    from condmdi_tpu_torch.models.unet import cast_weights

    B, T = 2, 20
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = TorchDiT(**dict(SMALL, num_heads=3, latent_dim=48, ff_size=96), device="cpu",
                         seed=None)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                scale = p.shape[1] ** -0.5 if p.ndim == 2 else 0.02  # LeCun; small biases
                p.copy_(torch.randn(p.shape, generator=gen) * scale)
        model.eval()
        if dtype != torch.float32:
            cast_weights(model, dtype)
        pipe = SamplePipeline(lambda x, t, y, _m=model, _d=dtype, **_: _m(x.to(_d), t, y).float(),
                              DiffusionSchedule.create(get_named_beta_schedule("cosine", 8)),
                              DiffusionConfig(), SamplerConfig(method="ddpm"), device="cpu")
        text = torch.randn((B, 512), generator=torch.Generator().manual_seed(1))
        runs[dtype] = pipe.sample((B, T, F), {"text_embed": text}, guidance_param=2.5,
                                  generator=torch.Generator().manual_seed(2))
    want, got = runs[torch.float32], runs[torch.bfloat16]
    rel = float((got - want).norm() / want.norm())
    assert 0 < rel < 3e-2, rel


def test_bench_mdm_matches_committed_golden():
    """The full-width bench MDM (`bench.py` `mdm`: 8 layers, latent 512, 4 heads)
    with bench.py's JAX-initialised weights, perturbed leaf for leaf as
    `bench.verify_trajectory` does, through the bridge; f32 DDIM-20, B=2, noise
    from seed 7; against tests/golden/bench_traj_mdm.json at bench.py's 5e-3."""
    sys.path.insert(0, str(REPO))
    import bench

    t0 = time.perf_counter()
    golden = np.asarray(json.loads(
        (REPO / "tests" / "golden" / "bench_traj_mdm.json").read_text())["slice"])
    B = 2
    _, params, y, _, _, _ = bench.build_bench_model("mdm", B)
    leaves, treedef = jax.tree_util.tree_flatten(params["params"])
    prng = np.random.default_rng(11)
    leaves = [np.asarray(leaf) + 0.02 * prng.standard_normal(leaf.shape).astype(np.float32)
              for leaf in leaves]
    tm = TorchMDM(njoints=bench.F, latent_dim=512, ff_size=1024, num_layers=8, num_heads=4,
                  device="cpu", seed=None)
    tm.load_state_dict(load_flax_params({"params": jax.tree_util.tree_unflatten(treedef, leaves)}))
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 1000),
                                     use_timesteps=range(0, 1000, 50))
    noise = np.random.default_rng(7).standard_normal((B, bench.T, bench.F)).astype(np.float32)
    pipe = SamplePipeline(lambda x, t, y_, **_: tm(x, t, y_), sched, DiffusionConfig(),
                          SamplerConfig(method="ddim"), device="cpu")
    out = pipe.sample((B, bench.T, bench.F),
                      {"text_embed": torch.from_numpy(np.array(y["text_embed"]))},
                      noise=torch.from_numpy(noise)).numpy()
    got = out[:, ::7, ::13].astype(np.float64)
    print(f"bench MDM DDIM-20 golden check: {time.perf_counter() - t0:.1f} s on the CPU")
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() <= 5e-3
