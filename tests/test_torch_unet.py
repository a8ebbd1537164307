"""The port's UNet denoiser and weight bridge against the JAX package, on the CPU
in float32: MDM_UNET at a small keyframe config, the trained gate checkpoint
(save/synthetic_unet_m, loaded straight from its npz), and the CFG wrapper."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.models.cfg import make_cfg_denoiser as jax_cfg
from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu_torch.models.cfg import make_cfg_denoiser as torch_cfg
from condmdi_tpu_torch.models.unet import MDM_UNET as TorchUNet
from condmdi_tpu_torch.weights import load_flax_params

REPO = Path(__file__).resolve().parent.parent
GATE_DIR = REPO / "save" / "synthetic_unet_m"
GATE_NPZ = GATE_DIR / "gate_ema_000100000.npz"
ATOL = 1e-4  # float32 through every conv; sums run in another order

F = 263


def small_config(zero=False, adagn=True):
    return dict(njoints=F, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
                pad_frames_to=24, zero=zero, adagn=adagn)


def inputs(B, T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    obs = rng.standard_normal((B, T, F)).astype(np.float32)
    mask = np.zeros((B, T, F), bool)
    mask[:, ::6] = True
    mask[0, 3, :40] = True  # a partial keyframe row
    text = rng.standard_normal((B, 512)).astype(np.float32)
    t = rng.integers(0, 1000, (B,))
    return x, obs, mask, text, t


def jax_pair(config, B, T, seed=0, perturb=True):
    """(JAX model, params tree, torch model with the converted tree)."""
    x, obs, mask, text, t = inputs(B, T, seed)
    jm = JaxUNet(**config)
    params = jm.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(t),
                     {"text_embed": jnp.asarray(text)}, obs_x0=jnp.asarray(obs),
                     obs_mask=jnp.asarray(mask))
    params = jax.tree_util.tree_map(np.asarray, params)
    if perturb:  # so zero-initialised layers carry signal too
        rng = np.random.default_rng(seed + 100)
        params = jax.tree_util.tree_map(
            lambda p: (p + 0.05 * rng.standard_normal(p.shape)).astype(np.float32), params)
    tm = TorchUNet(**config, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(params))
    return jm, params, tm


def run_both(jm, params, tm, x, t, y, obs, mask):
    # arrays convert; a plain bool `uncond` stays a bool in both frameworks
    conv = lambda f: {k: f(v) if isinstance(v, np.ndarray) else v for k, v in y.items()}  # noqa: E731
    jy = conv(jnp.asarray)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t), jy,
                               obs_x0=jnp.asarray(obs), obs_mask=jnp.asarray(mask)))
    ty = conv(torch.from_numpy)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), ty,
                 obs_x0=torch.from_numpy(obs), obs_mask=torch.from_numpy(mask)).numpy()
    return got, want


@pytest.mark.parametrize("T", [24, 17])
@pytest.mark.parametrize("adagn", [True, False])
@pytest.mark.parametrize("uncond", ["none", "all", "rows"])
def test_small_unet_matches_jax(T, adagn, uncond):
    B = 3
    jm, params, tm = jax_pair(small_config(adagn=adagn), B, 24)
    x, obs, mask, text, t = inputs(B, T, seed=1)
    y = {"text_embed": text}
    if uncond == "all":
        y["uncond"] = True
    elif uncond == "rows":
        y["uncond"] = np.array([False, True, False])
    got, want = run_both(jm, params, tm, x, t, y, obs, mask)
    assert got.shape == (B, T, F)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_small_unet_matches_jax_past_the_first_f32_kernels_limit():
    """T=304 frames (padded to 304): the top level's resblock halves run at a
    length that the first float32 kernel refused on the card (T <= 299) and the
    redesigned one takes (a cluster of 5 x 1 tiles); the port's float32 forward
    equals JAX's UNet, which runs unfused where its kernel does not fit."""
    from condmdi_tpu_torch.ops import resblock

    B, T = 2, 304
    config = dict(small_config(), pad_frames_to=T)
    jm, params, tm = jax_pair(config, B, T)
    x, obs, mask, text, t = inputs(B, T, seed=2)
    got, want = run_both(jm, params, tm, x, t, {"text_embed": text}, obs, mask)
    assert got.shape == (B, T, F)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    widths = {m.conv.weight.shape[0] // m.n_groups for m in tm.modules()
              if hasattr(m, "packed")}
    assert all(resblock.cluster_size(T, g, torch.float32) <= 8 for g in widths)


def test_bridge_covers_every_parameter_and_layout():
    jm, params, tm = jax_pair(small_config(zero=True), 2, 24, perturb=False)
    sd = load_flax_params(params)
    assert set(sd) == set(tm.state_dict())
    p = params["params"]["unet"]
    conv = p["down0_res1"]["block1"]["conv"]["kernel"]  # [k, Cin, Cout]
    np.testing.assert_array_equal(sd["unet.down0_res1.block1.conv.weight"].numpy(),
                                  conv.transpose(2, 1, 0))
    dense = p["time_fc1"]["kernel"]  # [in, out]
    np.testing.assert_array_equal(sd["unet.time_fc1.weight"].numpy(), dense.T)
    up = p["up0_upsample"]["kernel"]  # [k, in, out], flipped along k
    np.testing.assert_array_equal(sd["unet.up0_upsample.weight"].numpy(),
                                  up[::-1].transpose(1, 2, 0))
    np.testing.assert_array_equal(sd["unet.final_block.norm.weight"].numpy(),
                                  p["final_block"]["norm"]["scale"])
    # ChannelLayerNorm's g (LinearAttention is ported) is kept as it is; a leaf the
    # port has no layout for still raises
    g = np.arange(3, dtype=np.float32)
    assert np.array_equal(load_flax_params({"params": {"attn": {"g": g}}})["attn.g"].numpy(), g)
    with pytest.raises(KeyError):
        load_flax_params({"params": {"attn": {"gamma": np.ones(3, np.float32)}}})


def test_bridge_reads_the_flat_npz_like_the_tree(tmp_path):
    _, params, _ = jax_pair(small_config(), 2, 24)
    sys.path.insert(0, str(REPO / "scripts"))
    from gate_params_io import flatten_tree

    path = tmp_path / "p.npz"
    np.savez(path, __params_fingerprint__=np.array("x"), __step__=np.array(1),
             **flatten_tree(params))
    from_npz, from_tree = load_flax_params(path), load_flax_params(params)
    assert set(from_npz) == set(from_tree)
    for k in from_tree:
        assert torch.equal(from_npz[k], from_tree[k]), k


def test_seeded_init_is_deterministic_and_mirrors_zero_init():
    a = TorchUNet(**small_config(zero=True), device="cpu", seed=3)
    b = TorchUNet(**small_config(zero=True), device="cpu", seed=3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    assert not sd["unet.final_conv.weight"].any()          # zero-init output layer
    assert not sd["unet.down0_res1.time_mlp.weight"].any()  # zero-init AdaGN MLP
    assert not sd["unet.down0_res1.block2.conv.weight"].any()
    assert sd["unet.down0_res1.block1.conv.weight"].std() > 0
    assert torch.equal(sd["unet.final_block.norm.weight"], torch.ones(16))


@pytest.fixture(scope="module")
def gate():
    args = json.loads((GATE_DIR / "args.json").read_text())
    config = dict(njoints=F, latent_dim=args["latent_dim"],
                  dim_mults=tuple(args["dim_mults"]), adagn=args["unet_adagn"],
                  zero=args["unet_zero"], keyframe_conditioned=args["keyframe_conditioned"],
                  pad_frames_to=args["unet_pad_to"])
    sys.path.insert(0, str(REPO / "scripts"))
    from gate_params_io import load_npz

    tree, _, _ = load_npz(GATE_NPZ)
    tm = TorchUNet(**config, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(GATE_NPZ))
    return JaxUNet(**config), tree, tm


def test_gate_checkpoint_matches_jax(gate):
    jm, params, tm = gate
    B, T = 2, 196
    x, obs, mask, text, t = inputs(B, T, seed=4)
    got, want = run_both(jm, params, tm, x, t, {"text_embed": text}, obs, mask)
    assert np.abs(want).max() > 0.1  # a trained model, not a zero output
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_cfg_denoiser_matches_jax(scale):
    B, T = 2, 24
    jm, params, tm = jax_pair(small_config(), B, T)
    x, obs, mask, text, t = inputs(B, T, seed=6)

    def japply(x_, t_, y_, **kw):
        return jm.apply(params, x_, t_, y_, **kw)

    jden = jax_cfg(japply, {"text_embed": jnp.asarray(text)}, scale,
                   obs_x0=jnp.asarray(obs), obs_mask=jnp.asarray(mask))
    tden = torch_cfg(tm, {"text_embed": torch.from_numpy(text)}, scale,
                     obs_x0=torch.from_numpy(obs), obs_mask=torch.from_numpy(mask))
    want = np.asarray(jden(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tden(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL * scale, rtol=0)


def _block_inputs(B=2, T=12, cin=24, cout=32, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    return f(B, T, cin), 0.2 * f(B, cout), 0.2 * f(B, cout)


def _fresh_block(seed, cin=24, cout=32):
    from condmdi_tpu_torch.models.layers import init_params
    from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock

    return init_params(Conv1dAdaGNBlock(cin, cout, device="cpu"), seed)


@pytest.mark.parametrize("change", ["load_state_dict", "in_place", "to_bfloat16"])
def test_block_follows_new_weights_after_a_first_forward(change):
    """The packed copy the card path would read (in float32 the weight's hi and lo
    bf16 parts, in bfloat16 the weight itself) is current with the weight after
    every way the weights change once a forward has run, and so is the output."""
    from condmdi_tpu_torch.ops.resblock import packed_for_kernel, reference_conv_gn_mish

    block = _fresh_block(0)
    x, scale, shift = _block_inputs()
    with torch.no_grad():
        before = block(x, scale, shift)
    stale = block.packed.get(block.conv.weight).clone()
    if change == "load_state_dict":
        block.load_state_dict(_fresh_block(1).state_dict())
    elif change == "in_place":
        with torch.no_grad():
            block.conv.weight.add_(0.05)
    else:
        block.to(torch.bfloat16)
        x, scale, shift = (t.to(torch.bfloat16) for t in (x, scale, shift))
    packed = block.packed.get(block.conv.weight)
    assert packed.dtype == torch.bfloat16
    assert torch.equal(packed, packed_for_kernel(block.conv.weight.detach()))
    assert not torch.equal(packed.float(), stale.float())
    with torch.no_grad():
        after = block(x, scale, shift)
        want = reference_conv_gn_mish(x, block.conv.weight, block.conv.bias, block.norm.weight,
                                      block.norm.bias, scale, shift)
    assert torch.equal(after, want)
    if change != "to_bfloat16":
        assert (after - before).abs().max() > 1e-3


def test_state_dict_keys_are_unchanged_by_a_forward():
    tm = TorchUNet(**small_config(), device="cpu", seed=0)
    keys = list(tm.state_dict())
    x, obs, mask, text, t = inputs(2, 24)
    with torch.no_grad():
        tm(torch.from_numpy(x), torch.from_numpy(t), {"text_embed": torch.from_numpy(text)},
           obs_x0=torch.from_numpy(obs), obs_mask=torch.from_numpy(mask))
    half = tm.unet.down0_res1.block1
    half.packed.get(half.conv.weight)
    assert list(tm.state_dict()) == keys
    assert not any("packed" in k for k in keys)
    assert not any("packed" in n for n, _ in tm.named_buffers())


@pytest.mark.parametrize("keyframes", [True, False])
def test_padded_input_path_matches_jax(keyframes):
    """The first resblock receives 2F = 526 (or F = 263) channels padded to a
    multiple of 8, and the output still matches the JAX model."""
    config = dict(small_config(), keyframe_conditioned=keyframes)
    B, T = 2, 21
    jm, params, tm = jax_pair(config, B, 24)
    seen = []
    handle = tm.unet.down0_res1.block1.register_forward_hook(
        lambda _m, args, _out: seen.append(args[0].shape))
    x, obs, mask, text, t = inputs(B, T, seed=2)
    got, want = run_both(jm, params, tm, x, t, {"text_embed": text}, obs, mask)
    handle.remove()
    channels = 2 * F if keyframes else F
    assert seen == [(B, 24, -(-channels // 8) * 8)] and seen[0][-1] % 8 == 0
    assert tm.unet.down0_res1.block1.conv.weight.shape[1] == channels
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
