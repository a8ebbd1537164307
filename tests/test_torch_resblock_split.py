"""The resblock half at every group width and length the JAX UNet computes, on the
CPU: the plan that sends each shape to the card's cluster route or split route
(ops/resblock.py `resblock_plan`, mirrored by csrc/resblock.cu `make_plan`), the
plain version at wide groups and long lengths against JAX's reference and its
Pallas kernel in interpret mode, a 1,088-channel ResidualTemporalBlock against
JAX's, and `supports` over every half of the UNet configurations the port runs.
The kernels themselves are held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py (phase 40)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.models.unet import ResidualTemporalBlock as JaxBlock
from condmdi_tpu.ops.resblock import fused_conv_gn_mish as jax_fused
from condmdi_tpu.ops.resblock import reference_conv_gn_mish as jax_reference
from condmdi_tpu.ops.resblock import supports as jax_supports
from condmdi_tpu_torch.ops import _build, resblock
from condmdi_tpu_torch.weights import load_flax_params

ATOL_F32 = 1e-5  # float32 on both sides; only summation order differs
DTYPES = [torch.float32, torch.bfloat16]


def make_inputs(B, T, cin, cout, seed=0, adagn=True, res=False):
    """numpy inputs in the JAX layouts (w is [k, Cin, Cout])."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    args = [rng.standard_normal((B, T, cin)).astype(f32),
            (rng.standard_normal((5, cin, cout)) * 0.05).astype(f32),
            (rng.standard_normal((cout,)) * 0.1).astype(f32),
            (1.0 + 0.1 * rng.standard_normal((cout,))).astype(f32),
            (0.1 * rng.standard_normal((cout,))).astype(f32)]
    kw = {}
    if adagn:
        kw["scale"] = (0.2 * rng.standard_normal((B, cout))).astype(f32)
        kw["shift"] = (0.2 * rng.standard_normal((B, cout))).astype(f32)
    if res:
        kw["res"] = rng.standard_normal((B, T, cout)).astype(f32)
    return args, kw


def to_torch(args, kw):
    x, w, b, g, be = (torch.from_numpy(a) for a in args)
    return (x, w.permute(2, 1, 0).contiguous(), b, g, be), {
        k: torch.from_numpy(v) for k, v in kw.items()}


# ----------------------------------------------------------------------------- plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plan_keeps_the_cluster_route_for_every_shape_it_took(dtype):
    """Every shape the cluster routes took before the split route existed (groups of
    at most 128 channels, at most 8 tiles a group) still goes to them, with the
    tiles, grid and cluster the kernel launched before."""
    for T in (1, 7, 25, 50, 64, 65, 100, 200, 224, 256, 257, 304, 420, 512, 1000, 1024):
        for group in (1, 4, 8, 16, 24, 32, 48, 64, 100, 128):
            for B in (1, 3, 8):
                cout = 8 * group
                plan = resblock.resblock_plan(B, T, 528, cout, dtype)
                tiles = resblock.f32_tiles(T) if dtype == torch.float32 else resblock.bf16_tiles(T)
                gpc = (1 if group >= tiles[1] else tiles[1] // group) \
                    if dtype == torch.float32 else 1
                size = resblock.cluster_size(T, group, dtype)
                assert size <= resblock._MAX_CLUSTER
                assert plan == resblock.ResblockPlan(
                    "cluster", tiles, -(-528 // (16 if dtype == torch.float32 else 32)),
                    (size, -(-8 // gpc), B), gpc, size, 0, (0, 0, 0), 0), (T, group, B)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("T,group", [
    (25, 136), (224, 136), (224, 256), (60, 256), (28, 512), (1, 512),  # wide groups
    (1025, 128), (1280, 16), (1280, 128), (2048, 64), (4096, 128), (1025, 256),  # long T
])
def test_plan_sends_the_rest_to_the_split_route(dtype, T, group):
    """A group wider than 128 channels, or one whose tiles would need a cluster of
    more than 8 CTAs, goes to the split route: the same conv tiles with no cluster,
    then a normalisation grid that covers every row and every channel of each
    group once, and a scratch of the pre-norm values and 3 moments a tile."""
    B, n_groups = 2, 8
    cout = n_groups * group
    plan = resblock.resblock_plan(B, T, 64, cout, dtype, n_groups)
    assert plan.route == "split" and plan.cluster == 1
    bm, bn, _ = plan.tiles
    assert plan.tiles == (resblock.f32_tiles(T) if dtype == torch.float32
                          else resblock.bf16_tiles(T))
    assert plan.grid[0] == resblock.cluster_size(T, group, dtype) == -(-T // bm) * -(-group // bn)
    assert plan.grid[0] > resblock._MAX_CLUSTER or group > resblock._MAX_GROUP
    assert plan.grid[1] * plan.groups_per_cta >= n_groups and plan.grid[2] == B
    rows, cols = plan.norm_rows, min(group, resblock._NORM_COLS)
    assert rows * cols <= resblock._NORM_ELEMS and plan.norm_grid[0] * rows >= T
    assert (plan.norm_grid[0] - 1) * rows < T
    assert plan.norm_grid[1:] == (n_groups * -(-group // resblock._NORM_COLS), B)
    assert plan.scratch == B * T * cout + 3 * B * n_groups * plan.grid[0]


def test_supports_is_the_card_kernels_predicate():
    """Every half with Cout a multiple of n_groups and 5 taps, at any batch, length,
    input width and group width; JAX computes each of them (its `supports` in
    interpret mode takes the same shapes)."""
    for B, T, cin, cout in [(1, 1, 7, 8), (4, 224, 526, 2048), (2, 1280, 2048, 1024),
                            (8, 4096, 16, 64), (2, 60, 64, 8 * 136), (3, 25, 26, 32)]:
        assert resblock.supports(B, T, cin, cout, 5, 8)
        assert jax_supports(B, T, cin, cout, 5, 8, interpret=True)
    assert not resblock.supports(2, 16, 8, 20, 5, 8)  # Cout % n_groups != 0
    assert not resblock.supports(2, 16, 8, 64, 3, 8)  # a conv width the kernel is not built for


# ---------------------------------------------------------- the plain version against JAX

WIDE_LONG = [
    # (B, T, Cin, Cout): groups of 136 (not a multiple of the 128-channel tile) and 256,
    # then lengths past a cluster of 8 row tiles
    (2, 24, 16, 8 * 136),
    (1, 20, 24, 8 * 256),
    (1, 1025, 12, 64),
    (1, 1280, 8, 128),
]


@pytest.mark.parametrize("shape", WIDE_LONG, ids=lambda s: "B{}T{}cin{}cout{}".format(*s))
@pytest.mark.parametrize("adagn,res", [(True, False), (False, True)])
def test_plain_matches_jax_at_wide_groups_and_long_lengths(shape, adagn, res):
    B, T, cin, cout = shape
    args, kw = make_inputs(B, T, cin, cout, adagn=adagn, res=res)
    targs, tkw = to_torch(args, kw)
    got = resblock.reference_conv_gn_mish(*targs, **tkw).numpy()
    jargs = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    np.testing.assert_allclose(got, np.asarray(jax_reference(*jargs, **jkw)), atol=ATOL_F32,
                               rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_fused(*jargs, **jkw, interpret=True)),
                               atol=ATOL_F32, rtol=0)
    # the wrapper on a CPU tensor is that plain version
    assert torch.equal(resblock.fused_conv_gn_mish(*targs, **tkw), torch.from_numpy(got))


@pytest.mark.parametrize("fused", [False, True], ids=["jax_unfused", "jax_interpret"])
def test_residual_block_of_1088_channels_matches_jax(fused):
    """A ResidualTemporalBlock 1,088 channels wide (groups of 136) from 544 input
    channels, AdaGN and the 1x1 residual conv: the port's block (its halves through
    `fused_conv_gn_mish`) against JAX's, unfused and with its Pallas kernel in
    interpret mode, on the same converted weights."""
    from condmdi_tpu_torch.models.unet import ResidualTemporalBlock

    B, T, cin, cout, emb = 2, 12, 544, 1088, 32
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, cin)).astype(np.float32)
    t_emb = rng.standard_normal((B, emb)).astype(np.float32)
    jm = JaxBlock(cout, zero=False, fused=fused)
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t_emb))
    params = jax.tree_util.tree_map(  # the zero-initialised time_mlp carries signal too
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t_emb)))
    tm = ResidualTemporalBlock(cin, cout, emb, zero=False, device="cpu")
    tm.load_state_dict(load_flax_params(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), resblock.mish(torch.from_numpy(t_emb))).numpy()
    assert got.shape == (B, T, cout)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)  # two convs of 2,720 terms


# ------------------------------------------- every half of the UNets the port runs


def unet_halves(model, B, T, F):
    """(B, T, Cin, Cout, k, n_groups) of every resblock half of one forward of the
    port's MDM_UNET `model` (built on the meta device) on F features, from a
    forward with the half recorded instead of computed."""
    from condmdi_tpu_torch.models import unet

    seen = []

    def record(x, w, b, gamma, beta, scale=None, shift=None, res=None, *, n_groups=8,
               eps=1e-5, packed=None):
        seen.append((x.shape[0], x.shape[1], w.shape[1], w.shape[0], w.shape[2], n_groups))
        return torch.empty((x.shape[0], x.shape[1], w.shape[0]), device=x.device, dtype=x.dtype)

    meta = dict(device="meta")
    kw = {}
    if model.keyframe_conditioned:
        kw = dict(obs_x0=torch.empty(B, T, F, **meta),
                  obs_mask=torch.empty(B, T, F, dtype=torch.bool, **meta))
    original = unet.fused_conv_gn_mish
    unet.fused_conv_gn_mish = record
    try:
        with torch.no_grad():
            model(torch.empty(B, T, F, **meta), torch.zeros(B, dtype=torch.long, **meta),
                  {"text_embed": torch.empty(B, 512, **meta)}, **kw)
    finally:
        unet.fused_conv_gn_mish = original
    return seen


def meta_unet(**config):
    from condmdi_tpu_torch.models.unet import MDM_UNET

    return MDM_UNET(**config, device="meta", seed=None)


def meta_trajectory_model():
    """traj_unet_adagn_swx through the factory, as the GMD CLIs build it."""
    from condmdi_tpu_torch.models.factory import create_model
    from condmdi_tpu_torch.utils.config import traj_unet_adagn_swx

    return create_model(traj_unet_adagn_swx(), device="meta")


XL = dict(njoints=263, latent_dim=512, dim_mults=(2, 2, 2, 2), keyframe_conditioned=True)
CONFIGS = {
    # (model builder, B, frames, features, halves a forward)
    "unet_xl_pad200": (lambda: meta_unet(**XL, pad_frames_to=200), 8, 196, 263, 33),
    "unet_xl_pad1280": (lambda: meta_unet(**XL, pad_frames_to=1280), 2, 1280, 263, 33),
    "latent1024_pad224": (lambda: meta_unet(**dict(XL, latent_dim=1024), pad_frames_to=224),
                          4, 196, 263, 33),
    "gate": (lambda: meta_unet(njoints=263, latent_dim=128, dim_mults=(1, 2, 2),
                               keyframe_conditioned=True, pad_frames_to=224), 32, 196, 263, 25),
    "trajectory": (meta_trajectory_model, 2, 196, 4, 25),
    "amass": (lambda: meta_unet(njoints=764, latent_dim=512, dim_mults=(2, 2, 2, 2),
                                keyframe_conditioned=True, pad_frames_to=128,
                                cond_mode="no_cond"), 8, 128, 764, 33),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_half_of_each_unet_is_taken_by_the_card_kernel(name):
    """Each half of the UNet-XL (pad 200 and pad 1280), the latent-1024 XL, the gate,
    the trajectory model's widths and AMASS's XL is one `supports` takes and JAX
    computes; the plan sends it to a route (the split route where the group is
    wider than 128 channels or the length past 1,024)."""
    build, B, frames, feats, halves = CONFIGS[name]
    seen = unet_halves(build(), B, frames, feats)
    assert len(seen) == halves
    for B_, T, cin, cout, k, groups in seen:
        assert resblock.supports(B_, T, cin, cout, k, groups)
        assert jax_supports(B_, T, cin, cout, k, groups, interpret=True)
        for dtype in DTYPES:
            plan = resblock.resblock_plan(B_, T, cin, cout, dtype, groups)
            wide_or_long = (cout // groups > resblock._MAX_GROUP
                            or resblock.cluster_size(T, cout // groups, dtype)
                            > resblock._MAX_CLUSTER)
            assert plan.route == ("split" if wide_or_long else "cluster")
    if name in ("latent1024_pad224", "unet_xl_pad1280"):
        assert any(resblock.resblock_plan(*h[:4], torch.float32, h[5]).route == "split"
                   for h in seen)


# ------------------------------------------------------- the card path on the split route


class FakeLib:
    """The C entry, recording what the wrapper hands it."""

    calls = []

    @staticmethod
    def condmdi_resblock_forward(*args):
        FakeLib.calls.append(args)
        return 0


def _never_plain(*_a, **_k):
    raise AssertionError("the card path fell back to the plain version")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("T,cout", [(224, 2048), (1025, 64), (20, 8 * 136)])
def test_split_route_gets_its_scratch_and_counts_one_launch(monkeypatch, dtype, T, cout):
    """On the split route the wrapper hands the C entry a float32 scratch of the
    plan's size (the pre-norm values, then the moments); on the cluster route a null
    one. One call counts one launch, and the plain version is never taken."""
    monkeypatch.setattr(resblock, "reference_conv_gn_mish", _never_plain)
    monkeypatch.setattr(_build, "load_resblock", lambda: FakeLib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type(
        "S", (), {"cuda_stream": 0})())
    allocated = []
    empty = torch.empty

    def spy(*shape, **kw):
        out = empty(*shape, **kw)
        allocated.append(out)
        return out

    monkeypatch.setattr(torch, "empty", spy)
    for T_, expect in ((T, "split"), (16, "cluster" if cout // 8 <= 128 else "split")):
        args, kw = make_inputs(1, T_, 8, cout, adagn=True, res=True)
        (x, w, b, g, be), tkw = to_torch(args, kw)
        x, w, b, g, be = (t.to(dtype) for t in (x, w, b, g, be))
        tkw = {k: v.to(dtype) for k, v in tkw.items()}
        plan = resblock.resblock_plan(1, T_, 8, cout, dtype)
        assert plan.route == expect
        before, allocated[:] = resblock.fused_conv_gn_mish.launches, []
        resblock._launch(x, w, b, g, be, tkw["scale"], tkw["shift"], tkw["res"], 8, 1e-5)
        assert resblock.fused_conv_gn_mish.launches == before + 1
        scratch = FakeLib.calls[-1][-1]
        if expect == "split":
            buf = next(t for t in allocated if t.data_ptr() == scratch)
            assert buf.dtype == torch.float32 and buf.numel() == plan.scratch
        else:
            assert scratch is None
