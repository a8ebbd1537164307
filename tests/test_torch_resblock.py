"""The port's fused resblock half (condmdi_tpu_torch/ops/resblock.py) against
the JAX package's: its plain version against JAX's XLA reference and against
the Pallas kernel in interpret mode, on the CPU; and the wrapper's refusal
to fall back. Wide groups and long lengths (the split route) are in
tests/test_torch_resblock_split.py. Gradients through its autograd Function are held to JAX's in
tests/test_torch_grad.py. The Hopper kernel itself is held to its plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from condmdi_tpu.ops.resblock import fused_conv_gn_mish as jax_fused
from condmdi_tpu.ops.resblock import reference_conv_gn_mish as jax_reference
from condmdi_tpu_torch.ops import _build, resblock

ATOL_F32 = 1e-5  # float32 on both sides; only summation order differs


def make_inputs(B, T, cin, cout, k=5, seed=0, adagn=True, res=False):
    """numpy inputs in the JAX layouts (w is [k, Cin, Cout])."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    args = [
        rng.standard_normal((B, T, cin)).astype(f32),
        (rng.standard_normal((k, cin, cout)) * 0.05).astype(f32),
        (rng.standard_normal((cout,)) * 0.1).astype(f32),
        (1.0 + 0.1 * rng.standard_normal((cout,))).astype(f32),
        (0.1 * rng.standard_normal((cout,))).astype(f32),
    ]
    kw = {}
    if adagn:
        kw["scale"] = (0.2 * rng.standard_normal((B, cout))).astype(f32)
        kw["shift"] = (0.2 * rng.standard_normal((B, cout))).astype(f32)
    if res:
        kw["res"] = rng.standard_normal((B, T, cout)).astype(f32)
    return args, kw


def to_torch(args, kw):
    x, w, b, g, be = (torch.from_numpy(a) for a in args)
    w = w.permute(2, 1, 0).contiguous()  # [k, Cin, Cout] -> [Cout, Cin, k]
    return (x, w, b, g, be), {k: torch.from_numpy(v) for k, v in kw.items()}


def to_jax(args, kw):
    return [jnp.asarray(a) for a in args], {k: jnp.asarray(v) for k, v in kw.items()}


SHAPES = [
    # (B, T, Cin, Cout, n_groups): odd T = 25 and Cin = 26 (not a multiple of 8)
    # stand for the bottom level and the 526-channel keyframe concat
    (3, 25, 26, 32, 8),
    (2, 16, 24, 32, 8),
    (2, 12, 40, 48, 4),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}T{}cin{}cout{}g{}".format(*s))
@pytest.mark.parametrize("adagn", [True, False])
@pytest.mark.parametrize("res", [True, False])
def test_plain_matches_jax_reference_and_interpret_kernel(shape, adagn, res):
    B, T, cin, cout, groups = shape
    args, kw = make_inputs(B, T, cin, cout, adagn=adagn, res=res)
    targs, tkw = to_torch(args, kw)
    got = resblock.reference_conv_gn_mish(*targs, **tkw, n_groups=groups).numpy()
    jargs, jkw = to_jax(args, kw)
    want_ref = np.asarray(jax_reference(*jargs, **jkw, n_groups=groups))
    want_pallas = np.asarray(jax_fused(*jargs, **jkw, n_groups=groups, interpret=True))
    np.testing.assert_allclose(got, want_ref, atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=ATOL_F32, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and counts no launch."""
    args, kw = make_inputs(2, 16, 24, 32, adagn=True, res=True)
    targs, tkw = to_torch(args, kw)
    before = resblock.fused_conv_gn_mish.launches
    got = resblock.fused_conv_gn_mish(*targs, **tkw)
    want = resblock.reference_conv_gn_mish(*targs, **tkw)
    assert torch.equal(got, want)
    assert resblock.fused_conv_gn_mish.launches == before


def test_mish_is_overflow_free():
    x = torch.tensor([-1e4, -30.0, -1.0, 0.0, 1.0, 30.0, 1e4])
    got = resblock.mish(x)
    assert torch.isfinite(got).all()
    want = x * torch.tanh(torch.nn.functional.softplus(x.double())).float()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def _never_plain(*_a, **_k):
    raise AssertionError("the card path fell back to the plain version")


def test_card_path_raises_when_the_kernel_cannot_be_built(monkeypatch, tmp_path):
    """The card path (`_launch`, what a CUDA tensor reaches) raises when the
    kernel is unavailable, and never takes the plain version."""
    monkeypatch.setattr(resblock, "reference_conv_gn_mish", _never_plain)

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    args, kw = make_inputs(2, 16, 24, 32, adagn=True, res=True)
    targs, tkw = to_torch(args, kw)
    before = resblock.fused_conv_gn_mish.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        resblock._launch(*targs, tkw["scale"], tkw["shift"], tkw["res"], 8, 1e-5)
    assert resblock.fused_conv_gn_mish.launches == before


def test_card_path_refuses_autograd(monkeypatch, tmp_path):
    """The card path refused a grad-requiring input until the autograd Function
    (`ConvGnMish`) carried reconstruction guidance; it refuses it no more: such
    an input goes on to the kernel (whose build fails here, without nvcc) and
    never to the plain version."""
    monkeypatch.setattr(resblock, "reference_conv_gn_mish", _never_plain)
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc")))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    args, kw = make_inputs(2, 16, 24, 32, adagn=False, res=False)
    targs, _ = to_torch(args, kw)
    x = targs[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="nvcc"):
        resblock._launch(x, *targs[1:], None, None, None, 8, 1e-5)


def _stub_out_nvcc(monkeypatch, tmp_path):
    """The card path with no compiler: a call that reaches the build raises there."""
    monkeypatch.setattr(resblock, "reference_conv_gn_mish", _never_plain)
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc")))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")


@pytest.mark.parametrize("bad", ["group_width", "dtype", "weight", "groups"])
def test_card_path_rejects_what_the_kernel_does_not_take(bad, monkeypatch, tmp_path):
    """A dtype other than float32/bfloat16, a conv width other than 5 and a Cout
    that n_groups does not divide are refused before any build. A group wider than
    the cluster routes' 128 channels (256 here) was refused too until the split
    route took it: such a call now goes on to the kernel's build (which fails
    here, without nvcc) and never to the plain version."""
    args, kw = make_inputs(2, 16, 24, 32, adagn=False, res=False)
    (x, w, b, g, be), _ = to_torch(args, kw)
    groups = 8
    if bad == "group_width":
        x, w = torch.zeros(1, 4, 8), torch.zeros(2048, 8, 5)
        b = g = be = torch.zeros(2048)
        assert resblock.resblock_plan(1, 4, 8, 2048, torch.float32).route == "split"
        _stub_out_nvcc(monkeypatch, tmp_path)
        before = resblock.fused_conv_gn_mish.launches
        with pytest.raises(RuntimeError, match="nvcc"):
            resblock._launch(x, w, b, g, be, None, None, None, groups, 1e-5)
        assert resblock.fused_conv_gn_mish.launches == before
        return
    if bad == "dtype":
        x = x.double()
    elif bad == "weight":
        w = w[..., :4]
    else:
        groups = 5
    with pytest.raises((ValueError, TypeError, NotImplementedError)):
        resblock._launch(x, w, b, g, be, None, None, None, groups, 1e-5)


def test_other_devices_raise():
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        resblock.fused_conv_gn_mish(x, x, x, x, x)


def test_smem_fits_the_main_path():
    """Every main-path T (pad 200 and pad 224) fits one CTA in both types."""
    for T in (200, 224, 25):
        for dtype in (torch.bfloat16, torch.float32):
            assert resblock.smem_bytes(T, 5, dtype) <= resblock._MAX_SMEM


@pytest.mark.parametrize("cin", [526, 1024, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_round_trips_and_pads_with_zeros(cin, dtype):
    """unpack(pack(w)) == w, and the channels past Cin and Cout are zero."""
    rng = np.random.default_rng(cin)
    cout = 20  # not a multiple of the 8-channel block
    w = torch.from_numpy(rng.standard_normal((cout, cin, 5)).astype(np.float32)).to(dtype)
    wp = resblock.pack_conv_weight(w)
    cin_pad = -(-cin // 32) * 32
    assert wp.shape == (cin_pad // 32, 5, 3, 4, 8, 8) and wp.is_contiguous() and wp.dtype == dtype
    assert torch.equal(resblock.unpack_conv_weight(wp, cout, cin), w)
    full = resblock.unpack_conv_weight(wp, 24, cin_pad)
    assert not full[:, cin:].any() and not full[cout:].any()
    # the layout the kernel indexes: [chunk, tap, channel block, input block, channel, input]
    chunk = (cin - 1) // 32  # the last chunk, partly padding unless Cin % 32 == 0
    assert wp[chunk, 3, 13 // 8, 0, 13 % 8, 2] == w[13, chunk * 32 + 2, 3]


def test_plain_version_ignores_alignment_channels():
    """x may carry up to 7 trailing channels beyond the weight's Cin."""
    args, kw = make_inputs(2, 16, 26, 32, adagn=True, res=True)
    targs, tkw = to_torch(args, kw)
    x_padded = torch.cat([targs[0], torch.full((2, 16, 6), 9.0)], dim=-1)  # 26 -> 32
    got = resblock.fused_conv_gn_mish(x_padded, *targs[1:], **tkw)
    assert torch.equal(got, resblock.reference_conv_gn_mish(*targs, **tkw))
    with pytest.raises(ValueError, match="Cin"):
        resblock._launch(torch.zeros(2, 16, 33), *targs[1:], None, None, None, 8, 1e-5)


@pytest.mark.parametrize("T,group,expected", [
    (200, 128, 2), (100, 128, 1), (50, 128, 2), (25, 128, 2), (224, 128, 2), (7, 4, 1), (1024, 128, 8),
])
def test_cluster_covers_one_batch_item_and_group(T, group, expected):
    """The bf16 kernel's cluster: 64- or 128-row tiles along T, 64-column tiles at T <= 64."""
    assert resblock.cluster_size(T, group) == expected
    assert resblock.smem_bytes(T, 5, torch.bfloat16) <= resblock._MAX_SMEM


def test_card_path_refuses_a_length_no_cluster_holds(monkeypatch, tmp_path):
    """T=1025, the first length past a cluster of 8 row tiles, was refused in both
    types until the split route took it: the plan sends it there, and the call goes
    on to the kernel's build (which fails here, without nvcc), never to the plain
    version."""
    _stub_out_nvcc(monkeypatch, tmp_path)
    for dtype in (torch.bfloat16, torch.float32):
        targs = [t.to(dtype) for t in to_torch(*make_inputs(1, 1025, 8, 16, adagn=False,
                                                              res=False))[0]]
        assert resblock.cluster_size(1025, 2, dtype) > resblock._MAX_CLUSTER
        assert resblock.resblock_plan(1, 1025, 8, 16, dtype).route == "split"
        with pytest.raises(RuntimeError, match="nvcc"):
            resblock._launch(*targs, None, None, None, 8, 1e-5)


def test_packed_weight_cache_follows_the_weight():
    cache = resblock.PackedConvWeight()
    w = torch.nn.Parameter(torch.randn(8, 40, 5))
    first = cache.get(w)
    assert cache.get(w) is first  # unchanged weight: no repack
    with torch.no_grad():
        w.mul_(2.0)
    second = cache.get(w)
    # float32: the hi and lo parts the float32 kernel reads
    assert second is not first and torch.equal(second, resblock.split_conv_weight(w.detach()))
    w.data = w.data.to(torch.bfloat16)
    third = cache.get(w)
    assert third.dtype == torch.bfloat16
    assert torch.equal(third, resblock.pack_conv_weight(w.detach()))


@pytest.mark.parametrize("cin,cout", [(526, 1024), (2048, 1024), (128, 256), (7, 20)])
def test_split_weight_round_trips_within_two_to_the_minus_16(cin, cout):
    """The float32 kernel's weight: hi = bf16(w) and lo = bf16(w - hi), each packed
    in 16-channel chunks; unpacking gives them back, hi + lo is w within 2^-16 of
    |w|, and the channels past Cin and Cout are zero."""
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy((rng.standard_normal((cout, cin, 5)) * 0.05).astype(np.float32))
    wp = resblock.split_conv_weight(w)
    cin_pad, cout8 = -(-cin // 16) * 16, -(-cout // 8)
    assert wp.shape == (2, cin_pad // 16, 5, cout8, 2, 8, 8) and wp.dtype == torch.bfloat16
    assert wp.is_contiguous()
    hi = resblock.unpack_conv_weight(wp[0], cout, cin)
    lo = resblock.unpack_conv_weight(wp[1], cout, cin)
    assert torch.equal(hi, w.to(torch.bfloat16))
    assert torch.equal(lo, (w - hi.float()).to(torch.bfloat16))
    assert torch.all((hi.float() + lo.float() - w).abs() <= 2.0 ** -16 * w.abs())
    for plane in wp:
        full = resblock.unpack_conv_weight(plane, cout8 * 8, cin_pad)
        assert not full[:, cin:].any() and not full[cout:].any()
    # the layout the kernel indexes: [plane, chunk, tap, channel block, input block, channel, input]
    assert wp[0, (cin - 1) // 16, 2, (cout - 1) // 8, ((cin - 1) % 16) // 8, (cout - 1) % 8,
              (cin - 1) % 8] == hi[cout - 1, cin - 1, 2]


# (B, T, Cin, Cout, adagn, res) of every f32 resblock half the conditional CLI runs:
# the gate UNet (latent 128, dim_mults 1 2 2, pad 224) at B=8, UNet-XL at pad 224, B=4
CLI_F32_SHAPES = [
    (8, 224, 526, 128), (8, 224, 128, 128), (8, 112, 128, 128), (8, 112, 128, 256),
    (8, 112, 256, 256), (8, 112, 512, 128), (8, 56, 256, 256), (8, 56, 512, 256),
    (4, 224, 526, 1024), (4, 224, 1024, 1024), (4, 112, 1024, 1024), (4, 112, 2048, 1024),
    (4, 56, 1024, 1024), (4, 56, 2048, 1024), (4, 28, 1024, 1024), (4, 28, 2048, 1024),
]


@pytest.mark.parametrize("shape", CLI_F32_SHAPES, ids=lambda s: "B{}T{}cin{}cout{}".format(*s))
def test_f32_tiles_take_every_cli_shape(shape):
    """The mirrors of the float32 kernel's tiles, cluster and shared memory take
    every f32 shape of both CLIs: a cluster of at most 8 and a ring within a
    block's shared memory, with room for the static part."""
    B, T, cin, cout = shape
    group = cout // 8
    bm, bn, stages = resblock.f32_tiles(T)
    assert (bm, bn, stages) == ((64, 64, 3) if T <= 256 else (128, 128, 3))
    assert resblock.cluster_size(T, group, torch.float32) <= resblock._MAX_CLUSTER
    assert resblock.smem_bytes(T, 5, torch.float32) + 12288 <= resblock._MAX_SMEM


@pytest.mark.parametrize("T", [1, 64, 65, 255, 256, 257, 304, 420, 512, 1000, 1024])
@pytest.mark.parametrize("group", [16, 32, 64, 128])
def test_f32_route_takes_every_length_the_bf16_route_takes(T, group):
    """Up to T=1024 for every group width, as in bfloat16; the ring of 64-row tiles
    (two CTAs an SM) up to T=256, 128-row tiles beyond."""
    for dtype in (torch.float32, torch.bfloat16):
        assert resblock.cluster_size(T, group, dtype) <= resblock._MAX_CLUSTER
        assert resblock.smem_bytes(T, 5, dtype) <= resblock._MAX_SMEM
    assert resblock.cluster_size(1025, group, torch.float32) > resblock._MAX_CLUSTER
    if T <= 256:  # two CTAs and their static shared memory fit one SM's 228 KB
        assert 2 * (resblock.smem_bytes(T, 5, torch.float32) + 4096 + 1024) <= 228 * 1024


def test_card_path_hands_the_kernel_the_split_weight(monkeypatch):
    """A float32 call gives the C entry the split weight (from the caller's cache),
    its padded Cin, x padded to whole 16-byte pieces, and dtype code 0; it counts
    the launch once, and never takes the plain version."""
    class Lib:
        @staticmethod
        def condmdi_resblock_forward(*args):
            Lib.args = args
            return 0

    monkeypatch.setattr(resblock, "reference_conv_gn_mish", _never_plain)
    monkeypatch.setattr(_build, "load_resblock", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type(
        "S", (), {"cuda_stream": 0})())
    args, kw = make_inputs(2, 30, 26, 32, adagn=True, res=True)
    (x, w, b, g, be), tkw = to_torch(args, kw)
    cache = resblock.PackedConvWeight()
    before = resblock.fused_conv_gn_mish.launches
    resblock._launch(x, w, b, g, be, tkw["scale"], tkw["shift"], tkw["res"], 8, 1e-5, cache)
    assert resblock.fused_conv_gn_mish.launches == before + 1
    split = cache.get(w)
    assert Lib.args[1] == split.data_ptr() and split.shape[0] == 2
    # B, T, x's row pitch (26 -> 28), Cin padded to the 16-channel stage, Cout, k, groups
    assert Lib.args[10:17] == (2, 30, 28, 32, 32, 5, 8)
    assert Lib.args[18] == 0  # float32


def test_probe_switches_are_the_sources_and_the_package_builds_without_them(monkeypatch):
    """resblock_probe.py names the parts of the float32 kernel it switches off by
    the bits of csrc/resblock.cu `ProbeOff`; the package's own build passes no
    probe macro, so its library is the kernel as written."""
    import re

    monkeypatch.syspath_prepend(str(_build.PKG_DIR.parent))
    import resblock_probe as probe

    source = (_build.CSRC_DIR / "resblock.cu").read_text()
    body = re.search(r"enum ProbeOff \{(.*?)\};", source, re.S).group(1)
    bits = {name: int(value) for name, value in re.findall(r"(kOff\w+) = (\d+)", body)}
    assert bits == {"kOffMma": probe.MMA, "kOffCopies": probe.COPIES, "kOffSplit": probe.SPLIT,
                    "kOffWeights": probe.WEIGHTS, "kOffSmallTerms": probe.SMALL_TERMS,
                    "kOffNorm": probe.NORM, "kOffScratch": probe.SCRATCH}
    assert probe.VARIANTS["as committed"] == 0 == probe.SPLIT_VARIANTS["as committed"]
    assert all(0 <= mask < 32 for mask in probe.VARIANTS.values())
    assert all(mask in (0, probe.NORM, probe.NORM | probe.SCRATCH)
               for mask in probe.SPLIT_VARIANTS.values())
    assert not any("CONDMDI_PROBE" in flag for flag in _build.NVCC_FLAGS)
    assert "#define CONDMDI_PROBE_OFF 0" in source


def test_probe_f32_mode_times_the_float32_rows_of_chip_smoke(monkeypatch, tmp_path):
    """`resblock_probe.py f32` runs chip_smoke.py's float32 rows alone: the resblock
    halves of phase 2's forward and of both CLI models, then attention at phase 5's
    and the CLIs' shapes, and writes their sums to chiprun_out/resblock_probe_f32.json.
    Here with stand-ins for the card's timings."""
    import json

    monkeypatch.syspath_prepend(str(_build.PKG_DIR.parent))
    import chip_smoke as cs
    import resblock_probe as probe

    seen = []

    def rows(name, shapes, B, dev):
        seen.append((name, B, shapes))
        return dict(rows=[{"model": name}], halves=33, ms=1.0, plain_ms=2.0, library_ms=3.0,
                    bound_ms=0.1, host_ms_per_call=0.03)

    def attention_rows(dev, cases):
        return [dict(shape=c[0], route="wgmma_f32", ms=0.01, plain_ms=0.05, library_ms=0.03,
                     bound_ms=0.002, host_ms=0.03) for c in cases]

    monkeypatch.setattr(cs, "ROOT", tmp_path)
    monkeypatch.setattr(cs, "f32_resblock_rows", rows)
    monkeypatch.setattr(cs, "f32_attention_rows", attention_rows)
    monkeypatch.setattr(cs, "main_path_shapes", lambda dev: "phase 2's shapes")
    monkeypatch.setattr(cs, "cli_resblock_shapes", lambda argv, B, dev: (None, f"{B}", None))
    monkeypatch.setattr(cs, "card_line", lambda: "a card, 700.00 W")
    probe.f32("cpu")
    assert seen == [("UNet-XL pad 200", 8, "phase 2's shapes"),
                    ("gate UNet", 2 * cs.CLI_SAMPLES, str(2 * cs.CLI_SAMPLES)),
                    ("UNet-XL pad 224", 2 * cs.XL_CLI_SAMPLES, str(2 * cs.XL_CLI_SAMPLES))]
    out = json.loads((tmp_path / "chiprun_out" / "resblock_probe_f32.json").read_text())
    assert out["card"] == "a card, 700.00 W"
    assert set(out["f32_resblock_ms"]) == {"UNet-XL pad 200", "gate UNet", "UNet-XL pad 224"}
    assert list(out["f32_attention_ms"]) == [c[0] for c in cs.ATTN_SHAPES + cs.CLI_ATTENTION]
    assert "edit" in out["f32_attention_ms"] and "synthesize" in out["f32_attention_ms"]
