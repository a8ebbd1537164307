"""The port's attention (condmdi_tpu_torch/ops/attention.py) against the JAX
package's, on the CPU: the plain version against JAX's `_xla_attention` (self,
cross and causal) and against the Pallas kernel in interpret mode; the
recompute backward against `jax.vjp`; the dispatch, which on the CPU never
builds or launches a kernel; the choice between the Hopper kernels, which is a
function of the shape and the type; and the streaming route's pack pass
(`pack_heads`). The kernels themselves are held to the plain version on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from condmdi_tpu.ops import attention as jax_attention
from condmdi_tpu_torch.ops import _build, attention

ATOL = 1e-5  # float32 on both sides; only summation order differs


def make_qkv(B, Tq, Tk, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Tq, D), (B, Tk, D), (B, Tk, D))]


@pytest.mark.parametrize("case", [
    # (B, Tq, Tk, D, H, causal): self-attention at the MDM sequence length,
    # cross-attention to the one conditioning token, causal self-attention
    (2, 197, 197, 64, 4, False),
    (3, 30, 1, 64, 4, False),
    (2, 23, 23, 48, 3, True),
], ids=["self", "cross", "causal"])
def test_plain_matches_jax_xla_attention(case):
    B, Tq, Tk, D, H, causal = case
    q, k, v = make_qkv(B, Tq, Tk, D)
    want = np.asarray(jax_attention._xla_attention(
        *(jnp.asarray(a) for a in (q, k, v)), num_heads=H, causal=causal))
    got = attention._xla_attention(*(torch.from_numpy(a) for a in (q, k, v)), H,
                                   causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("T", [197, 25])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(T):
    """T=197 is the MDM encoder's sequence (196 frames + the cond token); T=25
    is ragged against the kernel's 128-row tiles."""
    q, k, v = make_qkv(2, T, T, 64, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_attention._pallas_self_attention(
            *(jnp.asarray(a) for a in (q, k, v)), num_heads=4))
    got = attention._xla_attention(*(torch.from_numpy(a) for a in (q, k, v)), 4).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)  # the tolerance of the JAX test


# the shapes the streaming route took over from refusals and from the first tiled
# kernel: head widths below a chunk (4), between chunks (20), a whole column block
# (256) and past it (320); one row, MDM's 225 and one past a 512-key sequence
STREAM_HEAD_DIMS = [4, 20, 256, 320]
STREAM_LENGTHS = [1, 225, 513]


@pytest.mark.parametrize("hd", STREAM_HEAD_DIMS)
@pytest.mark.parametrize("T", STREAM_LENGTHS)
def test_plain_matches_jax_xla_attention_at_the_stream_shapes(hd, T):
    q, k, v = make_qkv(1, T, T, 2 * hd, seed=hd + T)
    want = np.asarray(jax_attention._xla_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                                    num_heads=2))
    got = attention._xla_attention(*(torch.from_numpy(a) for a in (q, k, v)), 2).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hd", STREAM_HEAD_DIMS)
@pytest.mark.parametrize("T", STREAM_LENGTHS)
def test_plain_matches_the_pallas_kernel_at_the_stream_shapes(hd, T):
    """The Pallas kernel pads T and hd to multiples of 128 and so takes every
    shape; the port's plain version, which the card holds its kernel to, agrees."""
    q, k, v = make_qkv(1, T, T, 2 * hd, seed=3 * hd + T)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_attention._pallas_self_attention(
            *(jnp.asarray(a) for a in (q, k, v)), num_heads=2))
    got = attention._xla_attention(*(torch.from_numpy(a) for a in (q, k, v)), 2).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)  # the tolerance of the JAX test


@pytest.mark.parametrize("B,T,D,H", [(2, 61, 64, 4), (3, 17, 4, 4), (1, 225, 512, 4),
                                     (2, 33, 1280, 4), (2, 16, 96, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_heads_layout(B, T, D, H, dtype):
    """pack_heads: [3, P, B*H, t16, hd16] bf16, head-major, zero past T and past
    hd; P = 2 (hi, lo) for float32 with hi + lo within 2^-16 of each value
    (relative), P = 1 for bfloat16 with the values themselves."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in make_qkv(B, T, T, D, seed=T + D))
    hd = D // H
    planes = attention.pack_heads(q, k, v, H)
    P = 2 if dtype == torch.float32 else 1
    t16, hd16 = -(-T // 16) * 16, -(-hd // 16) * 16
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, P, B * H, t16, hd16)
    assert not planes[..., T:, :].any() and not planes[..., :, hd:].any()
    for i, x in enumerate((q, k, v)):
        heads = x.reshape(B, T, H, hd).transpose(1, 2).reshape(B * H, T, hd)
        got = planes[i, :, :, :T, :hd].float()
        if P == 1:
            assert torch.equal(got[0], heads.float())
        else:
            hi, lo = got
            assert torch.equal(planes[i, 0, :, :T, :hd], heads.bfloat16())
            err = (hi + lo - heads).abs()
            assert torch.all(err <= 2.0 ** -16 * heads.abs())


def test_stream_reads_in_place_only_what_tma_can_address():
    """The streaming route skips its pack pass for column views whose heads a TMA
    box never crosses (hd 16, 32 or a multiple of 64; in float32 up to 512, where
    the kernel splits the tiles itself with Q resident) and whose rows are
    16-byte aligned."""
    def views(D, dtype=torch.bfloat16, shift=0):
        buf = torch.zeros(2, 5, 3 * D + shift, dtype=dtype)
        return buf[..., shift:].chunk(3, dim=-1)

    assert attention.stream_reads_in_place(*views(1024), 256)
    assert attention.stream_reads_in_place(*views(64), 16)
    assert attention.stream_reads_in_place(*views(128), 32)
    assert not attention.stream_reads_in_place(*views(16), 4)          # hd 4: packed
    assert not attention.stream_reads_in_place(*views(320), 80)        # chunks cross heads
    assert not attention.stream_reads_in_place(*views(1024, shift=1), 256)  # unaligned rows
    assert attention.stream_reads_in_place(*views(1024, torch.float32), 256)
    assert attention.stream_reads_in_place(*views(64, torch.float32), 16)
    assert not attention.stream_reads_in_place(*views(16, torch.float32), 4)
    assert not attention.stream_reads_in_place(*views(2304, torch.float32), 576)  # Q not resident
    assert not attention.stream_reads_in_place(*views(1024, torch.float32, shift=2), 256)


def test_backward_formula_matches_jax_vjp():
    q, k, v = make_qkv(2, 19, 19, 32, seed=2)
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention._xla_attention(a, b, c, num_heads=4),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = attention._fused_bwd(4, *(torch.from_numpy(a) for a in (q, k, v, g)))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=ATOL, rtol=0)


def test_autograd_function_on_cpu_is_plain_forward_and_recompute_backward():
    """`fused_self_attention` on CPU tensors: the plain forward, the JAX
    package's backward formula, no launch; its gradients equal autograd's
    through the plain version."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in make_qkv(2, 17, 17, 32, 4))
    before = attention.fused_self_attention.launches
    out = attention.fused_self_attention.apply(q, k, v, 4)
    (out.sin().sum()).backward()
    assert attention.fused_self_attention.launches == before
    refs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref = attention._xla_attention(*refs, 4)
    ref.sin().sum().backward()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    for got, want in zip((q, k, v), refs):
        torch.testing.assert_close(got.grad, want.grad, atol=ATOL, rtol=0)


def _no_build():
    raise AssertionError("a CPU tensor reached the kernel build")


def test_mha_on_the_cpu_never_touches_the_build(monkeypatch):
    monkeypatch.setattr(_build, "load_attention", _no_build)
    monkeypatch.setattr(attention, "_launch", lambda *a: _no_build())
    q, k, v = (torch.from_numpy(a) for a in make_qkv(2, 9, 9, 16, 5))
    before = attention.fused_self_attention.launches
    out = attention.multihead_attention(torch.cat([q, k, v], dim=-1), 2)
    cross = attention.mha(q, k[:, :1], v[:, :1], 2)
    assert out.shape == (2, 9, 16) and cross.shape == (2, 9, 16)
    torch.testing.assert_close(out, attention._xla_attention(q, k, v, 2), atol=0, rtol=0)
    assert attention.fused_self_attention.launches == before


def test_card_path_raises_when_the_kernel_cannot_be_built(monkeypatch, tmp_path):
    """`_launch`, what a CUDA tensor reaches, raises when nvcc is missing and
    never takes the plain version."""
    def never_plain(*_a, **_k):
        raise AssertionError("the card path fell back to the plain version")

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(attention, "_xla_attention", never_plain)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    q, k, v = torch.zeros(3, 2, 5, 64).unbind(0)
    before = attention.fused_self_attention.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        attention._launch(q, k, v, 4)
    assert attention.fused_self_attention.launches == before


class _BuildReached(Exception):
    pass


@pytest.mark.parametrize("bad", ["head_dim", "head_dim_wide", "unaligned_rows", "heads", "dtype",
                                 "mismatch", "shape"])
def test_card_path_rejects_what_the_kernel_does_not_take(bad, monkeypatch):
    """`_launch` refuses before any build what JAX's reshape refuses too (D not a
    multiple of H), a type the kernels do not take and mismatched q, k, v. Head
    widths it refused before the streaming route (hd 4, not a multiple of 8; hd
    256, past 128) and rows that are not 16-byte aligned are taken: the call
    reaches the build (here a sentinel) and never the plain version."""
    def never_plain(*_a, **_k):
        raise AssertionError("the card path fell back to the plain version")

    def sentinel():
        raise _BuildReached

    monkeypatch.setattr(attention, "_xla_attention", never_plain)
    monkeypatch.setattr(_build, "load_attention", sentinel)
    q = k = v = torch.zeros(2, 5, 64)
    H = 4
    taken = bad in ("head_dim", "head_dim_wide", "unaligned_rows")
    if bad == "head_dim":
        H = 16  # hd = 4, not a multiple of 8
    elif bad == "head_dim_wide":
        q = k = v = torch.zeros(2, 5, 512)
        H = 2  # hd = 256 > 128
    elif bad == "unaligned_rows":  # a bf16 projection one column longer, views one column in
        q, k, v = torch.zeros(2, 5, 3 * 64 + 1, dtype=torch.bfloat16)[..., 1:].chunk(3, dim=-1)
        assert (q.data_ptr() % 16) and (q.stride(1) * 2) % 16
    elif bad == "heads":
        H = 5
    elif bad == "dtype":
        q = k = v = q.double()
    elif bad == "mismatch":
        k = k.bfloat16()
    else:
        k = torch.zeros(2, 6, 64)
    before = attention.fused_self_attention.launches
    with pytest.raises(_BuildReached if taken else (ValueError, TypeError, NotImplementedError)):
        attention._launch(q, k, v, H)
    assert attention.fused_self_attention.launches == before


def test_other_devices_raise():
    q = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        attention.fused_self_attention.apply(q, q, q, 2)


@pytest.mark.parametrize("case", [
    # (B, T, H, hd, dtype, route)
    (8, 197, 4, 128, torch.bfloat16, "wgmma"),     # MDM as served
    (128, 197, 4, 128, torch.bfloat16, "wgmma"),   # the evaluation batch
    (8, 196, 4, 128, torch.bfloat16, "wgmma"),     # DiT / trans_dec
    (3, 25, 2, 64, torch.bfloat16, "wgmma"),
    (2, 7, 2, 32, torch.bfloat16, "wgmma"),
    (1, 448, 1, 128, torch.bfloat16, "wgmma"),     # the longest K and V that fit at hd 128 ...
    (1, 449, 1, 128, torch.bfloat16, "stream"),    # ... and one row more
    (1, 896, 1, 64, torch.bfloat16, "wgmma"),
    (1, 897, 1, 64, torch.bfloat16, "stream"),
    (1, 1792, 1, 32, torch.bfloat16, "wgmma"),
    (1, 1793, 1, 32, torch.bfloat16, "stream"),
    (2, 70, 4, 24, torch.bfloat16, "stream"),      # a width the resident kernel is not built for
    (2, 70, 4, 16, torch.bfloat16, "stream"),
    (2, 70, 1, 96, torch.bfloat16, "stream"),
    (8, 197, 4, 4, torch.bfloat16, "stream"),      # --latent_dim 16
    (8, 197, 4, 256, torch.bfloat16, "stream"),    # --latent_dim 1024
    (8, 512, 4, 128, torch.bfloat16, "stream"),    # served MDM past T = 448
    (8, 197, 4, 128, torch.float32, "wgmma_f32"),  # float32: hi and lo planes resident
    (4, 197, 4, 128, torch.float32, "wgmma_f32"),  # MDM edit (B=4) as the CLI runs it
    (3, 25, 2, 64, torch.float32, "wgmma_f32"),
    (2, 7, 2, 32, torch.float32, "wgmma_f32"),
    (1, 224, 1, 128, torch.float32, "wgmma_f32"),  # the longest hi+lo K and V at hd 128 ...
    (1, 225, 1, 128, torch.float32, "stream"),     # ... and one row more
    (4, 225, 4, 128, torch.float32, "stream"),     # MDM at 224 frames + the cond token
    (1, 448, 1, 64, torch.float32, "wgmma_f32"),
    (1, 449, 1, 64, torch.float32, "stream"),
    (1, 896, 1, 32, torch.float32, "wgmma_f32"),
    (1, 897, 1, 32, torch.float32, "stream"),
    (2, 70, 4, 24, torch.float32, "stream"),       # a width the resident kernel is not built for
    (2, 70, 1, 96, torch.float32, "stream"),
    (32, 61, 4, 16, torch.float32, "stream"),      # evals.run_a2m at the JAX CLIs' width
    (8, 197, 4, 4, torch.float32, "stream"),
    (2, 197, 4, 320, torch.float32, "stream"),     # more columns than one block holds
])
def test_route_is_a_function_of_shape_and_dtype(case):
    B, T, H, hd, dtype, route = case
    assert attention.attention_route(B, T, H, hd, dtype) == route
    # neither the batch nor the number of heads moves it
    assert attention.attention_route(1, T, 1, hd, dtype) == route
    assert attention.attention_route(4096, T, 64, hd, dtype) == route


@pytest.mark.parametrize("T,hd", [(197, 128), (448, 128), (16, 32), (7, 64), (896, 64), (1792, 32)])
def test_resident_route_fits_a_blocks_shared_memory(T, hd):
    """What routes to the resident kernel fits the 227 KB a block may use, with
    K and V of one head side by side, rows padded to 16; at the served shape two
    such CTAs fit one SM (228 KB, 1 KB reserved for each)."""
    need = attention.resident_smem_bytes(T, hd)
    rows = 16 * -(-T // 16)
    one = rows * hd * 2  # K, or V
    assert need >= 2 * one + 32 * 8
    assert need <= 232448 - 1024
    # the scores of the last key tile read 64 rows of each column group of K,
    # however few the tile has: what they read past K must lie inside V
    last_rows = rows - 64 * (-(-T // 64) - 1)
    assert one + (64 - last_rows) * min(hd, 64) * 2 <= need - 32 * 8
    if (T, hd) == (197, 128):
        assert 2 * (need + 1024) <= 228 * 1024


def test_the_kernels_build_for_sm90a_against_the_runtime_alone():
    """wgmma and setmaxnreg need the `a` target; the tensor-map encoder is taken
    through the runtime at run time, so nothing links against libcuda itself."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert "-lcuda" not in _build.NVCC_FLAGS
    source = (_build.CSRC_DIR / "attention.cu").read_text()
    assert "cudaGetDriverEntryPoint" in source and "cuTensorMapEncodeTiled" in source
    assert 'extern "C" int condmdi_attention_forward' in source


def test_card_path_names_the_route_when_a_launch_fails(monkeypatch):
    """A launch that the C entry refuses raises with the route in the message,
    counts nothing and never takes the plain version."""
    class Refusing:
        @staticmethod
        def condmdi_attention_forward(*args):
            Refusing.args = args
            return 1

        @staticmethod
        def condmdi_error_string(err):
            return b"invalid argument"

    def never_plain(*_a, **_k):
        raise AssertionError("the card path fell back to the plain version")

    monkeypatch.setattr(_build, "load_attention", lambda: Refusing)
    monkeypatch.setattr(attention, "_xla_attention", never_plain)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    qkv = torch.zeros(2, 70, 3 * 256, dtype=torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    before = attention.fused_self_attention.launches
    with pytest.raises(RuntimeError, match="route wgmma"):
        attention._launch(q, k, v, 2)
    assert attention.fused_self_attention.launches == before
    # the views went over as they lie: pointers 2 * 256 bytes apart, the projection's strides
    args = Refusing.args
    assert args[1] - args[0] == args[2] - args[1] == 2 * 256
    assert args[4:10] == (2, 70, 2, 128, 70 * 768, 768)
    assert args[10:] == (1, 1, 0, None)  # bfloat16, the wgmma route, the stream, no scratch


def test_float32_route_hands_the_entry_point_its_planes(monkeypatch):
    """The float32 route ("wgmma_f32") allocates the hi and lo bf16 planes of q, k
    and v ([3, 2, B, T, D]) and passes them to the C entry as its scratch; a
    refused launch raises with the route's name, counts nothing and never takes
    the plain version."""
    class Refusing:
        @staticmethod
        def condmdi_attention_forward(*args):
            Refusing.args = args
            return 1

        @staticmethod
        def condmdi_error_string(err):
            return b"invalid argument"

    def never_plain(*_a, **_k):
        raise AssertionError("the card path fell back to the plain version")

    allocated = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append(t)
        return t

    monkeypatch.setattr(_build, "load_attention", lambda: Refusing)
    monkeypatch.setattr(attention, "_xla_attention", never_plain)
    monkeypatch.setattr(attention.torch, "empty", recording_empty)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    q, k, v = torch.zeros(4, 197, 3 * 512).chunk(3, dim=-1)
    before = attention.fused_self_attention.launches
    with pytest.raises(RuntimeError, match="route wgmma_f32"):
        attention._launch(q, k, v, 4)
    assert attention.fused_self_attention.launches == before
    args = Refusing.args
    assert args[4:13] == (4, 197, 4, 128, 197 * 1536, 1536, 0, 2, 0)  # float32, route 2
    planes = next(t for t in allocated if t.dtype == torch.bfloat16)
    assert planes.shape == (3, 2, 4, 197, 512) and args[13] == planes.data_ptr()


@pytest.mark.parametrize("case", [
    # (B, T, D, H, dtype, the call's route): DiT-XL/2 (hd 72) under CFG, where the
    # resident kernels are not built for the width and TMA cannot address a head in
    # place; MDM's cells (hd 128) in bf16 and float32; a width TMA reads in place
    (64, 196, 1152, 16, torch.bfloat16, "stream_packed"),
    (64, 197, 512, 4, torch.bfloat16, "wgmma"),
    (64, 197, 512, 4, torch.float32, "wgmma_f32"),
    (2, 197, 1024, 4, torch.bfloat16, "stream"),
    (2, 197, 16, 4, torch.bfloat16, "stream_packed"),
], ids=["dit_xl", "mdm_serve", "mdm_offline_f32", "hd256_in_place", "hd4"])
def test_route_counts_name_the_route_each_call_took(case, monkeypatch):
    """`fused_self_attention.routes` counts each launch under its route, the
    streaming route split by whether the pack pass ran; the launch counter moves
    with it. The C entry is a stand-in that accepts the launch (and says float32
    needs no pack pass where q, k, v are read in place)."""
    B, T, D, H, dtype, taken = case

    class Accepting:
        condmdi_attention_forward = staticmethod(lambda *args: 0)
        condmdi_attention_stream_packs = staticmethod(lambda *args: 0)

    monkeypatch.setattr(_build, "load_attention", lambda: Accepting)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    q, k, v = torch.zeros(B, T, 3 * D, dtype=dtype).chunk(3, dim=-1)  # the models' qkv views
    hd = D // H
    assert attention.attention_route(B, T, H, hd, dtype) == taken.replace("_packed", "")
    if taken.startswith("stream"):
        assert attention.stream_reads_in_place(q, k, v, hd) == (taken == "stream")
    routes, launches = dict(attention.fused_self_attention.routes), \
        attention.fused_self_attention.launches
    attention._launch(q, k, v, H)
    gained = {r: n - routes[r] for r, n in attention.fused_self_attention.routes.items()}
    assert gained == {r: int(r == taken) for r in ("wgmma", "wgmma_f32", "stream",
                                                   "stream_packed")}
    assert attention.fused_self_attention.launches == launches + 1


def test_cpu_calls_count_no_route():
    """A CPU tensor takes the plain version and counts no route."""
    routes = dict(attention.fused_self_attention.routes)
    q, k, v = torch.randn(2, 20, 3 * 72).chunk(3, dim=-1)
    attention.mha(q, k, v, 1)
    assert attention.fused_self_attention.routes == routes


def test_probe_switches_are_the_sources_and_the_package_builds_without_them(monkeypatch):
    """attention_probe.py names the parts of the resident kernel it switches off
    by the bits of csrc/attention.cu `ProbeOff`; the package's own build passes
    no probe macro, so its library is the kernel as written."""
    import re

    monkeypatch.syspath_prepend(str(_build.PKG_DIR.parent))
    import attention_probe as probe

    source = (_build.CSRC_DIR / "attention.cu").read_text()
    body = re.search(r"enum ProbeOff \{(.*?)\};", source, re.S).group(1)
    bits = {name: int(value) for name, value in re.findall(r"(kOff\w+) = (\d+)", body)}
    assert bits == {"kOffScores": probe.SCORES, "kOffPv": probe.PV, "kOffSoftmax": probe.SOFTMAX,
                    "kOffStores": probe.STORES, "kOffQ": probe.Q_LOADS, "kOffSlack": probe.SLACK,
                    "kOffSecondCta": probe.SECOND_CTA, "kOffF32Route": probe.F32_STREAM,
                    "kOffPdl": probe.NO_PDL}
    assert sorted(bits.values()) == [1, 2, 4, 8, 16, 32, 64, 128, 256]
    assert probe.VARIANTS["as committed"] == 0
    assert all(0 <= mask < 128 for mask in probe.VARIANTS.values())
    assert not any("CONDMDI_PROBE" in flag for flag in _build.NVCC_FLAGS)
    assert "#define CONDMDI_PROBE_OFF 0" in source


def test_entry_point_has_one_route_function():
    """The C entry decides the route in `route_of` alone: it is what the exported
    `condmdi_attention_route` returns and what `condmdi_attention_forward` holds
    the caller's route against, and the binding declares both."""
    source = (_build.CSRC_DIR / "attention.cu").read_text()
    assert source.count("int route_of(int t_len, int head_dim, int dtype)") == 1
    assert "return route_of(t_len, head_dim, dtype);" in source
    assert "route != route_of(t_len, head_dim, dtype)" in source

    class Lib:
        class _Fn:
            pass
        condmdi_attention_forward, condmdi_attention_route, condmdi_error_string = _Fn(), _Fn(), _Fn()
        condmdi_attention_pack, condmdi_attention_stream_plan = _Fn(), _Fn()
        condmdi_attention_stream_packs = _Fn()

    _build._bind_attention(Lib)
    assert len(Lib.condmdi_attention_forward.argtypes) == 14
    assert len(Lib.condmdi_attention_route.argtypes) == 3
    assert len(Lib.condmdi_attention_pack.argtypes) == 12
    assert "stream::launch(q, k, v, out, scratch," in source
