"""The Hopper kernels of condmdi_tpu_torch against their plain versions, on a card.

Every test here is marked `cuda` and skips where there is no GPU. The file
imports torch and the port only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from condmdi_tpu_torch.ops import attention, resblock

BF16_TOL = 2.0 ** -7  # |kernel - plain| <= tol * (1 + |plain|): ~2 bf16 ulps
F32_TOL = 5e-4        # the kernels' hi+lo bf16 split keeps ~16 mantissa bits


@pytest.fixture
def cuda_device():
    """The card; the tests skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(B, T, cin, cout, adagn, res, dtype, device, seed=3):
    rng = np.random.default_rng(seed)

    def rnd(shape, s=1.0, offset=0.0):
        a = (offset + s * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(device, dtype)

    args = [rnd((B, T, cin)), rnd((cout, cin, 5), (cin * 5) ** -0.5),
            rnd((cout,), 0.1), rnd((cout,), 0.1, 1.0), rnd((cout,), 0.1)]
    kw = {}
    if adagn:
        cond = rnd((B, 2 * cout), 0.2)  # strided views, as the UNet passes them
        kw["scale"], kw["shift"] = cond[:, :cout], cond[:, cout:]
    if res:
        kw["res"] = rnd((B, T, cout))
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", [
    # (B, T, Cin, Cout, adagn, res): UNet-XL resblock shapes at pad 200, and a
    # small ragged one (group width 8, Cin not a multiple of the chunk, odd T)
    (8, 200, 526, 1024, True, False),
    (8, 100, 2048, 1024, True, False),
    (8, 25, 1024, 1024, False, True),
    (8, 200, 1024, 1024, False, False),
    (3, 17, 40, 64, True, True),
])
def test_kernel_matches_plain(cuda_device, dtype, case):
    B, T, cin, cout, adagn, res = case
    dt = getattr(torch, dtype)
    args, kw = make_inputs(B, T, cin, cout, adagn, res, dt, cuda_device)
    before = resblock.fused_conv_gn_mish.launches
    with torch.no_grad():
        got = resblock.fused_conv_gn_mish(*args, **kw).float()
        torch.cuda.synchronize()
        want = resblock.reference_conv_gn_mish(*args, **kw).float()
    assert resblock.fused_conv_gn_mish.launches == before + 1
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    assert torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= tol * (1 + want.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("T", [7, 25, 50, 100, 196, 197, 200, 260])
@pytest.mark.parametrize("adagn,res", [(True, False), (False, True), (False, False), (True, True)])
def test_kernel_matches_plain_over_lengths_and_batches(cuda_device, dtype, B, T, adagn, res):
    """Both tilings of the bf16 kernel (64-row tiles with the cluster split along
    the group's 128 channels, 128-row tiles with the cluster split along T), a
    Cin that is no multiple of the 32-channel chunk, and the float32 kernel at
    the same shapes."""
    cin, cout, groups = 72, 256, 2
    dt = getattr(torch, dtype)
    args, kw = make_inputs(B, T, cin, cout, adagn, res, dt, cuda_device, seed=T + B)
    with torch.no_grad():
        got = resblock.fused_conv_gn_mish(*args, **kw, n_groups=groups).float()
        torch.cuda.synchronize()
        want = resblock.reference_conv_gn_mish(*args, **kw, n_groups=groups).float()
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    assert torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= tol * (1 + want.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_ignores_alignment_channels(cuda_device, dtype):
    """x may carry trailing channels up to the next multiple of 8 (526 -> 528)."""
    dt = getattr(torch, dtype)
    args, kw = make_inputs(2, 40, 526, 256, True, False, dt, cuda_device)
    x_padded = torch.cat([args[0], torch.full_like(args[0][..., :2], 7.0)], dim=-1)
    with torch.no_grad():
        got = resblock.fused_conv_gn_mish(x_padded, *args[1:], **kw).float()
        want = resblock.reference_conv_gn_mish(*args, **kw).float()
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    assert torch.all((got - want).abs() <= tol * (1 + want.abs()))


@pytest.mark.cuda
def test_module_output_follows_its_weight(cuda_device):
    """The cached packed weight of a block is remade when the weight changes."""
    from condmdi_tpu_torch.models.layers import init_params
    from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock

    block = init_params(Conv1dAdaGNBlock(64, 128, device=cuda_device), 0).to(torch.bfloat16)
    args, kw = make_inputs(2, 50, 64, 128, True, False, torch.bfloat16, cuda_device)

    def both():
        with torch.no_grad():
            got = block(args[0], kw["scale"], kw["shift"]).float()
            want = resblock.reference_conv_gn_mish(
                args[0], block.conv.weight, block.conv.bias, block.norm.weight,
                block.norm.bias, **kw).float()
        assert torch.all((got - want).abs() <= BF16_TOL * (1 + want.abs()))
        return got

    first = both()
    with torch.no_grad():
        block.conv.weight.mul_(-1.5)
    second = both()
    assert (first - second).abs().max() > 0.1
    block.load_state_dict({k: torch.randn_like(v) * 0.05 for k, v in block.state_dict().items()})
    both()


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["long_T_bf16", "long_T_f32", "group_width", "taps"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda_device, bad):
    B, T, cin, cout, dt = 1, 16, 16, 64, torch.bfloat16
    if bad == "long_T_bf16":
        T = 1025  # nine 128-row tiles: more than one cluster holds
    elif bad == "long_T_f32":
        T, dt = 1025, torch.float32  # nine 128-row tiles: more than one cluster holds
    elif bad == "group_width":
        cout = 8 * 136
    args, kw = make_inputs(B, T, cin, cout, False, False, dt, cuda_device)
    if bad == "taps":
        args[1] = args[1][..., :3].contiguous()
    before = resblock.fused_conv_gn_mish.launches
    with torch.no_grad(), pytest.raises(NotImplementedError):
        resblock.fused_conv_gn_mish(*args, **kw)
    assert resblock.fused_conv_gn_mish.launches == before


GRAD_TOL = 1e-5  # |kernel path - plain path| <= tol * (1 + |plain|) for a gradient


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, T, Cin, x channels, Cout, adagn, res): UNet-XL resblock halves at pad 200, f32
    (2, 200, 526, 528, 1024, True, False),
    (2, 100, 2048, 2048, 1024, True, False),
    (2, 25, 1024, 1024, 1024, False, True),
    # the conditional CLI's UNet-XL at pad 224, B=4 (two channel tiles a group, 64-row tiles)
    (4, 224, 526, 528, 1024, True, False),
    (4, 28, 2048, 2048, 1024, True, False),
])
def test_kernel_gradients_match_plain(cuda_device, case):
    """Under autograd the half goes through ConvGnMish: the kernel forward, a
    backward that recomputes the plain version. Every input's gradient equals
    plain autograd's (the same recompute, so only cuDNN's choice of algorithms
    between the two runs can move them)."""
    B, T, cin, xc, cout, adagn, res = case
    args, kw = make_inputs(B, T, cin, cout, adagn, res, torch.float32, cuda_device)
    args[0] = torch.nn.functional.pad(args[0], (0, xc - cin))
    leaves = [*args, *kw.values()]
    probe = torch.randn((B, T, cout), device=cuda_device)

    def grads(fn):
        inputs = [t.detach().clone().requires_grad_(True) for t in leaves]
        out = fn(*inputs[:5], **dict(zip(kw, inputs[5:])))
        return out, torch.autograd.grad((out * probe).sum(), inputs)

    before = resblock.fused_conv_gn_mish.launches
    got_out, got = grads(resblock.fused_conv_gn_mish)
    assert resblock.fused_conv_gn_mish.launches == before + 1
    want_out, want = grads(resblock.reference_conv_gn_mish)
    assert torch.all((got_out - want_out).abs() <= F32_TOL * (1 + want_out.abs()))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.all((g - w).abs() <= GRAD_TOL * (1 + w.abs()))


def qkv_views(B, T, D, dtype, device, seed=5):
    """q, k, v as the three column views of one [B, T, 3D] projection, as on the path."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * D)).astype(np.float32))
    return qkv.to(device, dtype).chunk(3, dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", [
    # (B, T, D, H): the MDM served shape (T = 196 frames + the cond token),
    # DiT / trans_dec (T = 196), a ragged one (hd 64, one key tile), T < 16,
    # and an hd that is a multiple of 8 but not of 16
    (8, 197, 512, 4),
    (8, 196, 512, 4),
    (3, 25, 128, 2),
    (2, 7, 64, 2),
    (2, 70, 96, 4),
])
def test_attention_kernel_matches_plain(cuda_device, dtype, case):
    B, T, D, H = case
    dt = getattr(torch, dtype)
    q, k, v = qkv_views(B, T, D, dt, cuda_device)
    before = attention.fused_self_attention.launches
    with torch.no_grad():
        got = attention.mha(q, k, v, H).float()
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H).float()
    assert attention.fused_self_attention.launches == before + 1
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    assert got.shape == (B, T, D) and torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= tol * (1 + want.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("T", [7, 25, 50, 100, 196, 197, 200])
@pytest.mark.parametrize("D,H", [(512, 4), (96, 4)])
def test_attention_kernel_over_lengths_and_batches(cuda_device, dtype, B, T, D, H):
    """One to four key tiles with a ragged last one, the served head width and one
    that is a multiple of 8 but not of 16."""
    dt = getattr(torch, dtype)
    q, k, v = qkv_views(B, T, D, dt, cuda_device, seed=T + B)
    with torch.no_grad():
        got = attention.mha(q, k, v, H).float()
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H).float()
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    assert torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= tol * (1 + want.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [100, 197, 300, 448])
@pytest.mark.parametrize("B", [40, 70])
def test_attention_kernel_at_many_heads_and_long_sequences(cuda_device, B, T):
    """More (batch, head) pairs than the card has SMs, and sequences past 256."""
    D, H = 128, 4
    q, k, v = qkv_views(B, T, D, torch.bfloat16, cuda_device)
    with torch.no_grad():
        got = attention.mha(q, k, v, H).float()
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H).float()
    assert torch.all((got - want).abs() <= BF16_TOL * (1 + want.abs()))


def assert_attention_matches_plain(q, k, v, H):
    before = attention.fused_self_attention.launches
    with torch.no_grad():
        got = attention.mha(q, k, v, H).float()
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H).float()
    assert attention.fused_self_attention.launches == before + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= BF16_TOL * (1 + want.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [63, 64, 65, 127, 128, 129, 192, 193, 256])
@pytest.mark.parametrize("D,H", [(256, 2), (128, 2), (64, 2)])
def test_attention_kernel_at_the_tile_edges(cuda_device, T, D, H):
    """bf16 on the resident kernel at head widths 128, 64 and 32: a sequence one
    short of, equal to and one past a multiple of the 64-row tiles."""
    assert attention.attention_route(3, T, H, D // H, torch.bfloat16) == "wgmma"
    assert_attention_matches_plain(*qkv_views(3, T, D, torch.bfloat16, cuda_device, seed=T), H)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H,route", [
    (448, 128, 1, "wgmma"), (449, 128, 1, "mma_sync"),   # hd 128: K and V of 448 rows fit
    (896, 128, 2, "wgmma"), (897, 128, 2, "mma_sync"),   # hd 64
    (200, 96, 4, "mma_sync"), (200, 64, 4, "mma_sync"),  # hd 24 and 16: not a resident width
])
def test_attention_kernel_on_each_side_of_the_route_limit(cuda_device, T, D, H, route):
    assert attention.attention_route(2, T, H, D // H, torch.bfloat16) == route
    assert_attention_matches_plain(*qkv_views(2, T, D, torch.bfloat16, cuda_device), H)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [1, 33, 133, 512])
@pytest.mark.parametrize("T", [65, 197])
def test_attention_kernel_below_and_above_the_cards_sm_count(cuda_device, pairs, T):
    """B*H of 1, 33, 133 and 512 (batch, head) pairs: fewer query tiles than the
    132 SMs hold, and more, where a CTA walks a range of them (heads change
    inside a range, and the ranges' lengths differ by one)."""
    H = 1 if pairs % 2 else 2
    assert_attention_matches_plain(
        *qkv_views(pairs // H, T, 64 * H, torch.bfloat16, cuda_device, seed=pairs), H)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", ["contiguous", "column_views", "offset_16_bytes"])
def test_attention_kernel_reads_q_k_v_where_they_lie(cuda_device, dtype, layout):
    """q, k, v as three contiguous tensors, as the column views of one projection,
    and as views whose first element lies 16 bytes into their buffer's rows."""
    B, T, D, H = 4, 130, 256, 2
    dt = getattr(torch, dtype)
    shift = {"bfloat16": 8, "float32": 4}[dtype] if layout == "offset_16_bytes" else 0
    rng = np.random.default_rng(11)
    buf = torch.from_numpy(rng.standard_normal((B, T, 3 * D + shift)).astype(np.float32))
    q, k, v = buf.to(cuda_device, dt)[..., shift:].chunk(3, dim=-1)
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    else:
        assert q.stride(1) == 3 * D + shift and (q.data_ptr() - buf.data_ptr()) % 16 == 0
    if layout == "offset_16_bytes":
        assert q.storage_offset() * q.element_size() == 16
    before = attention.fused_self_attention.launches
    with torch.no_grad():
        got = attention.mha(q, k, v, H).float()
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H).float()
    assert attention.fused_self_attention.launches == before + 1
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    assert torch.all((got - want).abs() <= tol * (1 + want.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_kernel_replays_inside_a_cuda_graph(cuda_device, dtype):
    """One call of `mha` captured on a side stream and replayed on new contents of
    the same buffers: the launch allocates through torch only, stays on the
    current stream and never synchronises."""
    B, T, D, H = 8, 197, 512, 4
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(21)

    def fresh():
        return torch.from_numpy(rng.standard_normal((B, T, 3 * D)).astype(np.float32)).to(
            cuda_device, dt)

    qkv = fresh()
    q, k, v = qkv.chunk(3, dim=-1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        attention.mha(q, k, v, H)  # the build and the first launch stay outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph, stream=side):
        out = attention.mha(q, k, v, H)
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    for _ in range(2):
        qkv.copy_(fresh())
        graph.replay()
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H).float()
        assert torch.all((out.float() - want).abs() <= tol * (1 + want.abs()))


@pytest.mark.cuda
def test_attention_backward_runs_through_the_kernel_forward(cuda_device):
    """Autograd on the card: the kernel forward, the recompute backward."""
    q, k, v = (t.detach().requires_grad_(True)
               for t in qkv_views(2, 33, 64, torch.float32, cuda_device))
    before = attention.fused_self_attention.launches
    out = attention.mha(q, k, v, 2)
    (out * out).sum().backward()
    assert attention.fused_self_attention.launches == before + 1
    refs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref = attention._xla_attention(*refs, 2)
    (ref * ref).sum().backward()
    for got, want in zip((q, k, v), refs):
        torch.testing.assert_close(got.grad, want.grad, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["head_dim", "dtype_mismatch", "unsupported_dtype"])
def test_attention_wrapper_refuses_what_the_kernel_does_not_take(cuda_device, bad):
    q, k, v = qkv_views(2, 16, 64, torch.bfloat16, cuda_device)
    H = 2
    if bad == "head_dim":
        H = 16  # hd = 4
    elif bad == "dtype_mismatch":
        k = k.float()
    else:
        q, k, v = q.half(), k.half(), v.half()
    before = attention.fused_self_attention.launches
    with pytest.raises((NotImplementedError, TypeError)):
        attention.fused_self_attention.apply(q, k, v, H)
    assert attention.fused_self_attention.launches == before


@pytest.mark.cuda
def test_python_route_is_the_librarys_route(cuda_device):
    """`attention_route` (Python, asked without a card) and csrc/attention.cu
    `route_of` (what the entry point enforces) agree at every head width the
    kernels take, at each T around a tile edge or a shared-memory limit."""
    from condmdi_tpu_torch.ops import _build

    lib = _build.load_attention()
    lengths = sorted({t + d for t in (1, 16, 64, 197, 224, 448, 896, 1792, 2048)
                      for d in (-1, 0, 1) if t + d >= 1})
    for dtype, (code, _) in attention._DTYPES.items():
        for hd in range(8, 129, 8):
            for T in lengths:
                want = lib.condmdi_attention_route(T, hd, code)
                assert attention._ROUTE_CODES[attention.attention_route(1, T, 1, hd, dtype)] == want, \
                    (T, hd, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_entry_point_refuses_a_route_that_is_not_the_shapes(cuda_device, dtype):
    """The library launches nothing when the caller expects the other kernel."""
    from condmdi_tpu_torch.ops import _build

    lib = _build.load_attention()
    dt = getattr(torch, dtype)
    B, T, D, H = 2, 70, 128, 2
    q, k, v = qkv_views(B, T, D, dt, cuda_device)
    out = torch.zeros(B, T, D, device=cuda_device, dtype=dt)
    code = attention._DTYPES[dt][0]
    wrong = (lib.condmdi_attention_route(T, D // H, code) + 1) % 3  # another of the three
    scratch = torch.empty((3, 2, B, T, D), device=cuda_device, dtype=torch.bfloat16)
    err = lib.condmdi_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H, D // H,
        q.stride(0), q.stride(1), code, wrong, torch.cuda.current_stream().cuda_stream,
        scratch.data_ptr())
    torch.cuda.synchronize()
    assert err != 0 and "invalid" in _build.error_string(lib, err)
    assert out.abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,raises", [("bfloat16", False), ("float32", True)])
def test_attention_batch_past_the_grid_limit(cuda_device, dtype, raises):
    """70,000 batch items: the resident kernel numbers its work along grid x and
    takes them (bf16 at hd 32); the tiled kernel (here float32 at hd 24) puts the
    batch in grid z and the wrapper says so before anything is launched. The
    float32 route at hd 32 is held to the same batch in
    test_f32_attention_route_past_the_grid_limit."""
    B, T, D, H = 70_000, 3, 32 if dtype == "bfloat16" else 24, 1
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, T, D, device=cuda_device).to(dt) for _ in range(3))
    if raises:
        before = attention.fused_self_attention.launches
        with pytest.raises(NotImplementedError, match="grid limit"):
            attention.mha(q, k, v, H)
        assert attention.fused_self_attention.launches == before
    else:
        assert_attention_matches_plain(q, k, v, H)


# --------------------------------------------------------------------------- #
# the int8 conv / matmul kernel (csrc/quant.cu)
# --------------------------------------------------------------------------- #
INT8_F32_TOL = 1e-6   # |kernel - plain| <= tol * (1 + |plain|): the sums are exact on both
INT8_BF16_ULP = 2.0 ** -7  # one bfloat16 ulp of |plain| at most


def int8_case(B, T, cin, cout, k, form, dtype, device, xc=None, seed=11):
    """x [B, T, xc >= cin] (zeros past cin), the codes and scales of a [cout, cin, k]
    weight, and the activation scale of `form`: None (dynamic), a scalar below
    the amax (some values clip), or a per-channel vector folded into the codes."""
    from condmdi_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T, cin), generator=gen) * (1 + torch.rand(cin, generator=gen))
    x = torch.nn.functional.pad(x, (0, (xc or cin) - cin))
    w = torch.randn((cout, cin, k), generator=gen) / (cin * k) ** 0.5
    bias = 0.1 * torch.randn(cout, generator=gen)
    a_scale, per_channel = None, False
    if form == "static":
        a_scale = quant.activation_scale(0.8 * x.abs().amax())
    elif form == "per_channel":
        a_scale, per_channel = quant.activation_scale(0.8 * x[..., :cin].abs().amax(dim=(0, 1))), True
        w = w * a_scale[None, :, None]
    wq, w_scale = quant.quantize_weight_per_channel(w)
    dev = dict(device=device)
    return (x.to(device, dtype), wq.to(**dev), w_scale.to(**dev), bias.to(**dev),
            None if a_scale is None else a_scale.to(**dev), per_channel)


def assert_int8_matches_plain(x, wq, w_scale, bias, a_scale, per_channel, stride=1, padding=0):
    from condmdi_tpu_torch.ops import quant

    before = quant.int8_conv1d.launches
    with torch.no_grad():
        got = quant.int8_conv1d(x, wq, w_scale, bias, stride, padding, a_scale,
                                per_channel=per_channel).float()
        torch.cuda.synchronize()
        want = quant.plain_int8_conv1d(x, wq, w_scale, bias, stride, padding, a_scale,
                                       per_channel).float()
    assert quant.int8_conv1d.launches == before + 1
    assert torch.isfinite(got).all() and got.shape == want.shape
    if x.dtype == torch.bfloat16:
        assert torch.all((got - want).abs() <= INT8_BF16_ULP * want.abs())
    else:
        assert torch.all((got - want).abs() <= INT8_F32_TOL * (1 + want.abs()))
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("form", ["dynamic", "static", "per_channel"])
@pytest.mark.parametrize("case", [
    # (B, T, Cin, x channels, Cout, k, stride, padding): the UNet-XL's int8 convs at
    # pad 200 and their edges
    (8, 200, 526, 528, 1024, 5, 1, 2),    # first block: Cin 526 inside a 528-channel buffer
    (8, 200, 526, 528, 1024, 1, 1, 0),    # its residual conv reads the same buffer
    (8, 25, 2048, 2048, 1024, 5, 1, 2),   # the up blocks' Cin 2048 at the deepest level
    (8, 50, 1024, 1024, 1024, 3, 2, 1),   # the last downsample: T' = 25
    (8, 200, 1024, 1024, 263, 1, 1, 0),   # final_conv: Cout 263, masked stores
    (1, 200, 1024, 1024, 1024, 5, 1, 2),  # B = 1
    (128, 25, 1024, 1024, 1024, 5, 1, 2),  # B = 128
    (3, 17, 40, 40, 24, 3, 2, 1),         # K not a multiple of 32, odd T, one partial tile
    (2, 130, 72, 80, 72, 5, 1, 2),        # three row tiles, a partial channel tile
])
def test_int8_kernel_matches_plain(cuda_device, dtype, form, case):
    B, T, cin, xc, cout, k, stride, pad = case
    x, wq, ws, bias, a_scale, pc = int8_case(B, T, cin, cout, k, form, getattr(torch, dtype),
                                             cuda_device, xc)
    assert_int8_matches_plain(x, wq, ws, bias, a_scale, pc, stride, pad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_kernel_reads_a_strided_view(cuda_device, dtype):
    """x as a view into a wider buffer, at an offset of 10 channels: the kernel
    takes its batch and row strides and reads nothing else."""
    x, wq, ws, bias, _, _ = int8_case(4, 60, 40, 32, 5, "dynamic", getattr(torch, dtype),
                                      cuda_device, xc=64)
    view = x[:, :, 10:50]
    assert view.stride(1) == 64
    got, _ = assert_int8_matches_plain(view, wq, ws, bias, None, False, 1, 2)
    want, _ = assert_int8_matches_plain(view.contiguous(), wq, ws, bias, None, False, 1, 2)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_kernel_rounds_ties_to_even(cuda_device, dtype):
    """Activations exactly half way between two codes (a power-of-two scale keeps
    them exact): round half to even, as jnp.round, so every code is even."""
    from condmdi_tpu_torch.ops import quant

    dt = getattr(torch, dtype)
    s = torch.tensor(0.125, device=cuda_device)
    n = torch.arange(-126, 126, device=cuda_device, dtype=torch.float32)
    x = ((n + 0.5) * s).reshape(1, -1, 1).repeat(1, 1, 32).to(dt)  # [1, 252, 32], exact
    wq = torch.ones((8, 32, 1), dtype=torch.int8, device=cuda_device)
    ws = torch.ones(8, device=cuda_device)
    got, want = assert_int8_matches_plain(x, wq, ws, None, s, False)
    assert torch.equal(got, want)
    codes = torch.round(x[0, :, 0].float() / s)
    assert torch.all(codes % 2 == 0) and torch.all((codes - (n + 0.5)).abs() == 0.5)
    assert torch.equal(got[0, :, 0], (32 * codes * s).to(dt).float())
    assert quant.int8_conv1d.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,din,dout", [(8 * 197, 512, 1536), (8 * 197, 1024, 512),
                                           (128 * 197, 512, 1024), (5, 48, 40)])
def test_int8_matmul_matches_plain(cuda_device, dtype, rows, din, dout):
    """MDM's int8 QDense shapes at B = 8 and 128, and a tiny one."""
    from condmdi_tpu_torch.ops import quant

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    dt = getattr(torch, dtype)
    x = torch.randn((rows, din), generator=gen, device=cuda_device).to(dt)
    w = (torch.randn((dout, din), generator=gen, device=cuda_device) / din ** 0.5).to(dt)
    b = (0.1 * torch.randn(dout, generator=gen, device=cuda_device)).to(dt)
    before = quant.int8_conv1d.launches
    with torch.no_grad():
        got = quant.int8_matmul(x, w, b).float()
        torch.cuda.synchronize()
        wq, ws = quant.quantize_weight_per_channel(w)
        want = quant.plain_int8_conv1d(x[None], wq[:, :, None], ws, b)[0].float()
    assert quant.int8_conv1d.launches == before + 1
    tol = INT8_BF16_ULP * want.abs() if dt == torch.bfloat16 else INT8_F32_TOL * (1 + want.abs())
    assert torch.all((got - want).abs() <= tol)


@pytest.mark.cuda
def test_int8_qconv_cache_follows_weight_and_recalibration(cuda_device):
    """A QConv's quantized weight (packed codes, and the per-channel scales folded
    into them) is remade after an in-place weight change and after a
    recalibration; its output keeps to the plain version on the same state."""
    from condmdi_tpu_torch.models.unet import QConv
    from condmdi_tpu_torch.ops import quant

    conv = QConv(96, 64, 5, padding=2, precision_mode="int8_static_pc", device=cuda_device)
    conv.requires_grad_(False)
    torch.nn.init.normal_(conv.weight, std=0.05)
    conv.bias.normal_()
    x = torch.randn((2, 40, 96), device=cuda_device).to(torch.bfloat16)

    def check():
        got = conv(x).float()
        s = quant.activation_scale(conv.amax)
        wq, ws = quant.quantize_weight_per_channel(conv.weight.float() * s[None, :, None])
        want = quant.plain_int8_conv1d(x, wq, ws, conv.bias, 1, 2, s, True).float()
        assert torch.all((got - want).abs() <= INT8_BF16_ULP * want.abs())
        return got

    with torch.no_grad(), quant.calibration(conv):
        conv(x)
    first = check()
    conv.weight.mul_(-1.5)
    second = check()
    with torch.no_grad(), quant.calibration(conv):
        conv(3 * x)  # the running max grows: a recalibration
    third = check()
    assert not torch.equal(first, second) and not torch.equal(second, third)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dynamic", "static", "per_channel"])
@pytest.mark.parametrize("case", [
    # (B, T, Cin, x channels, Cout, k, stride, padding)
    (2, 200, 526, 528, 1024, 5, 1, 2),
    (2, 50, 1024, 1024, 1024, 3, 2, 1),
    (2, 200, 1024, 1024, 263, 1, 1, 0),
])
def test_int8_kernel_gradients_match_plain(cuda_device, form, case):
    """Under autograd the int8 conv goes through Int8Conv1d: the kernel forward,
    a backward that recomputes the plain version; the gradients of x, w_scale,
    bias and a_scale equal plain autograd's: x gets none through the codes, so
    zero for a static or folded scale and the amax term for a dynamic one, as
    in JAX."""
    from condmdi_tpu_torch.ops import quant

    B, T, cin, xc, cout, k, stride, pad = case
    x, wq, ws, bias, a_scale, pc = int8_case(B, T, cin, cout, k, form, torch.float32,
                                             cuda_device, xc)
    leaves = [x, ws, bias] + ([] if a_scale is None else [a_scale])
    t_out = (T + 2 * pad - k) // stride + 1
    probe = torch.randn((B, t_out, cout), device=cuda_device)

    def grads(fn):
        inputs = [t.detach().clone().requires_grad_(True) for t in leaves]
        s = inputs[3] if a_scale is not None else None
        out = fn(inputs[0], wq, inputs[1], inputs[2], stride, pad, s, per_channel=pc)
        # x reaches the plain version's output through no differentiable path
        # where the scale is static: autograd gives None there, the Function zeros
        g = torch.autograd.grad((out * probe).sum(), inputs, allow_unused=True)
        return out, [torch.zeros_like(t) if d is None else d for t, d in zip(inputs, g)]

    before = quant.int8_conv1d.launches
    got_out, got = grads(quant.int8_conv1d)
    assert quant.int8_conv1d.launches == before + 1
    want_out, want = grads(lambda *a, per_channel: quant.plain_int8_conv1d(*a, per_channel))
    assert torch.equal(got_out, want_out)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.all((g - w).abs() <= GRAD_TOL * (1 + w.abs()))
    assert int((got[0] != 0).sum()) == (1 if form == "dynamic" else 0)


def assert_int8_bit_exact(x, wq, w_scale, bias, a_scale, per_channel, stride, padding):
    from condmdi_tpu_torch.ops import quant

    before = quant.int8_conv1d.launches
    with torch.no_grad():
        got = quant.int8_conv1d(x, wq, w_scale, bias, stride, padding, a_scale,
                                per_channel=per_channel)
        torch.cuda.synchronize()
        want = quant.plain_int8_conv1d(x, wq, w_scale, bias, stride, padding, a_scale,
                                       per_channel)
    assert quant.int8_conv1d.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    return got


def sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("form", ["dynamic", "static", "per_channel"])
@pytest.mark.parametrize("case", [
    # (B, T, Cin, x channels, Cout, k, stride, padding): the edges of the
    # batch-folded design. B = 1 and 3; T' no multiple of the 128-row tile; tiles
    # that span batch items at stride 1 (T + 4 halo rows = 54 a batch item) and at
    # stride 2 (101 row pairs an item); Cin 526 inside a 528 buffer; Cout 263;
    # every k
    (1, 200, 1024, 1024, 1024, 5, 1, 2),
    (3, 200, 1024, 1024, 1024, 5, 1, 2),
    (3, 50, 1024, 1024, 1024, 5, 1, 2),
    (3, 200, 1024, 1024, 1024, 3, 2, 1),
    (5, 77, 256, 256, 192, 3, 2, 1),
    (3, 130, 526, 528, 1024, 5, 1, 2),
    (3, 130, 526, 528, 1024, 1, 1, 0),
    (3, 199, 1024, 1024, 263, 1, 1, 0),
    (2, 9, 40, 40, 24, 3, 1, 1),
    (2, 9, 40, 40, 24, 5, 2, 2),
])
def test_int8_kernel_is_bit_exact_at_the_tile_edges(cuda_device, dtype, form, case):
    B, T, cin, xc, cout, k, stride, pad = case
    x, wq, ws, bias, a_scale, pc = int8_case(B, T, cin, cout, k, form, getattr(torch, dtype),
                                             cuda_device, xc, seed=T + B)
    assert_int8_bit_exact(x, wq, ws, bias, a_scale, pc, stride, pad)


# shapes that take each split of the K steps on a 132-SM card: tiles, K steps, split
SPLIT_CASES = [
    (8, 200, 1024, 1024, 5, 1, 2),  # 104 tiles: no split
    (8, 100, 1024, 1024, 5, 1, 2),  # 56 tiles: 2
    (8, 200, 1024, 263, 1, 1, 0),   # 39 tiles: 3, Cout 263
    (8, 50, 1024, 1024, 5, 1, 2),   # 32 tiles: 3
    (8, 25, 1024, 1024, 5, 1, 2),   # 16 tiles: 4
    (2, 30, 640, 640, 1, 1, 0),     # 5 tiles, 5 K steps: 5, one step each
    (2, 25, 256, 640, 3, 1, 1),     # 5 tiles, 6 steps: 6, one step each
    (2, 30, 896, 640, 1, 1, 0),     # 5 tiles, 7 steps: 7, one step each
    (3, 50, 1024, 512, 1, 1, 0),    # 8 tiles, 8 steps: 8, one step each
    (2, 60, 1408, 640, 1, 1, 0),    # 5 tiles, 11 steps: 8, parts of 1 and 2 steps
    (2, 60, 384, 256, 3, 2, 1),     # 2 tiles, 9 steps: 8, stride 2
    (1, 40, 1024, 128, 3, 1, 1),    # 1 tile, 24 steps: 8
    (2, 9, 40, 30, 5, 2, 2),        # 1 tile, 5 steps: 5, Cout 30 (not a multiple of 4)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_int8_kernel_is_bit_exact_at_every_split(cuda_device, dtype, case):
    """Each split of the K steps the plan takes, down to parts of a single K step:
    the int32 sums of the parts, added up through the cluster's shared memory,
    equal the plain version's bit for bit, in two calls in a row."""
    from condmdi_tpu_torch.ops import quant

    B, T, cin, cout, k, stride, pad = case
    plan = quant.int8_plan(B, T, cin, cout, k, stride, pad, sm_count(cuda_device))
    assert 1 <= plan["split"] <= 8
    dt = getattr(torch, dtype)
    for seed in (1, 2):
        x, wq, ws, bias, a_scale, pc = int8_case(B, T, cin, cout, k, "static", dt, cuda_device,
                                                 seed=seed)
        assert_int8_bit_exact(x, wq, ws, bias, a_scale, pc, stride, pad)


@pytest.mark.cuda
def test_int8_split_cases_cover_every_split(cuda_device):
    from condmdi_tpu_torch.ops import quant

    if sm_count(cuda_device) != 132:
        pytest.skip("the split cases are chosen for a 132-SM card")
    plans = [quant.int8_plan(*c, 132) for c in SPLIT_CASES]
    assert {p["split"] for p in plans} == set(range(1, 9))
    assert any(p["split"] == p["steps"] for p in plans)  # every part a single K step
    assert any(1 < p["split"] < p["steps"] < 2 * p["split"] for p in plans)  # parts of 1 and 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (8, 200, 528, 1024, 5, 1, 2), (8, 25, 2048, 1024, 5, 1, 2), (8, 200, 1024, 1024, 3, 2, 1),
    (1, 25216, 512, 1536, 1, 1, 0), (3, 17, 40, 24, 3, 2, 1), (2, 9, 40, 24, 5, 2, 2),
])
def test_python_int8_plan_is_the_librarys(cuda_device, shape):
    import ctypes

    from condmdi_tpu_torch.ops import _build, quant

    B, T, cin, cout, k, stride, pad = shape
    lib = _build.load_quant()
    out = (ctypes.c_int * 5)()
    cin_pad = -(-cin // 128) * 128
    for sms in (132, 114, 8):
        assert lib.condmdi_int8_conv1d_plan(B, T, cin_pad, cout, k, stride, pad, sms, out) == 0
        want = dict(zip(("t_pad", "m_tiles", "n_tiles", "split", "steps"), list(out)))
        assert quant.int8_plan(B, T, cin, cout, k, stride, pad, sms) == want


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(8, 25, 1024, 1024, 5, 1, 2), (8, 200, 1024, 1024, 3, 2, 1)])
def test_int8_kernel_replays_inside_a_cuda_graph(cuda_device, case):
    """One int8 conv (a split one, and a stride-2 one) captured on a side stream and
    replayed on new contents of its input, dynamic scale: no host sync and no
    allocation outside torch; the two launches of a call (the quantize pass, then
    the conv as its programmatic dependent, in clusters where split) replay."""
    from condmdi_tpu_torch.ops import quant

    B, T, cin, cout, k, stride, pad = case
    x, wq, ws, bias, _, _ = int8_case(B, T, cin, cout, k, "dynamic", torch.bfloat16,
                                      cuda_device)
    packed = quant.pack_int8_weight(wq)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        quant.int8_conv1d(x, wq, ws, bias, stride, pad, packed=packed)  # the build
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph, stream=side):
        out = quant.int8_conv1d(x, wq, ws, bias, stride, pad, packed=packed)
    for seed in (5, 6):
        fresh, *_ = int8_case(B, T, cin, cout, k, "dynamic", torch.bfloat16, cuda_device,
                              seed=seed)
        x.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        want = quant.plain_int8_conv1d(x, wq, ws, bias, stride, pad)
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_float_twin_shares_storage_on_the_card(cuda_device):
    """The mixed-step sampler's float twin reads the int8 model's own parameters:
    the same storage, and its packed resblock weights follow an in-place change."""
    from condmdi_tpu_torch.models.unet import MDM_UNET, MixedStepDenoiser

    model = MDM_UNET(njoints=263, latent_dim=32, dim_mults=(1, 2), keyframe_conditioned=True,
                     pad_frames_to=32, zero=False, precision_mode="int8_static",
                     device=cuda_device).requires_grad_(False)
    mixed = MixedStepDenoiser(model, 250)
    own = dict(model.named_parameters())
    assert all(p.data_ptr() == own[n].data_ptr() for n, p in mixed.twin.named_parameters())
    x = torch.randn((2, 28, 263), device=cuda_device)
    y = {"text_embed": torch.randn((2, 512), device=cuda_device)}
    kw = dict(obs_x0=torch.zeros_like(x), obs_mask=torch.zeros(x.shape, dtype=torch.bool,
                                                                 device=cuda_device))
    t = torch.full((2,), 10, device=cuda_device)
    with torch.no_grad():
        before = mixed(x, t, y, **kw)
        model.unet.mid_block1.block1.conv.weight.mul_(-1.0)
        after = mixed(x, t, y, **kw)
    assert not torch.equal(before, after)


# --------------------------------------------------------------------------- #
# the sampling CLIs' float32 path
# --------------------------------------------------------------------------- #
# (B, T, Cin, Cout, adagn, res) of every f32 resblock half the conditional CLI runs:
# the committed gate UNet (latent 128, dim_mults 1 2 2, pad 224) at 4 samples under
# CFG, and UNet-XL at pad 224 at 2 samples under CFG (x carries 528 channels for 526)
CLI_F32_SHAPES = [
    (8, 224, 526, 128, True, False), (8, 224, 128, 128, False, True),
    (8, 224, 128, 128, True, False), (8, 224, 128, 128, False, False),
    (8, 112, 128, 128, False, True), (8, 112, 128, 128, True, False),
    (8, 112, 128, 256, True, False), (8, 112, 256, 256, False, True),
    (8, 112, 256, 256, True, False), (8, 112, 512, 128, True, False),
    (8, 56, 256, 256, False, True), (8, 56, 256, 256, True, False),
    (8, 56, 512, 256, True, False),
    (4, 224, 526, 1024, True, False), (4, 224, 1024, 1024, False, True),
    (4, 224, 1024, 1024, True, False), (4, 224, 1024, 1024, False, False),
    (4, 112, 1024, 1024, False, True), (4, 112, 1024, 1024, True, False),
    (4, 112, 2048, 1024, True, False), (4, 56, 1024, 1024, False, True),
    (4, 56, 1024, 1024, True, False), (4, 56, 2048, 1024, True, False),
    (4, 28, 1024, 1024, False, True), (4, 28, 1024, 1024, True, False),
    (4, 28, 2048, 1024, True, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLI_F32_SHAPES)
def test_kernel_matches_plain_at_the_cli_f32_shapes(cuda_device, case):
    B, T, cin, cout, adagn, res = case
    args, kw = make_inputs(B, T, cin, cout, adagn, res, torch.float32, cuda_device)
    if cin % 8:  # the UNet's first half: alignment channels past Cin, zero
        args[0] = torch.nn.functional.pad(args[0], (0, -cin % 8))
    before = resblock.fused_conv_gn_mish.launches
    with torch.no_grad():
        got = resblock.fused_conv_gn_mish(*args, **kw)
        torch.cuda.synchronize()
        want = resblock.reference_conv_gn_mish(*args, **kw)
    assert resblock.fused_conv_gn_mish.launches == before + 1
    assert torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= F32_TOL * (1 + want.abs()))


@pytest.mark.cuda
def test_conditional_cli_kernel_path_matches_plain(cuda_device, tmp_path):
    """conditional's main on the committed gate checkpoint, DDIM-10, 2 samples,
    through the kernel and with the resblock halves swapped for the plain
    version: the same seed gives the same x_T, and the motions agree within
    5e-3 (the f32 kernel's rounding over a whole sampler run)."""
    from pathlib import Path

    import condmdi_tpu_torch.models.unet as unet_mod
    from condmdi_tpu_torch.sampling.conditional import main

    ckpt = Path(__file__).resolve().parent.parent / "save" / "synthetic_unet_m" / \
        "gate_ema_000100000.npz"
    argv = ["--model_path", str(ckpt), "--num_samples", "2", "--num_repetitions", "1",
            "--use_ddim", "true", "--timestep_respacing", "ddim10", "--imputate", "true"]

    def run(tag):
        np.random.seed(0)
        out = main(argv + ["--output_dir", str(tmp_path / tag)])
        return np.load(out / "results.npy", allow_pickle=True).item()

    before = resblock.fused_conv_gn_mish.launches
    got = run("kernel")
    assert resblock.fused_conv_gn_mish.launches - before == 25 * 10  # halves x steps
    kernel_fn = unet_mod.fused_conv_gn_mish
    unet_mod.fused_conv_gn_mish = \
        lambda *a, packed=None, **kw: resblock.reference_conv_gn_mish(*a, **kw)
    try:
        want = run("plain")
    finally:
        unet_mod.fused_conv_gn_mish = kernel_fn
    assert np.isfinite(got["motion"]).all() and np.abs(want["motion"]).max() > 0
    assert np.abs(got["motion"] - want["motion"]).max() <= 5e-3
    m = got["observed_mask"]
    assert m.any() and np.array_equal(got["motion"][m], got["observed_motion"][m])


# (B, T, Cin, x channels, Cout, k, stride, padding) of every int8 conv the conditional
# CLI runs with --precision_mode int8 on UNet-XL at pad 224 and 2 samples under CFG:
# f32 activations, dynamic scale; the batch-folded plan's tiles and split follow B and T
CLI_INT8_SHAPES = [
    (4, 224, 526, 528, 1024, 5, 1, 2), (4, 224, 526, 528, 1024, 1, 1, 0),
    (4, 224, 1024, 1024, 1024, 5, 1, 2), (4, 112, 1024, 1024, 1024, 5, 1, 2),
    (4, 56, 1024, 1024, 1024, 5, 1, 2), (4, 28, 1024, 1024, 1024, 5, 1, 2),
    (4, 112, 2048, 2048, 1024, 5, 1, 2), (4, 56, 2048, 2048, 1024, 5, 1, 2),
    (4, 28, 2048, 2048, 1024, 5, 1, 2), (4, 112, 2048, 2048, 1024, 1, 1, 0),
    (4, 56, 2048, 2048, 1024, 1, 1, 0), (4, 28, 2048, 2048, 1024, 1, 1, 0),
    (4, 224, 1024, 1024, 1024, 3, 2, 1), (4, 112, 1024, 1024, 1024, 3, 2, 1),
    (4, 56, 1024, 1024, 1024, 3, 2, 1), (4, 224, 1024, 1024, 263, 1, 1, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLI_INT8_SHAPES)
def test_int8_kernel_is_bit_exact_at_the_cli_int8_shapes(cuda_device, case):
    B, T, cin, xc, cout, k, stride, pad = case
    x, wq, ws, bias, a_scale, pc = int8_case(B, T, cin, cout, k, "dynamic", torch.float32,
                                             cuda_device, xc, seed=T + cin)
    assert_int8_bit_exact(x, wq, ws, bias, a_scale, pc, stride, pad)


@pytest.mark.cuda
def test_conditional_cli_int8_kernel_path_matches_plain(cuda_device, tmp_path):
    """conditional's main with --precision_mode int8 on the committed gate
    checkpoint, DDIM-10, 2 samples, through the int8 kernel and with its launch
    swapped for the plain version: the same seed gives the same x_T, and the
    motions agree within 5e-3 (the per-call results are equal bit for bit)."""
    from pathlib import Path

    from condmdi_tpu_torch.ops import quant
    from condmdi_tpu_torch.sampling.conditional import main

    ckpt = Path(__file__).resolve().parent.parent / "save" / "synthetic_unet_m" / \
        "gate_ema_000100000.npz"
    argv = ["--model_path", str(ckpt), "--num_samples", "2", "--num_repetitions", "1",
            "--use_ddim", "true", "--timestep_respacing", "ddim10", "--precision_mode", "int8"]

    def run(tag):
        np.random.seed(0)
        out = main(argv + ["--output_dir", str(tmp_path / tag)])
        return np.load(out / "results.npy", allow_pickle=True).item()

    before = quant.int8_conv1d.launches
    got = run("kernel")
    launches = quant.int8_conv1d.launches - before
    assert launches > 0 and launches % 10 == 0  # convs x steps
    launch = quant._launch
    quant._launch = lambda x, wq, ws, b, stride, pad, a_scale, pc, packed: \
        quant.plain_int8_conv1d(x, wq, ws, b, stride, pad, a_scale, pc)
    try:
        want = run("plain")
    finally:
        quant._launch = launch
    assert np.isfinite(got["motion"]).all() and np.abs(want["motion"]).max() > 0
    assert np.abs(got["motion"] - want["motion"]).max() <= 5e-3


# --------------------------------------------------------------------------- #
# the float32 routes: the resblock half on hi and lo planes, attention's route 2
# --------------------------------------------------------------------------- #
def assert_f32_resblock_matches_plain(args, kw, groups=8):
    before = resblock.fused_conv_gn_mish.launches
    with torch.no_grad():
        got = resblock.fused_conv_gn_mish(*args, **kw, n_groups=groups)
        torch.cuda.synchronize()
        want = resblock.reference_conv_gn_mish(*args, **kw, n_groups=groups)
    assert resblock.fused_conv_gn_mish.launches == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= F32_TOL * (1 + want.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5, 28, 63, 64, 65, 129, 200, 224, 256, 257, 304, 420, 1000, 1024])
@pytest.mark.parametrize("group", [16, 32, 128])
@pytest.mark.parametrize("adagn,res", [(True, False), (False, True)])
def test_f32_kernel_over_lengths_and_group_widths(cuda_device, T, group, adagn, res):
    """The float32 kernel at T=1 and at T on each side of its tiles (64 rows up to
    T=256, 128 beyond), T=304 and 420 (past the first float32 design's limit of
    299), up to 1024, eight groups of 16 or 32 channels (several groups share a
    CTA) or of 128 (a cluster along T and the group's two 64-channel tiles); a Cin that is no
    multiple of the 16-channel stage; strided scale/shift views."""
    args, kw = make_inputs(3, T, 72, 8 * group, adagn, res, torch.float32, cuda_device, seed=T)
    assert_f32_resblock_matches_plain(args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [304, 420])
def test_f32_kernel_past_the_first_designs_limit_at_the_xl_widths(cuda_device, T):
    """A float32 UNet-XL half at T=304 and T=420, which the first float32 kernel refused
    (its pre-norm tile in shared memory): Cin 526 in a 528-channel row."""
    args, kw = make_inputs(2, T, 526, 1024, True, False, torch.float32, cuda_device)
    args[0] = torch.nn.functional.pad(args[0], (0, 2))
    assert_f32_resblock_matches_plain(args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("cout,groups", [(64, 8), (24, 3), (56, 8), (160, 8), (96, 1)])
def test_f32_kernel_at_odd_group_widths(cuda_device, cout, groups):
    """Groups of 8, 8, 7, 20 and 96 channels: a tile of several whole groups with
    columns left over, odd channel offsets, and a group of two ragged tiles."""
    args, kw = make_inputs(2, 37, 40, cout, True, True, torch.float32, cuda_device)
    assert_f32_resblock_matches_plain(args, kw, groups=groups)


@pytest.mark.cuda
def test_f32_module_output_follows_its_weight(cuda_device):
    """The block's cached hi/lo split is remade when the weight changes in place
    or through load_state_dict."""
    from condmdi_tpu_torch.models.layers import init_params
    from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock

    block = init_params(Conv1dAdaGNBlock(128, 256, device=cuda_device), 0)
    args, kw = make_inputs(2, 224, 128, 256, True, False, torch.float32, cuda_device)

    def both():
        with torch.no_grad():
            got = block(args[0], kw["scale"], kw["shift"])
            want = resblock.reference_conv_gn_mish(
                args[0], block.conv.weight, block.conv.bias, block.norm.weight,
                block.norm.bias, **kw)
        assert torch.all((got - want).abs() <= F32_TOL * (1 + want.abs()))
        return got

    first = both()
    packed = block.packed.get(block.conv.weight)
    assert packed.dtype == torch.bfloat16 and packed.shape[0] == 2
    with torch.no_grad():
        block.conv.weight.mul_(-1.5)
    second = both()
    assert (first - second).abs().max() > 0.1
    block.load_state_dict({k: torch.randn_like(v) * 0.05 for k, v in block.state_dict().items()})
    both()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4, 224, 1024, 1024, True, False), (8, 112, 128, 256, True, True)])
def test_f32_kernel_replays_inside_a_cuda_graph(cuda_device, case):
    """One float32 half (cached split weight, as the modules call it) captured on a
    side stream and replayed on new contents of x: equal to the eager call bit
    for bit."""
    B, T, cin, cout, adagn, res = case
    args, kw = make_inputs(B, T, cin, cout, adagn, res, torch.float32, cuda_device)
    cache = resblock.PackedConvWeight()
    cache.get(args[1])

    def call():
        return resblock.fused_conv_gn_mish(*args, **kw, packed=cache)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        call()  # the build and the first launch stay outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph, stream=side):
        out = call()
    rng = np.random.default_rng(41)
    for _ in range(2):
        args[0].copy_(torch.from_numpy(rng.standard_normal(args[0].shape).astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        with torch.no_grad():
            eager = call()
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_f32_unet_forward_past_the_first_designs_limit(cuda_device):
    """A float32 forward of a small keyframe UNet at T=304 (every half past the
    first float32 kernel's limit of 299 at its top level) through the kernel
    equals the plain path."""
    import condmdi_tpu_torch.models.unet as unet_mod
    from condmdi_tpu_torch.models.unet import MDM_UNET

    model = MDM_UNET(njoints=263, latent_dim=32, dim_mults=(1, 2), keyframe_conditioned=True,
                     pad_frames_to=304, zero=False, device=cuda_device).requires_grad_(False)
    rng = np.random.default_rng(5)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)

    x, obs = arr(2, 304, 263), arr(2, 304, 263)
    mask = torch.zeros((2, 304, 263), dtype=torch.bool, device=cuda_device)
    mask[:, ::10] = True
    y = {"text_embed": arr(2, 512)}
    t = torch.tensor([10, 700], device=cuda_device)
    before = resblock.fused_conv_gn_mish.launches
    with torch.no_grad():
        got = model(x, t, y, obs_x0=obs, obs_mask=mask)
    launched = resblock.fused_conv_gn_mish.launches - before
    kernel_fn = unet_mod.fused_conv_gn_mish
    unet_mod.fused_conv_gn_mish = \
        lambda *a, packed=None, **kw: resblock.reference_conv_gn_mish(*a, **kw)
    try:
        with torch.no_grad():
            want = model(x, t, y, obs_x0=obs, obs_mask=mask)
    finally:
        unet_mod.fused_conv_gn_mish = kernel_fn
    assert launched > 0 and torch.isfinite(got).all() and want.abs().max() > 0
    assert (got - want).abs().max() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, T, D, H): MDM edit (B = 4 samples), synthesize (B = 8 under CFG), T = 1,
    # ragged T at hd 64 and 32, the longest T at hd 128
    (4, 197, 512, 4), (8, 197, 512, 4), (3, 1, 512, 4), (3, 25, 128, 2), (2, 70, 64, 2),
    (2, 224, 256, 2), (40, 100, 256, 2),
])
def test_f32_attention_route_matches_plain(cuda_device, case):
    B, T, D, H = case
    assert attention.attention_route(B, T, H, D // H, torch.float32) == "wgmma_f32"
    q, k, v = qkv_views(B, T, D, torch.float32, cuda_device, seed=T + B)
    before = attention.fused_self_attention.launches
    with torch.no_grad():
        got = attention.mha(q, k, v, H)
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H)
    assert attention.fused_self_attention.launches == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= F32_TOL * (1 + want.abs()))


@pytest.mark.cuda
def test_f32_attention_route_past_the_grid_limit(cuda_device):
    """70,000 batch items at hd 32 in float32: the resident kernel numbers its work
    along grid x, and its planes of 2 x 70,000 items along the maps' batch."""
    B, T, D, H = 70_000, 3, 32, 1
    q, k, v = (torch.randn(B, T, D, device=cuda_device) for _ in range(3))
    assert attention.attention_route(B, T, H, D, torch.float32) == "wgmma_f32"
    with torch.no_grad():
        got = attention.mha(q, k, v, H)
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H)
    assert torch.all((got - want).abs() <= F32_TOL * (1 + want.abs()))


@pytest.mark.cuda
def test_f32_attention_route_replays_inside_a_cuda_graph_bit_for_bit(cuda_device):
    """The split pass and the kernel behind it as its programmatic dependent,
    captured once and replayed on new contents: equal to the eager call bit for
    bit."""
    B, T, D, H = 4, 197, 512, 4
    rng = np.random.default_rng(23)

    def fresh():
        return torch.from_numpy(rng.standard_normal((B, T, 3 * D)).astype(np.float32)).to(
            cuda_device)

    qkv = fresh()
    q, k, v = qkv.chunk(3, dim=-1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        attention.mha(q, k, v, H)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph, stream=side):
        out = attention.mha(q, k, v, H)
    for _ in range(2):
        qkv.copy_(fresh())
        graph.replay()
        torch.cuda.synchronize()
        with torch.no_grad():
            eager = attention.mha(q, k, v, H)
        assert torch.equal(out, eager)


# --------------------------------------------------------------------------- #
# the evaluation protocols' shapes: evals.run on the gate checkpoint (B=32, f32,
# float and int8_static) and evals.run_t2m on MDM (B=64 under CFG, f32)
# --------------------------------------------------------------------------- #
# (Cin, Cout, T, adagn, res, x channels) of every resblock half of one gate forward
# (latent 128, dim_mults 1 2 2, pad 224; groups of 16 and 32 channels)
GATE_RESBLOCK_SHAPES = [
    (128, 128, 112, False, True, 128), (128, 128, 112, True, False, 128),
    (128, 128, 224, False, False, 128), (128, 128, 224, False, True, 128),
    (128, 128, 224, True, False, 128), (128, 256, 112, True, False, 128),
    (256, 256, 56, False, True, 256), (256, 256, 56, True, False, 256),
    (256, 256, 112, False, True, 256), (256, 256, 112, True, False, 256),
    (512, 128, 112, True, False, 512), (512, 256, 56, True, False, 512),
    (526, 128, 224, True, False, 528),
]
# (Cin, x channels, Cout, k, stride, padding, T) of every int8 conv of one gate forward
# in int8_static (32 a forward)
GATE_INT8_SHAPES = [
    (128, 128, 128, 3, 2, 1, 224), (128, 128, 128, 5, 1, 2, 112), (128, 128, 128, 5, 1, 2, 224),
    (128, 128, 256, 1, 1, 0, 112), (128, 128, 256, 5, 1, 2, 112), (128, 128, 263, 1, 1, 0, 224),
    (256, 256, 256, 3, 2, 1, 112), (256, 256, 256, 5, 1, 2, 56), (256, 256, 256, 5, 1, 2, 112),
    (512, 512, 128, 1, 1, 0, 112), (512, 512, 128, 5, 1, 2, 112), (512, 512, 256, 1, 1, 0, 56),
    (512, 512, 256, 5, 1, 2, 56), (526, 528, 128, 1, 1, 0, 224), (526, 528, 128, 5, 1, 2, 224),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GATE_RESBLOCK_SHAPES)
def test_f32_kernel_at_the_gate_evaluation_shapes(cuda_device, case):
    cin, cout, T, adagn, res, xc = case
    args, kw = make_inputs(32, T, cin, cout, adagn, res, torch.float32, cuda_device, seed=T + cin)
    args[0] = torch.nn.functional.pad(args[0], (0, xc - cin))  # the UNet's alignment channels
    assert_f32_resblock_matches_plain(args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GATE_INT8_SHAPES)
def test_int8_kernel_is_bit_exact_at_the_gate_evaluation_shapes(cuda_device, case):
    cin, xc, cout, k, stride, pad, T = case
    x, wq, ws, bias, a_scale, pc = int8_case(32, T, cin, cout, k, "static", torch.float32,
                                             cuda_device, xc, seed=T + cin + k)
    assert_int8_bit_exact(x, wq, ws, bias, a_scale, pc, stride, pad)


@pytest.mark.cuda
def test_f32_attention_route_at_the_t2m_evaluation_shape(cuda_device):
    B, T, D, H = 64, 197, 512, 4  # one batch of 32, doubled by CFG
    assert attention.attention_route(B, T, H, D // H, torch.float32) == "wgmma_f32"
    q, k, v = qkv_views(B, T, D, torch.float32, cuda_device, seed=64)
    with torch.no_grad():
        got = attention.mha(q, k, v, H)
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H)
    assert torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= F32_TOL * (1 + want.abs()))


@pytest.mark.cuda
def test_eval_run_kernel_path_matches_plain(cuda_device, tmp_path, monkeypatch):
    """evals.run's main on the committed gate checkpoint, one batch of 32, DDIM-10,
    through the kernel and with the resblock halves swapped for the plain version:
    the same seed gives the same x_T, the generated motions and their joints agree
    within 5e-3, and the report carries the gate's fingerprint."""
    import json
    from pathlib import Path

    import condmdi_tpu_torch.evals.harness as harness
    import condmdi_tpu_torch.models.unet as unet_mod
    from condmdi_tpu_torch.evals.run import main

    repo = Path(__file__).resolve().parent.parent
    monkeypatch.chdir(repo)  # the committed evaluator is found relative to the root
    argv = ["--model_path", str(repo / "save" / "synthetic_unet_m" / "gate_ema_000100000.npz"),
            "--edit_mode", "benchmark_sparse", "--guidance_param", "1.0", "--eval_mode", "debug",
            "--max_replications", "1", "--num_samples", "32", "--text_encoder", "hash",
            "--use_ddim", "true", "--timestep_respacing", "ddim10"]
    seen, converted = [], []
    real, real_to_motion = harness.generate_eval_batch, harness.sample_to_motion

    def to_motion(sample, stats):
        converted.append((sample, real_to_motion(sample, stats)))
        return converted[-1][1]

    def generate(*a, **kw):
        converted.clear()
        gb = real(*a, **kw)
        (sample, joints), _ground_truth = converted  # the generated motions come first
        seen.append(dict(sample=sample.cpu().numpy(), joints=joints.cpu().numpy(),
                         motions_rel=gb.motions_rel))
        return gb

    monkeypatch.setattr(harness, "sample_to_motion", to_motion)
    monkeypatch.setattr(harness, "generate_eval_batch", generate)

    before = resblock.fused_conv_gn_mish.launches
    main(argv + ["--output_dir", str(tmp_path / "kernel")])
    launches = resblock.fused_conv_gn_mish.launches - before
    assert launches == 25 * 10, launches  # halves x steps
    with monkeypatch.context() as m:
        m.setattr(unet_mod, "fused_conv_gn_mish",
                  lambda *a, packed=None, **kw: resblock.reference_conv_gn_mish(*a, **kw))
        main(argv + ["--output_dir", str(tmp_path / "plain")])
    got, want = seen
    errs = {key: float(np.abs(got[key] - want[key]).max()) for key in ("sample", "joints")}
    for key in errs:
        assert np.isfinite(got[key]).all() and np.abs(want[key]).max() > 0
    assert max(errs.values()) <= 5e-3, errs
    # motions_rel (inverse kinematics of the joints, foot contacts that are thresholds)
    # magnifies the differences unevenly: held as the CPU test holds it against JAX
    d = np.abs(got["motions_rel"].astype(np.float64) - want["motions_rel"])
    a = np.abs(want["motions_rel"].astype(np.float64))
    assert d.mean() / a.mean() <= 1e-4 and np.mean(d > 1e-3 * (1 + a)) <= 1e-3
    report = json.loads((tmp_path / "kernel" / "eval_benchmark_sparse_debug.json").read_text())
    assert report["meta"]["params_fingerprint"] == "0d69067e95b7d9da"
    assert report["meta"]["platform"] == "cuda"
    assert report["meta"]["transition_length"] == 30  # EvalArgs' default, the protocol's mask
