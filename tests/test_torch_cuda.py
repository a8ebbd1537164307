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
        T, dt = 420, torch.float32  # the f32 pre-norm tile outgrows shared memory
    elif bad == "group_width":
        cout = 8 * 136
    args, kw = make_inputs(B, T, cin, cout, False, False, dt, cuda_device)
    if bad == "taps":
        args[1] = args[1][..., :3].contiguous()
    before = resblock.fused_conv_gn_mish.launches
    with torch.no_grad(), pytest.raises(NotImplementedError):
        resblock.fused_conv_gn_mish(*args, **kw)
    assert resblock.fused_conv_gn_mish.launches == before


@pytest.mark.cuda
def test_kernel_refuses_autograd(cuda_device):
    args, _ = make_inputs(2, 16, 24, 32, False, False, torch.float32, cuda_device)
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        resblock.fused_conv_gn_mish(*args)


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
    lengths = sorted({t + d for t in (1, 16, 64, 197, 448, 896, 1792, 2048) for d in (-1, 0, 1)
                      if t + d >= 1})
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
    wrong = 1 - lib.condmdi_attention_route(T, D // H, code)
    err = lib.condmdi_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H, D // H,
        q.stride(0), q.stride(1), code, wrong, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err != 0 and "invalid" in _build.error_string(lib, err)
    assert out.abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,raises", [("bfloat16", False), ("float32", True)])
def test_attention_batch_past_the_grid_limit(cuda_device, dtype, raises):
    """70,000 batch items: the resident kernel numbers its work along grid x and
    takes them; the tiled kernel puts the batch in grid z and the wrapper says
    so before anything is launched."""
    B, T, D, H = 70_000, 3, 32, 1
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, T, D, device=cuda_device).to(dt) for _ in range(3))
    if raises:
        before = attention.fused_self_attention.launches
        with pytest.raises(NotImplementedError, match="grid limit"):
            attention.mha(q, k, v, H)
        assert attention.fused_self_attention.launches == before
    else:
        assert_attention_matches_plain(q, k, v, H)
