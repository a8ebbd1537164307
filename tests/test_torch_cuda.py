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
    """A conv width other than 5 is refused, before any launch. T=1025 (nine row
    tiles, more than a cluster of 8 holds) in either type and a group of 136
    channels (wider than the cluster routes' 128) were refused too until the split
    route took them: they now launch the kernel, which agrees with the plain
    version."""
    B, T, cin, cout, dt = 1, 16, 16, 64, torch.bfloat16
    if bad == "long_T_bf16":
        T = 1025
    elif bad == "long_T_f32":
        T, dt = 1025, torch.float32
    elif bad == "group_width":
        cout = 8 * 136
    args, kw = make_inputs(B, T, cin, cout, False, False, dt, cuda_device)
    before = resblock.fused_conv_gn_mish.launches
    if bad == "taps":
        args[1] = args[1][..., :3].contiguous()
        with torch.no_grad(), pytest.raises(NotImplementedError):
            resblock.fused_conv_gn_mish(*args, **kw)
        assert resblock.fused_conv_gn_mish.launches == before
        return
    assert resblock.resblock_plan(B, T, cin, cout, dt).route == "split"
    with torch.no_grad():
        got = resblock.fused_conv_gn_mish(*args, **kw).float()
        want = resblock.reference_conv_gn_mish(*args, **kw).float()
    assert resblock.fused_conv_gn_mish.launches == before + 1
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    assert torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= tol * (1 + want.abs()))


# (B, T, Cin, Cout) on the split route: groups of 136, 256 and 512 channels (chip_smoke.py
# phase 40's widths; 136 is no multiple of the 128-channel tile), at the lengths of a
# UNet-XL level and at T <= 64 (64-row tiles); then lengths past a cluster of 8 tiles
SPLIT_SHAPES = [
    (2, 224, 128, 8 * 136), (2, 25, 128, 8 * 136), (2, 224, 256, 8 * 256), (3, 56, 64, 8 * 256),
    (4, 28, 2048, 8 * 256), (1, 60, 64, 8 * 512), (1, 1025, 64, 1024), (2, 1280, 64, 512),
    (1, 2048, 32, 256), (1, 4096, 32, 128), (2, 1280, 40, 8 * 16), (1, 1100, 24, 8 * 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", SPLIT_SHAPES, ids=lambda c: "B{}T{}cin{}cout{}".format(*c))
@pytest.mark.parametrize("adagn,res", [(True, False), (False, True), (True, True),
                                       (False, False)])
def test_split_route_matches_plain(cuda_device, dtype, case, adagn, res):
    """The split route (the conv with no cluster, then the normalisation as its
    programmatic dependent) within the cluster routes' tolerances of the plain
    version, one launch a call."""
    B, T, cin, cout = case
    dt = getattr(torch, dtype)
    assert resblock.resblock_plan(B, T, cin, cout, dt).route == "split"
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
@pytest.mark.parametrize("case", [(4, 224, 2048, 2048), (2, 1280, 1024, 1024), (2, 200, 64, 1024)])
def test_two_launches_give_the_same_bits(cuda_device, dtype, case):
    """Two launches on the same inputs give bit-identical outputs: on the split route
    (the moments merged in a fixed order), and on the cluster route (the last case)."""
    B, T, cin, cout = case
    args, kw = make_inputs(B, T, cin, cout, True, True, getattr(torch, dtype), cuda_device)
    with torch.no_grad():
        first = resblock.fused_conv_gn_mish(*args, **kw)
        second = resblock.fused_conv_gn_mish(*args, **kw)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_python_resblock_plan_is_the_librarys(cuda_device):
    """ops/resblock.py `resblock_plan` and csrc/resblock.cu `make_plan` (as
    `condmdi_resblock_plan` returns it) agree at every route's edges."""
    import ctypes

    from condmdi_tpu_torch.ops import _build

    lib = _build.load_resblock()
    for code, dt in ((0, torch.float32), (1, torch.bfloat16)):
        for B in (1, 4):
            for T in (1, 25, 64, 65, 200, 256, 257, 1024, 1025, 1280, 4096):
                for cout in (8, 64, 128, 1024, 1088, 2048, 4096):
                    out = (ctypes.c_longlong * 12)()
                    assert lib.condmdi_resblock_plan(B, T, cout, 8, code, out) == 0
                    p = resblock.resblock_plan(B, T, 64, cout, dt)
                    assert tuple(out) == (int(p.route == "split"), *p.tiles, *p.grid[:2],
                                          p.groups_per_cta, p.cluster, p.norm_rows,
                                          *p.norm_grid[:2], p.scratch), (dt, B, T, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_route_replays_from_a_graph(cuda_device, dtype):
    """The split route under capture (its scratch from the graph's pool, the
    normalisation a programmatic dependent inside the graph): the replay on new
    inputs equals an eager call bit for bit."""
    args, kw = make_inputs(4, 224, 2048, 2048, True, True, getattr(torch, dtype), cuda_device)
    cache = resblock.PackedConvWeight()

    def fn():
        with torch.no_grad():
            return [resblock.fused_conv_gn_mish(*args, **kw, packed=cache)]

    _replay_against_eager(fn, [args[0], kw["res"]], _refill(2))


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
    # the latent-1024 UNet-XL at pad 224 (groups of 256: the split route) and a length
    # past a cluster of 8 row tiles
    (4, 224, 526, 528, 2048, True, False),
    (2, 56, 4096, 4096, 2048, False, True),
    (1, 1280, 64, 64, 512, True, True),
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
    (448, 128, 1, "wgmma"), (449, 128, 1, "stream"),   # hd 128: K and V of 448 rows fit
    (896, 128, 2, "wgmma"), (897, 128, 2, "stream"),   # hd 64
    (200, 96, 4, "stream"), (200, 64, 4, "stream"),    # hd 24 and 16: not a resident width
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
@pytest.mark.parametrize("bad", ["heads", "dtype_mismatch", "unsupported_dtype"])
def test_attention_wrapper_refuses_what_the_kernel_does_not_take(cuda_device, bad):
    """What JAX's reshape refuses too (D not a multiple of H), and a type the
    kernels do not take; every head width is taken since the streaming route."""
    q, k, v = qkv_views(2, 16, 64, torch.bfloat16, cuda_device)
    H = 2
    if bad == "heads":
        H = 5
    elif bad == "dtype_mismatch":
        k = k.float()
    else:
        q, k, v = q.half(), k.half(), v.half()
    before = attention.fused_self_attention.launches
    with pytest.raises((ValueError, TypeError)):
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
        for hd in [*range(1, 129), 136, 256, 320, 1024]:
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
@pytest.mark.parametrize("dtype,route", [("bfloat16", "wgmma"), ("float32", "stream")])
def test_attention_batch_past_the_grid_limit(cuda_device, dtype, route):
    """70,000 batch items: the resident kernel numbers its work along grid x and
    takes them (bf16 at hd 32); the streaming kernel (here float32 at hd 24,
    which the first tiled kernel refused past 65,535) numbers (batch, head,
    tile) items in one linear index. The float32 route at hd 32 is held to the
    same batch in test_f32_attention_route_past_the_grid_limit."""
    B, T, D, H = 70_000, 3, 32 if dtype == "bfloat16" else 24, 1
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, T, D, device=cuda_device).to(dt) for _ in range(3))
    assert attention.attention_route(B, T, H, D // H, dt) == route
    before = attention.fused_self_attention.launches
    with torch.no_grad():
        got = attention.mha(q, k, v, H).float()
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H).float()
    assert attention.fused_self_attention.launches == before + 1
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    assert torch.isfinite(got).all() and torch.all((got - want).abs() <= tol * (1 + want.abs()))



# the streaming route ("stream") at the shapes of its issue: (name, B, T, D, H)
STREAM_SHAPES = [
    ("a2m_cli_default", 32, 61, 64, 4),   # evals.run_a2m at the JAX CLIs' width (hd 16)
    ("mdm_225", 4, 225, 512, 4),          # MDM at 224 frames + the cond token
    ("t2m_225", 64, 225, 512, 4),
    ("long_512", 8, 512, 512, 4),         # past route 1's T <= 448 at hd 128
    ("long_512_b128", 128, 512, 512, 4),
    ("hd4", 8, 197, 16, 4),               # --latent_dim 16
    ("hd256", 8, 197, 1024, 4),           # --latent_dim 1024
    ("hd320", 2, 197, 1280, 4),           # more columns than one block holds
]


def assert_stream_matches_plain(q, k, v, H, route="stream"):
    dt = q.dtype
    assert attention.attention_route(q.shape[0], q.shape[1], H, q.shape[2] // H, dt) == route
    before = attention.fused_self_attention.launches
    with torch.no_grad():
        got = attention.mha(q, k, v, H).float()
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H).float()
    assert attention.fused_self_attention.launches == before + 1
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    assert got.shape == q.shape and torch.isfinite(got).all()
    bad = (got - want).abs() > tol * (1 + want.abs())
    assert not bad.any(), (bad.sum().item(), (got - want).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", STREAM_SHAPES, ids=[c[0] for c in STREAM_SHAPES])
def test_stream_route_matches_plain(cuda_device, dtype, case):
    _, B, T, D, H = case
    dt = getattr(torch, dtype)
    # bf16 at hd 128 and T = 225 is route 1's (K and V of 448 rows fit); held here all the same
    route = "wgmma" if dt == torch.bfloat16 and D // H == 128 and T <= 448 else "stream"
    assert_stream_matches_plain(*qkv_views(B, T, D, dt, cuda_device, seed=T + D), H, route)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [1, 3, 4, 8, 20, 24, 40, 48, 72, 96, 136, 200, 264, 320, 384,
                                520, 1024])
@pytest.mark.parametrize("T", [1, 65, 130])
def test_stream_route_at_every_head_width(cuda_device, dtype, hd, T):
    """Head widths below, between and above the chunk widths (16, 32, 64), above
    one column block (256 bf16, 128 float32) and where Q no longer fits beside
    the ring (float32 at hd 1024 streams Q); one, two and three query tiles."""
    dt = getattr(torch, dtype)
    if hd in (32, 64, 128):
        pytest.skip("a resident route's width")
    H = 2
    assert_stream_matches_plain(*qkv_views(3, T, H * hd, dt, cuda_device, seed=hd + T), H)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shift", [1, 3])
@pytest.mark.parametrize("D,H", [(64, 4), (512, 4), (1024, 4)])
def test_stream_route_reads_unaligned_rows(cuda_device, dtype, shift, D, H):
    """q, k, v whose rows begin `shift` elements into a buffer whose rows are
    3D + shift long: neither the pointers nor the row strides are 16-byte
    aligned. The streaming route packs them (hd 16, 256); a resident route's
    shape (hd 128, T = 197) gets aligned copies."""
    B, T = 3, 197
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(shift + D)
    buf = torch.from_numpy(rng.standard_normal((B, T, 3 * D + shift)).astype(np.float32))
    q, k, v = buf.to(cuda_device, dt)[..., shift:].chunk(3, dim=-1)
    assert (q.data_ptr() % 16) and (q.stride(1) * q.element_size()) % 16
    route = attention.attention_route(B, T, H, D // H, dt)
    assert_stream_matches_plain(q, k, v, H, route)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,T,D,H", [(2, 61, 64, 4), (3, 200, 72, 3), (2, 17, 4, 4),
                                     (1, 5, 1280, 4)])
def test_pack_pass_is_pack_heads_bit_for_bit(cuda_device, dtype, B, T, D, H):
    """The streaming route's pack pass (csrc/attention.cu `condmdi_attention_pack`)
    writes what `pack_heads` computes, zero padding included."""
    from condmdi_tpu_torch.ops import _build

    dt = getattr(torch, dtype)
    q, k, v = qkv_views(B, T, D, dt, cuda_device, seed=7 * T)
    want = attention.pack_heads(q, k, v, H)
    got = torch.full_like(want, float("nan"))
    lib = _build.load_attention()
    err = lib.condmdi_attention_pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), got.data_ptr(), B, T, H, D // H, q.stride(0),
        q.stride(1), attention._DTYPES[dt][0], torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D,H", [(16, 4), (1024, 4)])
def test_stream_route_gradients_through_the_function(cuda_device, dtype, D, H):
    """Autograd on the card at streaming shapes (hd 4 packed; hd 256 read in place
    in bf16): the kernel forward, the recompute backward."""
    dt = getattr(torch, dtype)
    q, k, v = (t.detach().requires_grad_(True)
               for t in qkv_views(2, 70, D, dt, cuda_device, seed=D))
    assert attention.attention_route(2, 70, H, D // H, dt) == "stream"
    before = attention.fused_self_attention.launches
    out = attention.mha(q, k, v, H)
    (out.float() * out.float()).sum().backward()
    assert attention.fused_self_attention.launches == before + 1
    refs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref = attention._xla_attention(*refs, H)
    (ref.float() * ref.float()).sum().backward()
    tol = 5e-2 if dt == torch.bfloat16 else 1e-3
    for got, want in zip((q, k, v), refs):
        torch.testing.assert_close(got.grad.float(), want.grad.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [("float32", 512), ("float32", 16), ("bfloat16", 16),
                                     ("bfloat16", 1024)])
def test_stream_route_replays_inside_a_cuda_graph(cuda_device, dtype, D):
    """One `mha` at a streaming shape captured on a side stream and replayed on
    new contents of the same buffers: equal to the eager call bit for bit (float32
    at hd 128, read in place and split by the kernel; at hd 4, the pack pass and
    the kernel as its programmatic dependent; bf16 at hd 4, packed, and at hd
    256, read in place)."""
    B, T, H = 4, 225, 4
    dt = getattr(torch, dtype)
    assert attention.attention_route(B, T, H, D // H, dt) == "stream"
    rng = np.random.default_rng(29)

    def fresh():
        return torch.from_numpy(rng.standard_normal((B, T, 3 * D)).astype(np.float32)).to(
            cuda_device, dt)

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
            eager = attention._launch(q, k, v, H)
        torch.cuda.synchronize()
        assert torch.equal(out, eager) and out.float().abs().max() > 0

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
def test_int8_forward_of_the_latent_1024_unet_matches_plain(cuda_device):
    """The keyframe UNet-XL at --latent_dim 1024 (2,048 channels, up-path convs of
    K = 4,096 x 5) in int8 mode, float32 activations, B=2 at pad 224: the forward
    through the int8 kernel against the same forward with its launch swapped for
    the plain version (each call is bit for bit the plain one; 5e-3 on the output,
    as the CLI's int8 test), 41 int8 launches."""
    from condmdi_tpu_torch.models.unet import MDM_UNET
    from condmdi_tpu_torch.ops import quant

    model = MDM_UNET(njoints=263, latent_dim=1024, dim_mults=(2, 2, 2, 2),
                     keyframe_conditioned=True, pad_frames_to=224, zero=False,
                     precision_mode="int8", device=cuda_device, seed=4).requires_grad_(False)
    assert max(w.shape[1] for w in model.parameters() if w.ndim == 3) == 4096
    rng = np.random.default_rng(8)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)

    x, obs = arr(2, 196, 263), arr(2, 196, 263)
    mask = torch.zeros((2, 196, 263), dtype=torch.bool, device=cuda_device)
    mask[:, ::20] = True
    y, t = {"text_embed": arr(2, 512)}, torch.tensor([30, 800], device=cuda_device)
    before = quant.int8_conv1d.launches
    with torch.no_grad():
        got = model(x, t, y, obs_x0=obs, obs_mask=mask)
    assert quant.int8_conv1d.launches - before == 41
    launch = quant._launch
    quant._launch = lambda x, wq, ws, b, stride, pad, a_scale, pc, packed: \
        quant.plain_int8_conv1d(x, wq, ws, b, stride, pad, a_scale, pc)
    try:
        with torch.no_grad():
            want = model(x, t, y, obs_x0=obs, obs_mask=mask)
    finally:
        quant._launch = launch
    assert torch.isfinite(got).all() and want.abs().max() > 0
    assert (got - want).abs().max() <= 5e-3


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
    from condmdi_tpu_torch.diffusion.sampling import at_model_step
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
    with torch.no_grad(), at_model_step(10):  # the sampler's step: the float twin's branch
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


# --------------------------------------------------------------------------- #
# training: the kernels under autograd at the training shapes, and after AdamW
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, T, Cin, x channels, Cout, adagn, res): UNet-XL training at B=64, pad 224, f32
    (64, 224, 526, 528, 1024, True, False),
    (64, 224, 1024, 1024, 1024, False, True),
    (64, 112, 2048, 2048, 1024, True, False),
    (64, 28, 1024, 1024, 1024, False, True),
])
def test_kernel_gradients_match_plain_at_the_training_shapes(cuda_device, case):
    """ConvGnMish's gradients at UNet-XL's training batch equal plain autograd's
    (GRAD_TOL); its forward is the kernel's (F32_TOL)."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["foreach", "fused"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_resblock_follows_adamw_steps(cuda_device, form, dtype):
    """After torch.optim.AdamW steps (foreach and fused: both update the weight in
    place), the half's kernel forward reads the new weight through its cached
    packed copy: it equals the plain forward on the updated weight."""
    from condmdi_tpu_torch.models.layers import init_params
    from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock

    dt = getattr(torch, dtype)
    block = init_params(Conv1dAdaGNBlock(256, 512, device=cuda_device), 0).to(dt)
    args, kw = make_inputs(4, 100, 256, 512, True, False, dt, cuda_device)
    opt = torch.optim.AdamW(block.parameters(), lr=1e-2, weight_decay=0.01,
                            **{form: True})
    tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
    outs = []
    for _ in range(3):
        out = block(args[0], kw["scale"], kw["shift"])
        with torch.no_grad():
            want = resblock.reference_conv_gn_mish(
                args[0], block.conv.weight, block.conv.bias, block.norm.weight,
                block.norm.bias, **kw).float()
        assert torch.all((out.float() - want).abs() <= tol * (1 + want.abs()))
        outs.append(out.detach().float())
        opt.zero_grad()
        out.float().square().mean().backward()
        opt.step()
    assert (outs[0] - outs[2]).abs().max() > 10 * tol  # the weights did move


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["foreach", "fused"])
def test_attention_follows_adamw_steps(cuda_device, form):
    """MDM's encoder layer after AdamW steps: the attention kernel's forward
    (planes written per call) equals the plain one on the updated weights."""
    from condmdi_tpu_torch.models.layers import init_params
    from condmdi_tpu_torch.models.mdm import TransformerEncoderLayer

    layer = init_params(TransformerEncoderLayer(512, 4, 1024, device=cuda_device), 0)
    x = torch.randn(8, 197, 512, device=cuda_device)
    opt = torch.optim.AdamW(layer.parameters(), lr=1e-2, weight_decay=0.01, **{form: True})
    for _ in range(3):
        before = attention.fused_self_attention.launches
        out = layer(x)
        assert attention.fused_self_attention.launches == before + 1
        with torch.no_grad():
            q, k, v = layer.qkv(x).chunk(3, dim=-1)
            got = attention.mha(q, k, v, 4)
            want = attention._xla_attention(q, k, v, 4)
        assert torch.all((got - want).abs() <= F32_TOL * (1 + want.abs()))
        opt.zero_grad()
        out.square().mean().backward()
        opt.step()


# Per parameter tensor, the relative error of the gradient and of the update. Set from
# readings on an NVIDIA H100 80GB HBM3 at 700 W (1.9e-05 and 1.6e-04): the gradient at about
# 5x its reading; the update at the float32 rounding of p - u for |p| near 1 (a GroupNorm
# scale), half an ulp, 6e-8, is 6e-4 of an lr-sized update
TRAIN_GRAD_TOL, TRAIN_UPDATE_TOL = 1e-4, 1e-3


@pytest.mark.cuda
def test_train_step_kernel_path_matches_plain(cuda_device):
    """One port train step of a small keyframe UNet (f32, cond dropout on) through
    the kernel and with the halves swapped for the plain version, from the same
    weights, generator state and warmed AdamW state (three steps' moments, so
    that the update is a smooth function of the gradient): the loss, and per
    parameter tensor the gradient and the update, agree. Tolerances: the loss
    1e-4 * (1 + |plain|); |g_kernel - g_plain| / |g_plain| TRAIN_GRAD_TOL and
    |p_kernel - p_plain| / |p_plain - p_start| TRAIN_UPDATE_TOL (norms over the
    tensor)."""
    import copy

    from condmdi_tpu_torch.diffusion import gaussian, schedule
    from condmdi_tpu_torch.models.unet import MDM_UNET
    from condmdi_tpu_torch.training import loop

    model = MDM_UNET(njoints=263, latent_dim=64, dim_mults=(1, 2), keyframe_conditioned=True,
                     pad_frames_to=64, zero=False, device=cuda_device, seed=0).train()
    sched = schedule.DiffusionSchedule.create(
        schedule.get_named_beta_schedule("cosine", 100), device=cuda_device)
    cfg = loop.TrainConfig(lr=1e-4, keyframe_conditioned=True, grad_clip=1.0)
    rng = np.random.default_rng(0)
    lengths = torch.tensor([60, 48, 60, 33], device=cuda_device)
    batch = {"motion": torch.from_numpy(rng.standard_normal((4, 60, 263)).astype(np.float32))
             .to(cuda_device),
             "lengths": lengths,
             "time_mask": torch.arange(60, device=cuda_device)[None] < lengths[:, None],
             "text_embed": torch.randn(4, 512, device=cuda_device)}

    def draws(seed):
        return loop.StepDraws(torch.Generator(cuda_device).manual_seed(seed),
                              torch.Generator().manual_seed(seed + 1))

    def new_step(state_dict):
        state = loop.create_train_state(model, cfg, sched)
        if state_dict is not None:
            state.load_state_dict(copy.deepcopy(state_dict))
        return loop.make_train_step(model, sched, gaussian.DiffusionConfig(), cfg), state

    step, state = new_step(None)
    warm = draws(7)
    for _ in range(3):
        step(state, batch, warm)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    warmed = state.state_dict()
    results = []
    for plain in (False, True):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        step, state = new_step(warmed)
        before = resblock.fused_conv_gn_mish.launches
        with pytest.MonkeyPatch.context() as mp:
            if plain:
                mp.setattr(resblock, "_launch", lambda x, w, b, g, be, s, sh, r, n, eps, p=None:
                           resblock.reference_conv_gn_mish(x, w, b, g, be, s, sh, r, n_groups=n,
                                                           eps=eps))
            metrics = step(state, batch, draws(1))
        launched = resblock.fused_conv_gn_mish.launches - before
        results.append((float(metrics["loss"]), launched,
                        {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                        {n: p.detach().clone() for n, p in model.named_parameters()}))
    (loss_k, launched_k, grads_k, params_k), (loss_p, launched_p, grads_p, params_p) = results
    assert launched_k == 17 and launched_p == 0  # the small UNet's halves, once each
    assert state.step == 4
    assert abs(loss_k - loss_p) <= 1e-4 * (1 + abs(loss_p))
    g_errs = {n: float((grads_k[n] - grads_p[n]).norm() / grads_p[n].norm().clamp(min=1e-30))
              for n in params_p}
    u_errs = {n: float((params_k[n] - params_p[n]).norm()
                       / (params_p[n] - start[n]).norm().clamp(min=1e-30)) for n in params_p}
    worst_g, worst_u = max(g_errs, key=g_errs.get), max(u_errs, key=u_errs.get)
    assert g_errs[worst_g] <= TRAIN_GRAD_TOL, (worst_g, g_errs[worst_g])
    assert u_errs[worst_u] <= TRAIN_UPDATE_TOL, (worst_u, u_errs[worst_u])


# --------------------------------------------------------------------------- #
# CUDA graphs: the sampler step and the train step captured and replayed
# (utils/cuda_graph.py); every replay against the eager call, bit for bit
# --------------------------------------------------------------------------- #
def _replay_against_eager(fn, inputs, refill):
    """`fn()` over the static `inputs` captured by CudaGraph, then the inputs given
    new contents (`refill`): the replay against an eager call on them."""
    from condmdi_tpu_torch.utils.cuda_graph import CudaGraph

    graph = CudaGraph(fn)
    graph()  # the warm-up call and the capture
    assert graph.graph is not None and graph.captures == 1
    refill(inputs)
    got = [t.clone() for t in graph(check=False)]
    torch.cuda.synchronize()
    want = fn()
    assert graph.replays == 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert torch.equal(g, w), (i, float((g - w).abs().max()))


def _refill(seed):
    def refill(inputs):
        gen = torch.Generator(inputs[0].device).manual_seed(seed)
        with torch.no_grad():
            for t in inputs:
                if t.is_floating_point():
                    t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * t.std())
    return refill


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_resblock_launch_replays_from_a_graph(cuda_device, dtype):
    """The resblock launch under no_grad (the served forward), bf16 included, which
    no earlier test captured."""
    args, kw = make_inputs(8, 200, 526, 1024, True, False, getattr(torch, dtype), cuda_device)
    args[0] = torch.nn.functional.pad(args[0], (0, 2))  # the UNet's 528-channel input
    cache = resblock.PackedConvWeight()

    def fn():
        with torch.no_grad():
            return [resblock.fused_conv_gn_mish(*args, **kw, packed=cache)]

    before = resblock.fused_conv_gn_mish.launches
    _replay_against_eager(fn, [args[0], kw["scale"]], _refill(1))
    assert resblock.fused_conv_gn_mish.launches - before == 3  # warm-up, replay, eager


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["conv_gn_mish", "int8_conv1d", "self_attention_bf16",
                                "self_attention_f32"])
def test_autograd_functions_replay_forward_and_backward_from_a_graph(cuda_device, op,
                                                                    monkeypatch):
    """ConvGnMish, Int8Conv1d and fused_self_attention under capture: the kernel
    forward and the plain-recompute backward replayed, against the eager call
    (cuDNN's deterministic algorithms: its default weight gradient sums in an
    order that changes from call to call)."""
    from condmdi_tpu_torch.ops import quant

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)

    gen = torch.Generator(cuda_device).manual_seed(0)

    def rnd(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(shape, generator=gen, device=cuda_device) * s).to(dtype)

    if op == "conv_gn_mish":
        args, kw = make_inputs(4, 224, 1024, 1024, True, True, torch.float32, cuda_device)
        leaves = [*args, *kw.values()]

        def forward(*t):
            return resblock.fused_conv_gn_mish(*t[:5], scale=t[5], shift=t[6], res=t[7])
        counter = resblock.fused_conv_gn_mish
    elif op == "int8_conv1d":
        w = rnd(512, 1024, 3, s=0.02)
        wq, w_scale = quant.quantize_weight_per_channel(w)
        leaves = [rnd(4, 112, 1024), rnd(512, s=0.1)]

        def forward(x, bias):
            return quant.int8_conv1d(x, wq, w_scale, bias, 1, 1)
        counter = quant.int8_conv1d
    else:
        dtype = torch.bfloat16 if op.endswith("bf16") else torch.float32
        qkv = rnd(8, 197, 3 * 512, dtype=dtype)
        leaves = [qkv]

        def forward(t):
            return attention.multihead_attention(t, 4)
        counter = attention.fused_self_attention
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    probe = torch.randn_like(forward(*leaves).float())

    def fn():
        out = forward(*leaves)
        grads = torch.autograd.grad((out.float() * probe).sum(), leaves)
        return [out.detach(), *grads]

    before = counter.launches
    _replay_against_eager(fn, [t.data for t in leaves], _refill(2))
    assert counter.launches - before == 3  # warm-up, replay, eager (the capture launches none)


def _sample_twice(pipe_fn, shape, y, seed, **kw):
    """One DDIM run with graphs and one with cuda_graphs=False from the same seed,
    the launches of each counted."""
    from condmdi_tpu_torch.utils.cuda_graph import launch_counts

    out = []
    for graphs in (True, False):
        pipe = pipe_fn(graphs)
        before = launch_counts()
        x = pipe.sample(shape, y, generator=torch.Generator(cuda_device_of(y)).manual_seed(seed),
                        **kw)
        torch.cuda.synchronize()
        out.append((x, tuple(a - b for a, b in zip(launch_counts(), before)), pipe))
    return out


def cuda_device_of(y):
    return next(v.device for v in y.values() if isinstance(v, torch.Tensor))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["unet_xl_bf16", "mdm", "unet_int8_mixed"])
def test_ddim20_from_graphs_equals_eager(cuda_device, model):
    """A DDIM-20 run (eta 0.5, so every step draws its noise; CFG 2.5) with the
    sampler step replayed from CUDA graphs equals the eager run bit for bit and
    launches the same kernels as often; the mixed step captures two graphs."""
    from condmdi_tpu_torch.diffusion import (DiffusionConfig, DiffusionSchedule, SamplerConfig,
                                             get_named_beta_schedule)
    from condmdi_tpu_torch.models.mdm import MDM
    from condmdi_tpu_torch.models.unet import MDM_UNET, MixedStepDenoiser, cast_weights
    from condmdi_tpu_torch.ops.quant import calibrate_act_scales
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    B, T, F = 2, 196, 263
    gen = torch.Generator(cuda_device).manual_seed(3)
    text = torch.randn(B, 512, generator=gen, device=cuda_device)
    obs = torch.randn(B, T, F, generator=gen, device=cuda_device)
    mask = torch.zeros(B, T, F, dtype=torch.bool, device=cuda_device)
    mask[:, ::10] = True
    kw = {}
    if model == "mdm":
        net = MDM(njoints=F, latent_dim=512, ff_size=1024, num_layers=8, num_heads=4,
                  device=cuda_device, seed=0).eval()

        def apply_fn(x, t, y, **_):
            return net(x, t, y)
    else:
        mode = "int8_static" if model == "unet_int8_mixed" else "float"
        net = MDM_UNET(njoints=F, latent_dim=512, dim_mults=(2, 2, 2, 2), zero=False,
                       keyframe_conditioned=True, pad_frames_to=200, precision_mode=mode,
                       device=cuda_device, seed=0).eval()
        kw = dict(obs_x0=obs, obs_mask=mask)
        if mode == "float":
            cast_weights(net, torch.bfloat16)

            def apply_fn(x, t, y, **o):
                return net(x.to(torch.bfloat16), t, y, **o).float()
        else:
            sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 1000),
                                             device=cuda_device)
            calibrate_act_scales(net, sched, obs, {"text_embed": text}, generator=gen,
                                 obs_x0=obs, obs_mask=mask)
            apply_fn = MixedStepDenoiser(net, 250)
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 1000),
                                     use_timesteps=range(0, 1000, 50))

    def pipe_fn(graphs):
        return SamplePipeline(apply_fn, sched, DiffusionConfig(),
                              SamplerConfig(method="ddim", eta=0.5), device=cuda_device,
                              cuda_graphs=graphs)

    (got, n_graph, pipe), (want, n_eager, _) = _sample_twice(
        pipe_fn, (B, T, F), {"text_embed": text}, 5, guidance_param=2.5, **kw)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, want)
    assert n_graph == n_eager and sum(n_graph) > 0
    (prog,) = pipe.programs.values()
    assert set(prog.graphs) == ({"int8", "float"} if model == "unet_int8_mixed" else {None})
    assert sum(g.replays for g in prog.graphs.values()) == 20 - len(prog.graphs)


@pytest.mark.cuda
def test_gate_conditional_from_graphs_equals_eager(cuda_device, tmp_path, monkeypatch):
    """conditional's main on the committed gate checkpoint (f32, DDIM-20, CFG 2.5,
    imputation): the motions with graphs equal those with cuda_graphs=False bit
    for bit."""
    import functools
    from pathlib import Path

    import condmdi_tpu_torch.sampling.pipeline as pipeline_mod
    from condmdi_tpu_torch.sampling.conditional import main

    ckpt = Path(__file__).resolve().parent.parent / "save" / "synthetic_unet_m" / \
        "gate_ema_000100000.npz"
    argv = ["--model_path", str(ckpt), "--num_samples", "2", "--num_repetitions", "1",
            "--use_ddim", "true", "--timestep_respacing", "ddim20", "--imputate", "true",
            "--guidance_param", "2.5"]
    results = []
    for graphs in (True, False):
        if not graphs:
            monkeypatch.setattr(pipeline_mod, "SamplePipeline", functools.partial(
                pipeline_mod.SamplePipeline, cuda_graphs=False))
        np.random.seed(0)
        out = main(argv + ["--output_dir", str(tmp_path / str(graphs))])
        results.append(np.load(out / "results.npy", allow_pickle=True).item())
    assert np.isfinite(results[0]["motion"]).all()
    assert np.array_equal(results[0]["motion"], results[1]["motion"])


@pytest.mark.cuda
def test_a_weight_change_captures_again(cuda_device):
    """A pipeline's graph captured on one set of weights, then load_state_dict:
    the next run captures again and equals an eager run on the new weights."""
    from condmdi_tpu_torch.diffusion import (DiffusionConfig, DiffusionSchedule, SamplerConfig,
                                             get_named_beta_schedule)
    from condmdi_tpu_torch.models.unet import MDM_UNET
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    cfg = dict(njoints=263, latent_dim=64, dim_mults=(1, 2), keyframe_conditioned=False,
               pad_frames_to=64, zero=False, device=cuda_device)
    net = MDM_UNET(**cfg, seed=0).eval()
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 100),
                                     use_timesteps=range(0, 100, 10))
    y = {"text_embed": torch.randn(2, 512, device=cuda_device)}

    def run(graphs):
        pipe = pipes[graphs]
        return pipe.sample((2, 60, 263), y, generator=torch.Generator(cuda_device).manual_seed(1))

    pipes = {g: SamplePipeline(net, sched, DiffusionConfig(), SamplerConfig(method="ddim"),
                               device=cuda_device, cuda_graphs=g) for g in (True, False)}
    first = run(True)
    assert torch.equal(first, run(False))
    (prog,) = pipes[True].programs.values()
    assert prog.graphs[None].captures == 1
    run(True)
    assert prog.graphs[None].captures == 1  # same weights: replayed
    net.load_state_dict(MDM_UNET(**cfg, seed=1).state_dict())
    second = run(True)
    assert prog.graphs[None].captures == 2
    assert torch.equal(second, run(False)) and not torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["unet", "mdm"])
def test_captured_train_step_equals_the_eager_capturable_step(cuda_device, kind, fused,
                                                             monkeypatch):
    """Five steps of a small UNet (keyframes, condition dropout) or MDM (dropout too)
    replayed from a CUDA graph against five eager steps with the same capturable
    AdamW (foreach or fused): metrics, parameters and EMA bit for bit (cuDNN's
    deterministic algorithms in both)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    from condmdi_tpu_torch.diffusion import gaussian, schedule
    from condmdi_tpu_torch.models.mdm import MDM
    from condmdi_tpu_torch.models.unet import MDM_UNET
    from condmdi_tpu_torch.training import loop

    def build():
        if kind == "unet":
            return MDM_UNET(njoints=263, latent_dim=64, dim_mults=(1, 2),
                            keyframe_conditioned=True, pad_frames_to=64, zero=False,
                            cond_mask_prob=0.3, device=cuda_device, seed=0).train()
        return MDM(njoints=263, latent_dim=64, ff_size=128, num_layers=2, num_heads=4,
                   dropout=0.1, cond_mask_prob=0.3, device=cuda_device, seed=0).train()

    sched = schedule.DiffusionSchedule.create(
        schedule.get_named_beta_schedule("cosine", 100), device=cuda_device)
    cfg = loop.TrainConfig(lr=1e-3, keyframe_conditioned=kind == "unet", grad_clip=1.0,
                           avg_model_beta=0.9, lr_anneal_steps=4)
    rng = np.random.default_rng(0)
    lengths = torch.tensor([60, 48, 60, 33], device=cuda_device)
    batches = [{"motion": torch.from_numpy(rng.standard_normal((4, 60, 263)).astype(np.float32))
                .to(cuda_device), "lengths": lengths,
                "time_mask": torch.arange(60, device=cuda_device)[None] < lengths[:, None],
                "text_embed": torch.randn(4, 512, device=cuda_device)} for _ in range(5)]
    results = []
    for graphs in (True, False):
        model = build()
        state = loop.create_train_state(model, cfg, sched)
        state.optimizer = torch.optim.AdamW(  # make_optimizer's, foreach or fused
            state.params.values(), lr=torch.tensor(cfg.lr, device=cuda_device),
            betas=(0.9, cfg.adam_beta2), eps=1e-8, weight_decay=cfg.weight_decay,
            capturable=True, fused=fused)
        step = loop.make_train_step(model, sched, gaussian.DiffusionConfig(), cfg,
                                    cuda_graphs=graphs)
        assert isinstance(step, loop.BufferedTrainStep) == graphs
        draws = loop.StepDraws(torch.Generator(cuda_device).manual_seed(4),
                               torch.Generator().manual_seed(5))
        metrics = [{k: v.clone() for k, v in step(state, b, draws).items()} for b in batches]
        if graphs:
            assert step.graph.captures == 1 and step.graph.replays == 3
        results.append((metrics, [p.detach().clone() for p in model.parameters()],
                        [e.clone() for e in state.ema.values()]))
    (m_g, p_g, e_g), (m_e, p_e, e_e) = results
    for a, b in zip(m_g, m_e):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p_g + e_g, p_e + e_e))
    assert any(not torch.equal(a, b.detach()) for a, b in zip(p_g, build().parameters()))


@pytest.mark.cuda
def test_steps_per_dispatch_replays_equal_eager_steps(cuda_device, tmp_path, monkeypatch):
    """training.train.main with --steps_per_dispatch 4 (8 steps: two dispatches of
    4 replays) ends on the weights and EMA of the same run with cuda_graphs=False,
    bit for bit (cuDNN's deterministic algorithms in both)."""
    import functools

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)

    import condmdi_tpu_torch.training.train as train_mod

    argv = ["--num_steps", "8", "--save_interval", "100", "--log_interval", "4",
            "--batch_size", "4", "--num_frames", "28", "--latent_dim", "32", "--dim_mults", "1",
            "2", "--diffusion_steps", "8", "--keyframe_conditioned", "true", "--use_fp16",
            "false", "--data_dir", str(tmp_path / "none"), "--text_encoder", "hash",
            "--device_data_cache", "true", "--steps_per_dispatch", "4", "--unet_zero", "false"]
    loops = []
    for graphs in (True, False):
        if not graphs:
            monkeypatch.setattr(train_mod, "TrainLoop", functools.partial(train_mod.TrainLoop,
                                                                          cuda_graphs=False))
        loops.append(train_mod.main(argv + ["--save_dir", str(tmp_path / str(graphs))],
                                    device=cuda_device))
    got, want = loops
    assert got.step_fn.graph.replays == 6 and not hasattr(want.step_fn, "graph")
    # every entry compared before the verdict, so that a failure names the first
    # parameter or EMA entry that parted, with its largest difference and the count
    pairs = [(f"param {name}", a, b) for (name, a), b in
             zip(got.model.state_dict().items(), want.model.state_dict().values())]
    pairs += [(f"ema {k}", got.state.ema[k], want.state.ema[k]) for k in want.state.ema]
    parted = [(name, float((a.float() - b.float()).abs().max())) for name, a, b in pairs
              if not torch.equal(a, b)]
    assert not parted, (f"{len(parted)} of {len(pairs)} entries parted; first: {parted[0][0]}, "
                        f"largest |graph - eager| {parted[0][1]:.3e}")


# --------------------------------------------------------------------------- #
# GMD: the trajectory model's resblock shapes, stage 2 and PLMS from graphs
# --------------------------------------------------------------------------- #
def traj_unet(device, xz_only):
    """traj_unet_adagn_swx at full width (latent 512, dim_mults 0.125 0.25 0.5, pad 224)."""
    from condmdi_tpu_torch.models.unet import MDM_UNET

    return MDM_UNET(njoints=4, latent_dim=512, dim_mults=(0.125, 0.25, 0.5), zero=False,
                    pad_frames_to=224, xz_only=xz_only, device=device, seed=3).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("xz_only", [False, True], ids=["four_features", "xz_only"])
@pytest.mark.parametrize("B", [2, 32])
def test_trajectory_model_halves_match_plain(cuda_device, xz_only, B):
    """Every resblock half of the trajectory model's forward, as the forward hands
    it over (group widths 8, 16, 32; a first layer of 4 or 2 channels in a row of
    8), kernel against plain in float32."""
    from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock, Conv1dBlock

    model = traj_unet(cuda_device, xz_only)
    calls = []

    def hook(mod, args, kwargs, out):
        ada = isinstance(mod, Conv1dAdaGNBlock)
        scale, shift = (args[1], args[2]) if ada else (None, None)
        res = None if ada else kwargs.get("res", args[1] if len(args) > 1 else None)
        want = resblock.reference_conv_gn_mish(
            args[0], mod.conv.weight, mod.conv.bias, mod.norm.weight, mod.norm.bias,
            scale=scale, shift=shift, res=res)
        calls.append((mod.conv.weight.shape[1], mod.conv.weight.shape[0], args[0].shape[2],
                      out, want))

    handles = [m.register_forward_hook(hook, with_kwargs=True) for m in model.modules()
               if isinstance(m, (Conv1dBlock, Conv1dAdaGNBlock))]
    gen = torch.Generator(cuda_device).manual_seed(B)
    x = torch.randn(B, 196, 4, generator=gen, device=cuda_device)
    before = resblock.fused_conv_gn_mish.launches
    with torch.no_grad():
        model(x, torch.full((B,), 400, device=cuda_device),
              {"text_embed": torch.randn(B, 512, generator=gen, device=cuda_device)})
    for h in handles:
        h.remove()
    assert resblock.fused_conv_gn_mish.launches == before + 25 == before + len(calls)
    assert {cout // 8 for _, cout, *_ in calls} == {8, 16, 32}
    assert (calls[0][0], calls[0][2]) == ((2, 8) if xz_only else (4, 8))
    for cin, cout, xc, got, want in calls:
        assert torch.isfinite(got).all()
        assert torch.all((got - want).abs() <= F32_TOL * (1 + want.abs())), (cin, cout, xc)


@pytest.mark.cuda
def test_trajectory_model_guided_gradient_matches_plain(cuda_device):
    """d(-loss)/dx of a GMD guidance loss through the trajectory model: the kernel
    forward with its plain-recompute backward against the plain forward's."""
    import condmdi_tpu_torch.models.unet as unet_mod
    from condmdi_tpu_torch.sampling.gmd import CondKeyLocations, get_kframes, kframes_to_target
    from condmdi_tpu_torch.utils.assets import NormStats

    model = traj_unet(cuda_device, False).requires_grad_(False)
    B = 2
    target, mask = kframes_to_target(get_kframes("zigzag"), B, 196, cuda_device)
    guide = CondKeyLocations(target, mask, NormStats(np.zeros(4, np.float32),
                                                     np.ones(4, np.float32)), traj_only=True)
    gen = torch.Generator(cuda_device).manual_seed(5)
    x = torch.randn(B, 196, 4, generator=gen, device=cuda_device)
    y = {"text_embed": torch.randn(B, 512, generator=gen, device=cuda_device)}
    t = torch.full((B,), 300, device=cuda_device)

    def grad():
        z = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(-guide.loss_fn(model(z, t, y), t), z)
        return g

    got = grad()
    kernel_fn = unet_mod.fused_conv_gn_mish
    unet_mod.fused_conv_gn_mish = lambda *a, packed=None, **kw: resblock.reference_conv_gn_mish(
        *a, **kw)
    try:
        want = grad()
    finally:
        unet_mod.fused_conv_gn_mish = kernel_fn
    assert want.abs().max() > 0
    assert torch.all((got - want).abs() <= F32_TOL * (1 + want.abs()))


def _gmd_motion_pipes(cuda_device, method="ddpm", order=2):
    from condmdi_tpu_torch.diffusion import (DiffusionConfig, DiffusionSchedule, SamplerConfig,
                                             get_named_beta_schedule)
    from condmdi_tpu_torch.models.unet import MDM_UNET
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    net = MDM_UNET(njoints=263, latent_dim=512, dim_mults=(2, 2, 2, 2), zero=False,
                   pad_frames_to=224, device=cuda_device, seed=0).eval()
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 1000),
                                     use_timesteps=range(0, 1000, 50))
    return [SamplePipeline(lambda x, t, y, **_: net(x, t, y), sched, DiffusionConfig(),
                           SamplerConfig(method=method, order=order), device=cuda_device,
                           cuda_graphs=graphs) for graphs in (True, False)]


@pytest.mark.cuda
def test_gmd_stage_two_from_graphs_equals_eager(cuda_device):
    """two_stage_generate's second stage (UNet-XL imputing the stage-1 trajectory,
    DDPM-20) replayed from CUDA graphs equals the eager run bit for bit, with the
    same launches; stage 1 (guided) runs eagerly in both."""
    from condmdi_tpu_torch.diffusion import (DiffusionConfig, DiffusionSchedule, SamplerConfig,
                                             get_named_beta_schedule)
    from condmdi_tpu_torch.sampling.gmd import get_kframes, two_stage_generate
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline
    from condmdi_tpu_torch.utils.assets import NormStats
    from condmdi_tpu_torch.utils.cuda_graph import launch_counts

    traj = traj_unet(cuda_device, False).requires_grad_(False)
    traj_pipe = SamplePipeline(lambda x, t, y, **_: traj(x, t, y), DiffusionSchedule.create(
        get_named_beta_schedule("cosine", 1000), use_timesteps=range(0, 1000, 50)),
        DiffusionConfig(), SamplerConfig(), device=cuda_device)
    stats = NormStats(np.zeros(263, np.float32), np.ones(263, np.float32))
    gen = torch.Generator(cuda_device).manual_seed(7)
    B = 2
    y = {"text_embed": torch.randn(B, 512, generator=gen, device=cuda_device)}
    traj_x = torch.randn(B, 196, 4, generator=gen, device=cuda_device)
    motion_x = torch.randn(B, 196, 263, generator=gen, device=cuda_device)
    outs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # stage 1's gradients, the same both times
    try:
        for pipe in _gmd_motion_pipes(cuda_device):
            before = launch_counts()
            got = two_stage_generate(traj_pipe, pipe, get_kframes("zigzag"), B, 196, stats,
                                     stats, y, y, classifier_scale=1.0, traj_noise=traj_x,
                                     motion_noise=motion_x,
                                     generator=torch.Generator(cuda_device).manual_seed(9))
            torch.cuda.synchronize()
            outs.append((got, tuple(a - b for a, b in zip(launch_counts(), before)), pipe))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ((traj_g, x_g), n_g, pipe_g), ((traj_e, x_e), n_e, _) = outs
    assert torch.equal(traj_g, traj_e)  # the same guided stage 1 (eager, same draws)
    assert torch.isfinite(x_g).all() and torch.equal(x_g, x_e) and n_g == n_e
    assert n_g[0] == (25 + 33) * 20
    (prog,) = pipe_g.programs.values()
    assert prog.buffered and sum(g.replays for g in prog.graphs.values()) == 19


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2, 4])
def test_plms_from_graphs_equals_eager(cuda_device, order):
    """PLMS over 20 steps (UNet-XL f32, CFG 2.5): the first step eager, the multistep
    body replayed from a CUDA graph with the eps history in its buffers, equals the
    eager loop bit for bit with the same launches."""
    from condmdi_tpu_torch.utils.cuda_graph import launch_counts

    gen = torch.Generator(cuda_device).manual_seed(11)
    y = {"text_embed": torch.randn(2, 512, generator=gen, device=cuda_device)}
    noise = torch.randn(2, 196, 263, generator=gen, device=cuda_device)
    outs = []
    for pipe in _gmd_motion_pipes(cuda_device, "plms", order):
        before = launch_counts()
        x = pipe.sample((2, 196, 263), y, guidance_param=2.5, noise=noise)
        torch.cuda.synchronize()
        outs.append((x, tuple(a - b for a, b in zip(launch_counts(), before)), pipe))
    (got, n_g, pipe_g), (want, n_e, _) = outs
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, want) and n_g == n_e
    assert n_g[0] == 33 * (20 + (order > 1))
    (prog,) = pipe_g.programs.values()
    assert sum(g.replays for g in prog.graphs.values()) == 19 - 1  # the first body step captures


# --------------------------------------------------------------------------- #
# the action-to-motion and unconstrained protocols' shapes (evals.run_a2m,
# evals.run_unconstrained): MDM at B=32, 60 frames + the condition token
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("D,route", [(64, "stream"), (512, "wgmma_f32")])
def test_attention_kernel_at_the_a2m_shapes(cuda_device, D, route):
    """float32 at T = 61 (not a multiple of 16): the CLIs' default width (hd 16, the
    streaming kernel behind its pack pass) and the MDM paper's a2m width (hd 128,
    the resident kernel on hi/lo planes)."""
    B, T, H = 32, 61, 4
    assert attention.attention_route(B, T, H, D // H, torch.float32) == route
    q, k, v = qkv_views(B, T, D, torch.float32, cuda_device, seed=D)
    before = attention.fused_self_attention.launches
    with torch.no_grad():
        got = attention.mha(q, k, v, H)
        torch.cuda.synchronize()
        want = attention._xla_attention(q, k, v, H)
    assert attention.fused_self_attention.launches == before + 1
    assert got.shape == (B, T, D) and torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= F32_TOL * (1 + want.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gru", "trans_enc"])
def test_a2m_mdm_from_graphs_equals_eager(cuda_device, arch):
    """An action MDM at the a2m width (latent 512, 8 layers, B=32, 60 frames) sampled
    over 20 DDPM steps with the sampler step replayed from CUDA graphs equals the
    eager run bit for bit with the same launches: the GRU (8 layers x 60 steps of
    small products a forward, no kernel of the port) and trans_enc (8 attention
    launches a forward)."""
    from condmdi_tpu_torch.diffusion import (DiffusionConfig, DiffusionSchedule, SamplerConfig,
                                             get_named_beta_schedule)
    from condmdi_tpu_torch.models.mdm import MDM
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    B, T, F = 32, 60, 150
    net = MDM(njoints=25, nfeats=6, latent_dim=512, ff_size=1024, num_layers=8, num_heads=4,
              arch=arch, cond_mode="action", num_actions=12, device=cuda_device, seed=0).eval()
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 1000),
                                     use_timesteps=range(0, 1000, 50))
    y = {"action": torch.arange(B, device=cuda_device) % 12}

    def pipe_fn(graphs):
        return SamplePipeline(lambda x, t, y_, **_: net(x, t, y_), sched, DiffusionConfig(),
                              SamplerConfig(), device=cuda_device, cuda_graphs=graphs)

    (got, n_graph, pipe), (want, n_eager, _) = _sample_twice(pipe_fn, (B, T, F), y, 7)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, want) and n_graph == n_eager
    assert n_graph[1] == (8 * 20 if arch == "trans_enc" else 0)  # fused_self_attention
    (prog,) = pipe.programs.values()
    assert sum(g.replays for g in prog.graphs.values()) == 19


# --------------------------------------------------------------------------- #
# the float32 dense kernel (csrc/dense.cu, the tf32x3 route of MDM's projections)
# --------------------------------------------------------------------------- #
DENSE_ERR_RATIO = 4.0  # the kernel's largest error, at most this many times cuBLAS float32's
MDM_PROJECTIONS = [(512, 1536), (512, 512), (512, 1024), (1024, 512)]  # qkv, attn_out, ff1, ff2


def dense_operands(M, K, N, device, seed=0):
    """x ~ N(0, 1) (a LayerNorm's output), W LeCun-normal, b ~ N(0, 0.02^2)."""
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=device)
    w = torch.randn((N, K), generator=gen, device=device) * K ** -0.5
    return x, w, torch.randn((N,), generator=gen, device=device) * 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("M", [64 * 197, 32 * 61, 4 * 197])  # run_t2m / the cell, a2m, edit
@pytest.mark.parametrize("K,N", MDM_PROJECTIONS)
def test_dense_kernel_error_is_float32s(cuda_device, K, N, M, bias):
    """Against a float64 product, the kernel's largest error is within DENSE_ERR_RATIO
    of cuBLAS's float32 product's (TF32 off) on the same operands; cuBLAS in TF32 is
    not, so the bound has teeth."""
    from condmdi_tpu_torch.ops import dense as dense_ops

    x, w, b = dense_operands(M, K, N, cuda_device, seed=M + K + N)
    b = b if bias else None
    want = x.double() @ w.double().T + (0 if b is None else b.double())
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        f32 = torch.nn.functional.linear(x, w, b)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = torch.nn.functional.linear(x, w, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    before = dense_ops.dense.launches
    with torch.no_grad():
        got = dense_ops.dense(x, dense_ops.split_weight(w), b)
    torch.cuda.synchronize()
    assert dense_ops.dense.launches == before + 1
    err = {k: (v.double() - want).abs().max().item()
           for k, v in (("kernel", got), ("f32", f32), ("tf32", tf32))}
    assert torch.isfinite(got).all()
    assert err["kernel"] <= DENSE_ERR_RATIO * err["f32"], err
    assert err["tf32"] > DENSE_ERR_RATIO * err["f32"], err


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(5, 16, 16), (129, 48, 80), (300, 1040, 208)])
def test_dense_kernel_at_ragged_tiles(cuda_device, M, K, N):
    """Rows, columns and depth that fill no tile, on either tile width: the kernel
    against its plain version, to float32's rounding."""
    from condmdi_tpu_torch.ops import dense as dense_ops

    x, w, b = dense_operands(M, K, N, cuda_device, seed=K)
    planes = dense_ops.split_weight(w)
    with torch.no_grad():
        got = dense_ops.dense(x.reshape(1, M, K), planes, b)
        want = dense_ops.tf32x3_linear(x, planes, b)
    assert got.shape == (1, M, N)
    assert torch.all((got[0] - want).abs() <= 1e-5 * (1 + want.abs()))


@pytest.mark.cuda
def test_dense_kernel_replays_from_a_graph(cuda_device):
    """The launch captured by CudaGraph and replayed on new contents of x equals the
    eager call bit for bit."""
    from condmdi_tpu_torch.ops import dense as dense_ops

    x, w, b = dense_operands(4 * 197, 512, 1536, cuda_device)
    planes = dense_ops.split_weight(w)

    def fn():
        with torch.no_grad():
            return [dense_ops.dense(x, planes, b)]

    before = dense_ops.dense.launches
    _replay_against_eager(fn, [x], _refill(3))
    assert dense_ops.dense.launches - before == 3  # warm-up, replay, eager


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,per_forward", [("float32", 32), ("bfloat16", 0)])
def test_dense_launches_in_a_captured_mdm_forward(cuda_device, dtype, per_forward):
    """One MDM forward (latent 512, 8 layers, B=4, 196 frames) captured by CudaGraph:
    in float32 every encoder projection takes the kernel (32 launches, 32 tf32x3
    routes), in bfloat16 none; a replay adds the launches again and equals the eager
    forward bit for bit."""
    from condmdi_tpu_torch.models.mdm import MDM
    from condmdi_tpu_torch.ops.dense import dense

    dt = getattr(torch, dtype)
    net = MDM(latent_dim=512, ff_size=1024, num_layers=8, num_heads=4, device=cuda_device,
              seed=0).to(dt).eval()
    gen = torch.Generator(cuda_device).manual_seed(5)
    x = torch.randn((4, 196, 263), generator=gen, device=cuda_device).to(dt)
    t = torch.full((4,), 500, device=cuda_device)
    y = {"text_embed": torch.randn((4, 512), generator=gen, device=cuda_device)}

    def fn():
        with torch.no_grad():
            return [net(x, t, y)]

    launches, routes = dense.launches, dict(dense.routes)
    _replay_against_eager(fn, [x], _refill(4))
    assert dense.launches - launches == 3 * per_forward  # warm-up, replay, eager
    taken = {k: dense.routes[k] - routes[k] for k in routes}
    # the warm-up, the capture and the eager call run the Python forward; a replay does not
    assert taken == ({"tf32x3": 3 * 32, "cublas": 0} if per_forward else {"tf32x3": 0, "cublas": 0})


@pytest.mark.cuda
def test_qdense_takes_cublas_where_a_gradient_is_needed(cuda_device):
    """Under autograd with a weight that requires grad, QDense takes F.linear (the
    kernel has no backward) and the gradient flows; under no_grad, the kernel."""
    from condmdi_tpu_torch.models.mdm import QDense
    from condmdi_tpu_torch.ops.dense import dense

    layer = QDense(512, 512, device=cuda_device)
    torch.nn.init.normal_(layer.weight, std=512 ** -0.5)
    torch.nn.init.normal_(layer.bias, std=0.02)
    x = torch.randn((4, 197, 512), device=cuda_device)
    routes, launches = dict(dense.routes), dense.launches
    out = layer(x)
    out.sum().backward()
    assert layer.weight.grad is not None
    with torch.no_grad():
        again = layer(x)
    assert dense.launches - launches == 1
    assert {k: dense.routes[k] - routes[k] for k in routes} == {"tf32x3": 1, "cublas": 1}
    assert torch.allclose(again, out.detach(), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["depth", "width", "dtype"])
def test_dense_wrapper_refuses_what_the_kernel_does_not_take(cuda_device, bad):
    from condmdi_tpu_torch.ops import dense as dense_ops

    K, N = (40, 64) if bad == "depth" else (64, 40) if bad == "width" else (64, 64)
    x, w, b = dense_operands(256, K, N, cuda_device)
    planes = dense_ops.split_weight(w)
    if bad == "dtype":
        x = x.to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        dense_ops.dense(x, planes, b)


BF16_FORWARD_REL_RMS = 2e-2  # chip_smoke.py's bound on a whole bf16 forward, kernel against plain
BF16_FORWARD_OUTLIER = 2.0 ** -4


def _dit_xl(device):
    """DiT-XL/2 as the benchmark's dit_xl_t2m builds it (dit_prenorm, depth 28, hidden
    1152, 16 heads, MLP 4,608) in bfloat16, LeCun-normal kernels from a seed (the
    adaLN and output Denses too, which the card initialises to zero), small biases."""
    from condmdi_tpu_torch.models.dit import MDM_DiT
    from condmdi_tpu_torch.models.unet import cast_weights

    model = MDM_DiT(latent_dim=1152, ff_size=4608, num_layers=28, num_heads=16,
                    device=device, seed=None)
    gen = torch.Generator(device).manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            scale = p.shape[1] ** -0.5 if p.ndim == 2 else 0.02
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * scale)
    return cast_weights(model.eval(), torch.bfloat16)


@pytest.mark.cuda
def test_dit_xl_bf16_forward_matches_plain(cuda_device, monkeypatch):
    """One DiT-XL forward at B=2 in bfloat16 (every self-attention at hd 72 on the
    streaming route through its pack pass) against the same forward with the
    attention launch swapped for its plain version: chip_smoke.py's whole-forward
    bounds, a relative rms of 2e-2 and no element past 2^-4 * (1 + |plain|)."""
    model = _dit_xl(cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(1)
    x = torch.randn((2, 196, 263), generator=gen, device=cuda_device).bfloat16()
    t = torch.tensor([10, 900], device=cuda_device)
    y = {"text_embed": torch.randn((2, 512), generator=gen, device=cuda_device),
         "uncond": torch.tensor([False, True], device=cuda_device)}
    routes = dict(attention.fused_self_attention.routes)
    with torch.no_grad():
        got = model(x, t, y).float()
        assert {k: v - routes[k] for k, v in attention.fused_self_attention.routes.items()} \
            == {"wgmma": 0, "wgmma_f32": 0, "stream": 0, "stream_packed": 28}
        monkeypatch.setattr(attention, "_launch",
                            lambda q, k, v, heads: attention._xla_attention(q, k, v, heads))
        want = model(x, t, y).float()
    err = (got - want).abs()
    rel_rms = float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    assert torch.isfinite(got).all() and want.abs().max() > 0
    assert rel_rms <= BF16_FORWARD_REL_RMS, rel_rms
    assert int((err > BF16_FORWARD_OUTLIER * (1 + want.abs())).sum()) == 0


@pytest.mark.cuda
def test_dit_xl_routes_count_a_capture_and_not_its_replays(cuda_device):
    """The DiT-XL forward at the offline cell's B=64 captured by CudaGraph: the
    warm-up and the capture each count one "stream_packed" call a block, a replay
    counts none (and adds its 28 launches), and the replay equals the eager forward."""
    model = _dit_xl(cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(2)
    x = torch.randn((64, 196, 263), generator=gen, device=cuda_device).bfloat16()
    t = torch.full((64,), 500, device=cuda_device)
    y = {"text_embed": torch.randn((64, 512), generator=gen, device=cuda_device),
         "uncond": torch.arange(64, device=cuda_device) >= 32}

    def fn():
        with torch.no_grad():
            return [model(x, t, y)]

    from condmdi_tpu_torch.utils.cuda_graph import CudaGraph

    fsa = attention.fused_self_attention
    routes, launches = dict(fsa.routes), fsa.launches
    graph = CudaGraph(fn)
    graph()  # the warm-up call and the capture
    assert graph.captures == 1
    captured = {k: v - routes[k] for k, v in fsa.routes.items()}
    assert captured == {"wgmma": 0, "wgmma_f32": 0, "stream": 0, "stream_packed": 2 * 28}
    routes, launches = dict(fsa.routes), fsa.launches
    got = graph(check=False)[0].clone()
    torch.cuda.synchronize()
    assert fsa.routes == routes and fsa.launches == launches + 28
    want = fn()[0]
    assert torch.equal(got, want)
