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
