"""The Hopper kernels of condmdi_tpu_torch against their plain versions, on a card.

Every test here is marked `cuda` and skips where there is no GPU. The file
imports torch and the port only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from condmdi_tpu_torch.ops import resblock

BF16_TOL = 2.0 ** -7  # |kernel - plain| <= tol * (1 + |plain|): ~2 bf16 ulps
F32_TOL = 5e-4        # the kernel's hi+lo bf16 split keeps ~16 mantissa bits


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
def test_kernel_refuses_autograd(cuda_device):
    args, _ = make_inputs(2, 16, 24, 32, False, False, torch.float32, cuda_device)
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        resblock.fused_conv_gn_mish(*args)
