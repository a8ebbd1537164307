"""The port's fused resblock half (condmdi_tpu_torch/ops/resblock.py) against
the JAX package's: its plain version against JAX's XLA reference and against
the Pallas kernel in interpret mode, on the CPU; and the wrapper's refusal
to fall back. The Hopper kernel itself is held to its plain version on the
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


def test_card_path_refuses_autograd(monkeypatch):
    """Reconstruction guidance needs the backward kernel: on the card path a
    grad-requiring input raises NotImplementedError instead of going plain."""
    monkeypatch.setattr(resblock, "reference_conv_gn_mish", _never_plain)
    args, kw = make_inputs(2, 16, 24, 32, adagn=False, res=False)
    targs, _ = to_torch(args, kw)
    x = targs[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        resblock._launch(x, *targs[1:], None, None, None, 8, 1e-5)


@pytest.mark.parametrize("bad", ["group_width", "dtype", "weight"])
def test_card_path_rejects_what_the_kernel_does_not_take(bad):
    args, kw = make_inputs(2, 16, 24, 32, adagn=False, res=False)
    (x, w, b, g, be), _ = to_torch(args, kw)
    groups = 8
    if bad == "group_width":
        x, w = torch.zeros(1, 4, 8), torch.zeros(2048, 8, 5)
        b = g = be = torch.zeros(2048)
    elif bad == "dtype":
        x = x.double()
    else:
        w = w[..., :4]
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
