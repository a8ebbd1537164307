"""The port's attention (condmdi_tpu_torch/ops/attention.py) against the JAX
package's, on the CPU: the plain version against JAX's `_xla_attention` (self,
cross and causal) and against the Pallas kernel in interpret mode; the
recompute backward against `jax.vjp`; and the dispatch, which on the CPU never
builds or launches the kernel. The Hopper kernel itself is held to its plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

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


@pytest.mark.parametrize("bad", ["head_dim", "head_dim_wide", "heads", "dtype", "mismatch",
                                 "shape"])
def test_card_path_rejects_what_the_kernel_does_not_take(bad):
    q = k = v = torch.zeros(2, 5, 64)
    H = 4
    if bad == "head_dim":
        H = 16  # hd = 4, not a multiple of 8
    elif bad == "head_dim_wide":
        q = k = v = torch.zeros(2, 5, 512)
        H = 2  # hd = 256 > 128
    elif bad == "heads":
        H = 5
    elif bad == "dtype":
        q = k = v = q.double()
    elif bad == "mismatch":
        k = k.bfloat16()
    else:
        k = torch.zeros(2, 6, 64)
    with pytest.raises((ValueError, TypeError, NotImplementedError)):
        attention._launch(q, k, v, H)


def test_other_devices_raise():
    q = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        attention.fused_self_attention.apply(q, q, q, 2)
