"""Fused conv1d → GroupNorm → (AdaGN) → Mish (→ +residual): one resblock half.

Counterpart of condmdi_tpu/ops/resblock.py. `fused_conv_gn_mish` is what
every Conv1dBlock / Conv1dAdaGNBlock of the UNet calls:

  * a CUDA tensor goes to the hand-written Hopper kernel
    (csrc/resblock.cu, built and bound by ops/_build.py), or the call
    raises; it never falls back to the plain version;
  * a CPU tensor goes to `reference_conv_gn_mish`, the plain PyTorch version
    of the same function, in float32.

`fused_conv_gn_mish.launches` counts kernel launches, and nothing else, so a
run can show that its resblock halves went through the kernel.

Layouts follow the JAX package: x [B, T, Cin], res and the output
[B, T, Cout]; the weight is in torch's Conv1d layout [Cout, Cin, k].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

# dynamic shared memory a block may use on sm_90 (227 KB)
_MAX_SMEM = 232448
_BLOCK_N = 128  # output channels one CTA holds: the group width's upper bound
_TAPS = 5  # the conv width the kernel is built for (every resblock half)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mish(x: torch.Tensor) -> torch.Tensor:
    """x · tanh(softplus(x)); softplus as max(x, 0) + log1p(exp(-|x|))."""
    return x * torch.tanh(torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs())))


def reference_conv_gn_mish(
    x, w, b, gamma, beta, scale=None, shift=None, res=None, *, n_groups=8, eps=1e-5,
):
    """The plain PyTorch version, in float32; returns x's dtype.

    GroupNorm statistics are per (batch item, group) over all of T and the
    group's channels, with the biased variance, as Flax's GroupNorm.
    """
    k = w.shape[-1]
    y = F.conv1d(
        x.float().transpose(1, 2), w.float(), b.float(), padding=k // 2
    ).transpose(1, 2)  # [B, T, C]
    B, T, C = y.shape
    g = y.reshape(B, T, n_groups, C // n_groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), unbiased=False, keepdim=True)
    g = (g - mean) * torch.rsqrt(var + eps)
    y = g.reshape(B, T, C) * gamma.float() + beta.float()
    if scale is not None:
        y = y * (1.0 + scale[:, None, :].float()) + shift[:, None, :].float()
    y = mish(y)
    if res is not None:
        y = y + res.float()
    return y.to(x.dtype)


def fused_conv_gn_mish(
    x: torch.Tensor,                       # [B, T, Cin]
    w: torch.Tensor,                       # [Cout, Cin, k]
    b: torch.Tensor,                       # [Cout]
    gamma: torch.Tensor,                   # [Cout]
    beta: torch.Tensor,                    # [Cout]
    scale: Optional[torch.Tensor] = None,  # [B, Cout] (AdaGN)
    shift: Optional[torch.Tensor] = None,  # [B, Cout]
    res: Optional[torch.Tensor] = None,    # [B, T, Cout] residual added after Mish
    *,
    n_groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """One fused Conv1d(k, SAME) → GroupNorm → [AdaGN] → Mish [→ +res]."""
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if x.device.type == "cpu":
        return reference_conv_gn_mish(
            x, w, b, gamma, beta, scale, shift, res, n_groups=n_groups, eps=eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_gn_mish: unsupported device {x.device}")
    return _launch(x, w, b, gamma, beta, scale, shift, res, n_groups, eps)


fused_conv_gn_mish.launches = 0


def smem_bytes(T: int, k: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA (mirrors Smem<T, K>::bytes in csrc/resblock.cu)."""
    split = 2 if dtype == torch.float32 else 1
    bk = 16 if dtype == torch.float32 else 32
    sk = bk + 8
    acc = T * (_BLOCK_N + 4) * 4
    xs = split * (128 + k - 1) * sk * 2
    ws = split * k * _BLOCK_N * sk * 2
    return acc + xs + ws + 64 * 4


def _launch(x, w, b, gamma, beta, scale, shift, res, n_groups, eps):
    tensors = [x, w, b, gamma, beta] + [t for t in (scale, shift, res) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "fused_conv_gn_mish has no backward kernel yet; call it under "
            "torch.no_grad() on CUDA"
        )
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_conv_gn_mish: unsupported dtype {x.dtype}")
    if any(t.dtype != x.dtype or t.device != x.device for t in tensors):
        raise TypeError("fused_conv_gn_mish: all inputs must share x's dtype and device")
    B, T, cin = x.shape
    cout, wcin, k = w.shape
    if wcin != cin:
        raise ValueError(f"fused_conv_gn_mish: weight {tuple(w.shape)} does not take Cin={cin}")
    if k != _TAPS:
        raise NotImplementedError(f"the kernel is built for k={_TAPS} taps, not {k}")
    if cout % n_groups:
        raise ValueError(f"Cout={cout} is not a multiple of n_groups={n_groups}")
    if cout // n_groups > _BLOCK_N:
        raise NotImplementedError(
            f"group width {cout // n_groups} > {_BLOCK_N}: one CTA holds one group"
        )
    if smem_bytes(T, k, x.dtype) > _MAX_SMEM:
        raise NotImplementedError(f"T={T} does not fit one CTA's shared memory")
    for name, t, shape in (("b", b, (cout,)), ("gamma", gamma, (cout,)),
                           ("beta", beta, (cout,)), ("res", res, (B, T, cout))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    ss_stride = 0
    if scale is not None:
        for t in (scale, shift):
            if tuple(t.shape) != (B, cout) or t.stride(1) != 1:
                raise ValueError("scale/shift must be [B, Cout] with unit column stride")
        if scale.stride(0) != shift.stride(0):
            raise ValueError("scale and shift must share a row stride")
        ss_stride = scale.stride(0)

    x = x.contiguous()
    w = w.contiguous()
    res = res.contiguous() if res is not None else None
    out = torch.empty((B, T, cout), device=x.device, dtype=x.dtype)

    from condmdi_tpu_torch.ops import _build

    lib = _build.load_resblock()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)  # noqa: E731
    err = lib.condmdi_resblock_forward(
        ptr(x), ptr(w), ptr(b.contiguous()), ptr(gamma.contiguous()),
        ptr(beta.contiguous()), ptr(scale), ptr(shift), ctypes.c_longlong(ss_stride),
        ptr(res), ptr(out),
        B, T, cin, cout, k, n_groups, ctypes.c_float(eps), _DTYPE_CODES[x.dtype],
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"resblock kernel launch failed: {_build.error_string(lib, err)}")
    fused_conv_gn_mish.launches += 1
    return out
