"""Multi-head attention: the fused self-attention kernel and its plain version.

Counterpart of condmdi_tpu/ops/attention.py, with the same names:

  * `fused_self_attention` is a `torch.autograd.Function`. Its forward sends
    a CUDA tensor to the hand-written Hopper kernel (csrc/attention.cu, built
    and bound by ops/_build.py) or raises; it never falls back to the plain
    version. A CPU tensor takes `_xla_attention`, the plain PyTorch version.
    Its backward recomputes the softmax in plain torch, formula for formula
    as the JAX package's `_fused_bwd` does in XLA: that backward was never a
    Pallas kernel.
  * `mha` sends self-attention (equal query and key lengths) on a CUDA
    tensor to `fused_self_attention`; cross-attention, causal attention and
    every CPU tensor go to `_xla_attention`.
  * `multihead_attention` splits a fused [B, T, 3D] QKV projection into
    three column views, so the kernel reads the heads in place.

`fused_self_attention.launches` counts kernel launches, and nothing else.
The layout follows the JAX package: q [B, Tq, D], k/v [B, Tk, D], heads are
the contiguous hd = D / H column blocks.
"""

from __future__ import annotations

import ctypes
import math

import torch

_MAX_HEAD_DIM = 128  # the widest head the kernel takes (multiples of 8)
_MAX_GRID_Z = 65535  # CUDA's limit on the grid's batch dimension
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, num_heads, D // num_heads).transpose(1, 2)  # [B, H, T, hd]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, hd = x.shape
    return x.transpose(1, 2).reshape(B, T, H * hd)


def _xla_attention(q, k, v, num_heads: int, causal: bool = False) -> torch.Tensor:
    """The plain version: softmax(q kᵀ / √hd) v per head, in float32; returns q's dtype."""
    Tq, Tk = q.shape[1], k.shape[1]
    hd = q.shape[-1] // num_heads
    qh, kh, vh = (_split_heads(t.float(), num_heads) for t in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd)
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()  # col <= row
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return _merge_heads(torch.einsum("bhqk,bhkd->bhqd", probs, vh)).to(q.dtype)


def _fused_bwd(num_heads: int, q, k, v, g):
    """(dq, dk, dv) of self-attention, recomputing the softmax (JAX `_fused_bwd`)."""
    qh, kh, vh, gh = (_split_heads(t.float(), num_heads) for t in (q, k, v, g))
    scale = 1.0 / math.sqrt(qh.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gh)
    dp = torch.einsum("bhqd,bhkd->bhqk", gh, vh)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale
    return tuple(_merge_heads(d).to(t.dtype) for d, t in ((dq, q), (dk, k), (dv, v)))


class fused_self_attention(torch.autograd.Function):  # noqa: N801 (the JAX package's name)
    """Self-attention of q, k, v [B, T, D]: the kernel forward, a recompute backward.

    Call as `fused_self_attention.apply(q, k, v, num_heads)`.
    """

    launches = 0

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return _xla_attention(q, k, v, num_heads)
        if q.device.type != "cuda":
            raise ValueError(f"fused_self_attention: unsupported device {q.device}")
        return _launch(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_fused_bwd(ctx.num_heads, q, k, v, g), None)


def mha(q, k, v, num_heads: int) -> torch.Tensor:
    """General multi-head attention. q [B, Tq, D]; k, v [B, Tk, D] → [B, Tq, D]."""
    if q.device.type == "cuda" and q.shape[1] == k.shape[1]:
        return fused_self_attention.apply(q, k, v, num_heads)
    return _xla_attention(q, k, v, num_heads)


def multihead_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention from a fused QKV projection [B, T, 3D] → [B, T, D]."""
    q, k, v = qkv.chunk(3, dim=-1)
    return mha(q, k, v, num_heads)


def _launch(q, k, v, num_heads: int) -> torch.Tensor:
    """Check what the kernel takes, launch it on the current stream, count the launch."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_self_attention: unsupported dtype {q.dtype}")
    if any(t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise TypeError("fused_self_attention: q, k and v must share a dtype and a device")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"fused_self_attention: q, k, v must be one [B, T, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, T, D = q.shape
    if num_heads <= 0 or D % num_heads:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    hd = D // num_heads
    if hd > _MAX_HEAD_DIM or hd % 8:
        raise NotImplementedError(
            f"the kernel takes head widths that are multiples of 8 up to {_MAX_HEAD_DIM}, not {hd}"
        )
    if B > _MAX_GRID_Z:
        raise NotImplementedError(f"B={B} exceeds the grid limit {_MAX_GRID_Z}")
    if not (q.stride() == k.stride() == v.stride() and q.stride(2) == 1):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    size = q.element_size()
    for t in (q, k, v):  # the kernel reads rows in 16-byte vectors
        if t.data_ptr() % 16 or (t.stride(0) * size) % 16 or (t.stride(1) * size) % 16:
            raise ValueError("fused_self_attention: q/k/v rows must be 16-byte aligned")
    out = torch.empty((B, T, D), device=q.device, dtype=q.dtype)

    from condmdi_tpu_torch.ops import _build

    lib = _build.load_attention()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.condmdi_attention_forward(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, T, num_heads, hd, ctypes.c_longlong(q.stride(0)), ctypes.c_longlong(q.stride(1)),
        _DTYPE_CODES[q.dtype], ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: {_build.error_string(lib, err)}")
    fused_self_attention.launches += 1
    return out
