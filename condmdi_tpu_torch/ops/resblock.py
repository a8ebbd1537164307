"""Fused conv1d → GroupNorm → (AdaGN) → Mish (→ +residual): one resblock half.

Counterpart of condmdi_tpu/ops/resblock.py. `fused_conv_gn_mish` is what
every Conv1dBlock / Conv1dAdaGNBlock of the UNet calls:

  * a CUDA tensor goes to the hand-written Hopper kernel
    (csrc/resblock.cu, built and bound by ops/_build.py), or the call
    raises; it never falls back to the plain version. Every half with Cout a
    multiple of n_groups and k = 5 is taken (`supports`), on one of two
    routes (`resblock_plan`): the cluster route, one kernel whose
    thread-block cluster holds a (batch item, group), for groups of up to 128
    channels and up to 8 tiles; the split route for every wider group or
    longer T, the same conv kernel without a cluster writing the pre-norm
    tile and its moments to a scratch, then a normalisation kernel;
  * a CPU tensor goes to `reference_conv_gn_mish`, the plain PyTorch version
    of the same function, in float32.

`fused_conv_gn_mish.launches` counts kernel launches, and nothing else, so a
run can show that its resblock halves went through the kernel;
`fused_conv_gn_mish.split_launches` counts those of them on the split route
(`resblock_plan`).

Under autograd (grad enabled and an input that requires grad, as
reconstruction guidance differentiates the UNet) the call goes through
`ConvGnMish`, whose forward is the same launch (or, on the CPU, the plain
version) and whose backward recomputes the half with the plain version. The
JAX package has no backward kernel either: it differentiates the unfused
layers (`_fusable` is false under training), which is what the recompute is.
Under `torch.no_grad()` the call launches directly, with no Function, since a
served step is bound by the host.

Layouts follow the JAX package: x [B, T, Cin], res and the output
[B, T, Cout]; the weight is in torch's Conv1d layout [Cout, Cin, k]. x may
carry up to 7 trailing alignment channels beyond the weight's Cin (the UNet
pads its 526-channel input to 528 so that rows are 16-byte aligned); they
are ignored.

The kernel reads the weight in a packed layout: `pack_conv_weight` in
bfloat16, and in float32 `split_conv_weight`, the weight's hi and lo bf16
parts packed the same way (the float32 kernel computes x·w as
x_hi·w_hi + x_hi·w_lo + x_lo·w_hi on the tensor cores). A module packs once
per parameter and hands the call a `PackedConvWeight`, which repacks when the
parameter changes; a call without one packs on the fly.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from condmdi_tpu_torch.ops.weight_cache import DerivedWeight

# dynamic shared memory a block may use on sm_90 (227 KB)
_MAX_SMEM = 232448
_MAX_GROUP = 128  # the cluster routes' widest group: one cluster holds one (item, group)
_TAPS = 5  # the conv width the kernel is built for (every resblock half)
_CHUNK = 32  # input channels per stage of the bf16 kernel = the packed weight's chunk
_F32_CHUNK = 16  # the same for the float32 kernel and its split weight
_MAX_CLUSTER = 8  # thread blocks of one cluster (the portable limit)
_NORM_COLS = 256  # channels of one group per CTA of the split route's normalisation
_NORM_ELEMS = 4096  # values per CTA of that normalisation, about
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pack_conv_weight(w: torch.Tensor, chunk: int = _CHUNK) -> torch.Tensor:
    """[Cout, Cin, k] → [Cin_pad/chunk, k, Cout_pad/8, chunk/8, 8, 8]: (chunk of
    input channels, tap, block of 8 output channels, block of 8 input channels,
    output channel, input channel), Cin zero-padded to a multiple of `chunk` (32
    for the bf16 kernel) and Cout to one of 8.

    The innermost 8 x 8 block (128 contiguous bytes in bf16) is one core matrix
    of the tensor cores' shared-memory operand, so the kernel copies a stage's
    weights in linear 16-byte pieces and the tile lands in the layout `wgmma`
    reads; the stage of one CTA is k contiguous runs.
    """
    cout, cin, k = w.shape
    cin_pad, cout_pad = -(-cin // chunk) * chunk, -(-cout // 8) * 8
    wp = F.pad(w, (0, 0, 0, cin_pad - cin, 0, cout_pad - cout))
    wp = wp.reshape(cout_pad // 8, 8, cin_pad // chunk, chunk // 8, 8, k)
    return wp.permute(2, 5, 0, 3, 1, 4).contiguous()


def unpack_conv_weight(wp: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """The inverse of `pack_conv_weight` (at either chunk): back to [cout, cin, k]."""
    chunks, k, blocks, blocks_in = wp.shape[:4]
    w = wp.permute(2, 4, 0, 3, 5, 1).reshape(blocks * 8, chunks * blocks_in * 8, k)
    return w[:cout, :cin].contiguous()


def split_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """A float32 [Cout, Cin, k] weight as the float32 kernel reads it: its hi and lo
    bf16 parts, hi = bf16(w) and lo = bf16(w - hi), each packed by
    `pack_conv_weight` in 16-channel chunks: [2, Cin_pad/16, k, Cout_pad/8, 2, 8, 8].
    hi + lo is w to within 2^-16 of |w| (each rounding keeps 8 significant bits)."""
    w = w.float()
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    return torch.stack([pack_conv_weight(hi, _F32_CHUNK), pack_conv_weight(lo, _F32_CHUNK)])


class PackedConvWeight(DerivedWeight):
    """The packed copy of one conv weight as the kernel reads it in the weight's
    dtype (`split_conv_weight` in float32, `pack_conv_weight` otherwise),
    remade when the weight changes (ops/weight_cache.py `DerivedWeight`)."""

    @staticmethod
    def derive(w: torch.Tensor) -> torch.Tensor:
        return packed_for_kernel(w)


def packed_for_kernel(w: torch.Tensor) -> torch.Tensor:
    """The weight as the kernel of its dtype reads it."""
    return split_conv_weight(w) if w.dtype == torch.float32 else pack_conv_weight(w)


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
    x_in = x[..., : w.shape[1]]  # alignment channels, if any, are not part of the conv
    y = F.conv1d(
        x_in.float().transpose(1, 2), w.float(), b.float(), padding=k // 2
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
    x: torch.Tensor,                       # [B, T, Cin (+ up to 7 alignment channels)]
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
    packed: Optional[PackedConvWeight] = None,  # the caller's cache of w's packed copy
) -> torch.Tensor:
    """One fused Conv1d(k, SAME) → GroupNorm → [AdaGN] → Mish [→ +res]."""
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_conv_gn_mish: unsupported device {x.device}")
    inputs = (x, w, b, gamma, beta, scale, shift, res)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return ConvGnMish.apply(*inputs, n_groups, eps, packed)
    return _forward(*inputs, n_groups, eps, packed)


fused_conv_gn_mish.launches = 0
fused_conv_gn_mish.split_launches = 0  # of those, the launches on the split route


def _forward(x, w, b, gamma, beta, scale, shift, res, n_groups, eps, packed):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return reference_conv_gn_mish(
            x, w, b, gamma, beta, scale, shift, res, n_groups=n_groups, eps=eps
        )
    return _launch(x, w, b, gamma, beta, scale, shift, res, n_groups, eps, packed)


def recompute_grads(plain, inputs, needs, grad_out):
    """The gradients of `plain(*inputs)` wrt the inputs in `needs` (None for the
    others): the inputs detached, the plain version run again under autograd,
    and `grad_out` taken back through it. An input that reaches the output by
    no differentiable path (x through the int8 codes) gets zeros."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_(need) if t is not None else None
                for t, need in zip(inputs, needs)]
        wanted = [t for t, need in zip(live, needs) if need]
        y = plain(*live)
        grads = iter(torch.autograd.grad(y, wanted, grad_out, allow_unused=True)
                     if y.requires_grad else [None] * len(wanted))
    result = []
    for t, need in zip(live, needs):
        g = next(grads) if need else None
        result.append(torch.zeros_like(t) if need and g is None else g)
    return result


class ConvGnMish(torch.autograd.Function):
    """One resblock half under autograd: `_forward` (the kernel on the card),
    and a backward that recomputes the half with `reference_conv_gn_mish`
    and returns the gradients of x, w, b, gamma, beta, scale, shift and res.

    Call as `ConvGnMish.apply(x, w, b, gamma, beta, scale, shift, res,
    n_groups, eps, packed)`; `fused_conv_gn_mish` does so only under autograd.
    """

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, scale, shift, res, n_groups, eps, packed):
        ctx.save_for_backward(x, w, b, gamma, beta, scale, shift, res)
        ctx.n_groups, ctx.eps = n_groups, eps
        return _forward(x, w, b, gamma, beta, scale, shift, res, n_groups, eps, packed)

    @staticmethod
    def backward(ctx, grad_out):
        def plain(*inputs):
            return reference_conv_gn_mish(*inputs, n_groups=ctx.n_groups, eps=ctx.eps)

        grads = recompute_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[:8], grad_out)
        return (*grads, None, None, None)


def bf16_tiles(T: int) -> tuple[int, int, int]:
    """(rows, channels, ring stages) of one CTA of the bf16 kernel at length T
    (mirrors the dispatch in csrc/resblock.cu `condmdi_resblock_forward`)."""
    if T <= 64:
        return 64, 64, 6
    return 128, 128, 4


def f32_tiles(T: int) -> tuple[int, int, int]:
    """(rows, channels, ring stages) of one CTA of the float32 kernel at length T
    (csrc/resblock.cu `f32::tile_rows` and the dispatch beside it)."""
    if T <= 256:
        return 64, 64, 3
    return 128, 128, 3


def cluster_size(T: int, group: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Thread blocks that share one (batch item, group): the row tiles along T
    times the channel tiles of a group wider than the tile (a narrower group
    shares its CTA with its neighbours). One cluster on the cluster route, where
    it is at most 8; as many tiles, with no cluster, on the split route."""
    bm, bn, _ = f32_tiles(T) if dtype == torch.float32 else bf16_tiles(T)
    return -(-T // bm) * -(-group // bn)


def smem_bytes(T: int, k: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA (mirrors csrc/resblock.cu `Cfg::kSmem` for
    bfloat16, `f32::Cfg::kSmem` for float32): the ring's stages, each the x tile
    and the weights of k taps (in float32 also the rows as copied, and hi and lo
    planes of both)."""
    if dtype == torch.float32:
        bm, bn, stages = f32_tiles(T)
        x_rows = bm + k - 1
        x_plane_rows = (x_rows + 5) // 8 * 8 + 2
        x_bytes = (_F32_CHUNK // 8) * x_plane_rows * 16
        stage = 2 * x_bytes + x_rows * _F32_CHUNK * 4 + 2 * k * bn * _F32_CHUNK * 2
        return stages * stage
    bm, bn, stages = bf16_tiles(T)
    x_plane_rows = (bm + k - 1 + 5) // 8 * 8 + 2  # Cfg::kXPlaneRows
    return stages * ((_CHUNK // 8) * x_plane_rows * 16 + k * bn * _CHUNK * 2)


class ResblockPlan(NamedTuple):
    """How the card computes one half (`resblock_plan`)."""

    route: str                       # "cluster" or "split"
    tiles: tuple[int, int, int]      # (rows, channels, ring stages) of one conv CTA
    chunks: int                      # ring stages one conv CTA runs: Cin over the chunk
    grid: tuple[int, int, int]       # the conv kernel's grid: (tiles, group slots, B)
    groups_per_cta: int              # whole groups one conv CTA holds (float32 narrow groups)
    cluster: int                     # CTAs of one cluster; 1 on the split route
    norm_rows: int                   # split route: rows of one normalisation CTA (else 0)
    norm_grid: tuple[int, int, int]  # split route: the normalisation's grid (else zeros)
    scratch: int                     # split route: float32 scratch elements (else 0)


@lru_cache(maxsize=1024)
def resblock_plan(B: int, T: int, cin: int, cout: int, dtype: torch.dtype,
                  n_groups: int = 8) -> ResblockPlan:
    """The route, tiles, grid and cluster of one half (mirrors csrc/resblock.cu
    `make_plan`, which `condmdi_resblock_plan` returns on the card).

    The cluster route, one kernel: a thread-block cluster holds one (batch item,
    group) and exchanges GroupNorm's sums through distributed shared memory; it
    takes groups of up to 128 channels whose tiles fit a portable cluster of 8.
    The split route takes every other shape: the same conv kernel with no
    cluster writes its pre-norm tile (float32) and each tile's count, mean and
    centred sum of squares into a scratch, and a second kernel, its
    programmatic dependent, merges each group's moments with Chan's formula in
    a fixed order and normalises, one CTA a (row block, 256-channel chunk of a
    group, batch item). Both are deterministic.
    """
    group = cout // n_groups
    f32 = dtype == torch.float32
    bm, bn, stages = f32_tiles(T) if f32 else bf16_tiles(T)
    gpc = (1 if group >= bn else bn // group) if f32 else 1
    tiles = cluster_size(T, group, dtype)
    chunks = -(-cin // (_F32_CHUNK if f32 else _CHUNK))
    grid = (tiles, -(-n_groups // gpc), B)
    if group <= _MAX_GROUP and tiles <= _MAX_CLUSTER:
        return ResblockPlan("cluster", (bm, bn, stages), chunks, grid, gpc, tiles, 0, (0, 0, 0), 0)
    norm_rows = _NORM_ELEMS // min(group, _NORM_COLS)
    norm_grid = (-(-T // norm_rows), n_groups * -(-group // _NORM_COLS), B)
    scratch = B * T * cout + 3 * B * n_groups * tiles
    return ResblockPlan("split", (bm, bn, stages), chunks, grid, gpc, 1, norm_rows, norm_grid,
                        scratch)


def supports(B: int, T: int, cin: int, cout: int, k: int, n_groups: int) -> bool:
    """Whether the card kernel computes this half: every half with Cout a multiple
    of n_groups and k = 5 taps, at any B, T, Cin and group width (the cluster
    route or the split route, `resblock_plan`); `_launch` raises for every other
    half, by the same two checks. Nothing calls this to choose a path: a CUDA tensor always takes the
    kernel. (JAX's `supports` also takes `interpret`, which names Pallas's
    interpret mode; the port has no such mode, so the argument is gone.)"""
    del B, T, cin  # every batch, length and input width is taken
    return k == _TAPS and n_groups > 0 and cout % n_groups == 0


def _launch(x, w, b, gamma, beta, scale, shift, res, n_groups, eps, packed=None):
    """Check what the kernel takes, launch it on the current stream, count the launch.

    Runs 33 times per UNet forward, so the checks are written to cost the
    host little: no device access, no copies of tensors already contiguous.
    """
    dtype, device = x.dtype, x.device
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"fused_conv_gn_mish: unsupported dtype {dtype}")
    for t in (x, w, b, gamma, beta, scale, shift, res):
        if t is not None and (t.dtype != dtype or t.device != device):
            raise TypeError("fused_conv_gn_mish: all inputs must share x's dtype and device")
    B, T, xc = x.shape
    cout, cin, k = w.shape
    if not cin <= xc <= -(-cin // 8) * 8:
        raise ValueError(f"fused_conv_gn_mish: weight {tuple(w.shape)} does not take Cin={xc}")
    if k != _TAPS:  # with the next check, `supports`
        raise NotImplementedError(f"the kernel is built for k={_TAPS} taps, not {k}")
    if cout % n_groups:
        raise ValueError(f"Cout={cout} is not a multiple of n_groups={n_groups}")
    bf16 = dtype == torch.bfloat16
    if not (b.shape == gamma.shape == beta.shape == (cout,)):
        raise ValueError(f"b, gamma and beta must have shape ({cout},)")
    if res is not None and res.shape != (B, T, cout):
        raise ValueError(f"res has shape {tuple(res.shape)}, expected {(B, T, cout)}")
    ss_stride = 0
    if scale is not None:
        if not (scale.shape == shift.shape == (B, cout)) or scale.stride(1) != 1 \
                or shift.stride(1) != 1:
            raise ValueError("scale/shift must be [B, Cout] with unit column stride")
        ss_stride = scale.stride(0)
        if shift.stride(0) != ss_stride:
            raise ValueError("scale and shift must share a row stride")

    x, b, gamma, beta, res = (
        t if t is None or t.is_contiguous() else t.contiguous() for t in (x, b, gamma, beta, res)
    )
    align = 8 if bf16 else 4  # x rows are copied 16 bytes at a time
    if xc % align:  # a one-off call with unaligned rows; the UNet pads once, at its input
        x = F.pad(x, (0, -xc % align))
    w = packed.get(w) if packed is not None else packed_for_kernel(w)
    w_cin = w.shape[0] * _CHUNK if bf16 else w.shape[1] * _F32_CHUNK
    out = torch.empty((B, T, cout), device=device, dtype=dtype)
    plan = resblock_plan(B, T, cin, cout, dtype, n_groups)
    scratch = (torch.empty(plan.scratch, device=device, dtype=torch.float32)
               if plan.scratch else None)

    from condmdi_tpu_torch.ops import _build

    lib = _build.load_resblock()
    # plain ints and None: the bound argtypes convert them (None is a null pointer)
    err = lib.condmdi_resblock_forward(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), ss_stride,
        None if res is None else res.data_ptr(), out.data_ptr(),
        B, T, x.shape[2], w_cin, cout, k, n_groups, eps, code,
        torch.cuda.current_stream(device).cuda_stream,
        None if scratch is None else scratch.data_ptr(),
    )
    if err != 0:
        raise RuntimeError(f"resblock kernel launch failed: {_build.error_string(lib, err)}")
    fused_conv_gn_mish.launches += 1
    if scratch is not None:
        fused_conv_gn_mish.split_launches += 1
    return out
