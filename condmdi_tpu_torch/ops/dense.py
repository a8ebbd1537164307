"""Float32 dense layers on the tensor cores: the tf32x3 kernel and its plain version.

y = x · Wᵀ + b in float32, for MDM's encoder projections (models/mdm.py
`QDense`, precision "float"). The JAX package leaves them to XLA, and the port
gave them to `F.linear`, which cuBLAS runs on the CUDA cores when TF32 is off.
csrc/dense.cu runs them on the TF32 tensor cores with each operand split in two,
hi = rna_tf32(v) and lo = rna_tf32(v − hi) (round to nearest, ties away from
zero, at TF32's 10 mantissa bits), and three products,

    x·Wᵀ ≈ x_lo·W_hiᵀ + x_hi·W_loᵀ + x_hi·W_hiᵀ,

which carry each operand to about 2⁻²² of its size. The tensor cores' sums,
which truncate, span one 32-column stage at a time, and the stages are added in
float32 with rounding to nearest (csrc/dense.cu `consume`): float32's error,
which the card tests hold per call against cuBLAS's float32 product.

  * `dense_route(M, K, N, dtype, needs_grad)` says which of the two a call
    takes, from the shape, the type and whether a gradient is needed: "tf32x3"
    (the kernel) or "cublas" (`F.linear`). A pure function, asked where there
    is no card too.
  * `dense(x, planes, bias)` sends a CUDA tensor to the kernel, or raises; it
    never falls back. A CPU tensor takes `tf32x3_linear`, the plain version:
    the kernel's arithmetic in PyTorch.
  * `split_weight` is the weight's hi and lo planes as the kernel reads them,
    and `SplitDenseWeight` the module's copy of them, remade when the weight
    changes (ops/weight_cache.py).

`dense.launches` counts kernel launches, and nothing else; `dense.routes`
counts the routes QDense takes for float32 CUDA inputs (eager calls and the
calls a graph capture makes, not replays). The kernel has no backward: a call
that needs a gradient takes cuBLAS.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F

from condmdi_tpu_torch.ops import _build
from condmdi_tpu_torch.ops.weight_cache import DerivedWeight

ALIGN = 16  # K and N: multiples of this (TMA's 16-byte rows; pairs of columns in the store)
# The fewest rows from which the kernel beat cuBLAS's float32 GEMM at all four of MDM's
# projections in a sweep on an H100 (chip_smoke.py phase 41; PERF.md section 6): 4 x 197,
# edit's batch. Below it the kernel's few tiles take 15-29 us, where cuBLAS's CUDA-core
# kernels, which need no split, take 11-41 us.
MIN_ROWS = 788
TILE_M = 128  # rows of an output tile (csrc/dense.cu `kBM`)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away from
    zero, as `cvt.rna.tf32.f32` rounds: half of the last kept bit added to the
    magnitude, then the 13 low bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = rna_tf32(x), lo = rna_tf32(x − hi); hi + lo is x to ~2⁻²² of |x|."""
    x = x.float()
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def split_weight(w: torch.Tensor) -> torch.Tensor:
    """A [N, K] weight as the kernel reads it: its hi and lo planes [2, N, K], float32."""
    return torch.stack(split_tf32(w))


def tf32x3_linear(x: torch.Tensor, planes: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: x_lo·W_hiᵀ + x_hi·W_loᵀ + x_hi·W_hiᵀ (+ bias) in float32."""
    hi, lo = split_tf32(x)
    w_hi, w_lo = planes[0], planes[1]
    y = F.linear(lo, w_hi) + F.linear(hi, w_lo) + F.linear(hi, w_hi)
    return y if bias is None else y + bias.float()


def dense_route(M: int, K: int, N: int, dtype: torch.dtype, needs_grad: bool) -> str:
    """Which implementation a float32 CUDA call of QDense takes: "tf32x3" (the
    kernel) for float32 with no gradient needed, K and N multiples of 16 and at
    least `MIN_ROWS` rows; "cublas" (`F.linear`) otherwise."""
    if (dtype == torch.float32 and not needs_grad and K % ALIGN == 0 and N % ALIGN == 0
            and M >= MIN_ROWS):
        return "tf32x3"
    return "cublas"


def tile_n(M: int, N: int, sms: int) -> int:
    """The output tile's width: 128, or 64 where 128-wide tiles would leave SMs idle."""
    tiles = -(-M // TILE_M) * -(-N // 128)
    return 128 if tiles >= sms else 64


class SplitDenseWeight(DerivedWeight):
    """The split planes of one Dense weight (`split_weight`), remade when the
    weight changes (ops/weight_cache.py `DerivedWeight`)."""

    derive = staticmethod(split_weight)


def dense(x: torch.Tensor, planes: torch.Tensor, bias: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """x [..., K] · Wᵀ + bias → [..., N] in float32, from W's `planes` [2, N, K]."""
    if x.device.type == "cpu":
        return tf32x3_linear(x, planes, bias)
    if x.device.type != "cuda":
        raise ValueError(f"dense: unsupported device {x.device}")
    return _launch(x, planes, bias)


dense.launches = 0
dense.routes = {"tf32x3": 0, "cublas": 0}


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x, planes, bias):
    """Check what the kernel takes, launch it on the current stream, count the launch."""
    K = x.shape[-1]
    N = planes.shape[1]
    if x.dtype != torch.float32 or planes.dtype != torch.float32:
        raise TypeError(f"dense: float32 only, got x {x.dtype} and planes {planes.dtype}")
    if planes.shape != (2, N, K) or K % ALIGN or N % ALIGN:
        raise ValueError(f"dense: x [..., {K}] and planes {tuple(planes.shape)}: planes must be "
                         f"[2, N, K] with K and N multiples of {ALIGN}")
    index = x.get_device()
    if planes.get_device() != index or (bias is not None and bias.get_device() != index):
        raise ValueError("dense: x, planes and bias must share a device")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    out = torch.empty((M, N), device=x.device, dtype=torch.float32)
    if M == 0:
        return out.reshape(*lead, N)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = torch.empty_like(x2, memory_format=torch.contiguous_format).copy_(x2)
    planes = planes.contiguous()
    if bias is not None:
        if bias.shape != (N,):
            raise ValueError(f"dense: bias {tuple(bias.shape)} for N = {N}")
        bias = bias.float().contiguous()
    lib = _build.load_dense()
    err = lib.condmdi_dense_forward(
        x2.data_ptr(), planes.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), M, K, N, tile_n(M, N, _sm_count(index)),
        torch._C._cuda_getCurrentRawStream(index),
    )
    if err != 0:
        raise RuntimeError(f"dense kernel launch failed: {_build.error_string(lib, err)}")
    dense.launches += 1
    return out.reshape(*lead, N)
