"""How a reference rounds the operands of its products: exactly (float32), or
to a lower precision for a control (bf16, fp8 e4m3 with a per-tensor scale).

The products themselves accumulate in float32, as the tensor cores do for
these input types; TF32, the other control, is a backend switch
(`tf32_products`) rather than a rounding here.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


ROUNDINGS = {"f32": None, "tf32": None, "bf16": _bf16, "fp8": _fp8}


class Precision:
    """`op(x)`: x as a product's operand at this precision."""

    def __init__(self, name: str = "f32"):
        if name not in ROUNDINGS:
            raise ValueError(f"unknown precision {name!r}: one of {sorted(ROUNDINGS)}")
        self.name = name
        self._round = ROUNDINGS[name]

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._round is None else self._round(x)

    @contextlib.contextmanager
    def products(self):
        """float32 products with TF32 off, or on for the `tf32` control."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        tf32 = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
