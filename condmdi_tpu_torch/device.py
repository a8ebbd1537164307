"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for CPU.

    Raises when CUDA is asked for and absent: an entry point never carries
    on quietly on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "condmdi_tpu_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def float32_exact():
    """Float32 convolutions and matrix products in full float32 while open.

    PyTorch lets cuDNN's float32 convolutions run in TF32 by default
    (`torch.backends.cudnn.allow_tf32`), which rounds their inputs to 10
    mantissa bits. The sampling CLIs run under this (it also decorates a
    function), so a CLI computes in float32 as its checks on the card assume;
    the two flags are restored on exit. The flags forbid one TF32 product in
    place of a float32 one; MDM's float32 encoder projections still take the
    tf32x3 kernel under them (ops/dense.py `dense_route`), whose three TF32
    products carry each operand to ~2^-22 and whose error per call is float32's
    (held to cuBLAS's float32 product on the card).
    """
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
