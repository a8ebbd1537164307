"""Device selection for the port's entry points."""

from __future__ import annotations

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
