"""Weights from the seed, made on the device in one draw, in the type they run in.

One normal draw covers every leaf of the reference's parameter list; each leaf is
then a scaled view of it: kernels N(0, 1/fan_in) (LeCun), the layers the card
initialises to zero included, so that samples are not identically 0; biases and
the norms' shifts N(0, 0.02²), the norms' scales 1 + N(0, 0.02²). The same seed
gives the same tensors, so the reference makes them again after the program is
gone.
"""

from __future__ import annotations

import math

import torch

from benchmark.core.seeds import derive

SMALL = 0.02


@torch.no_grad()
def make(specs, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _ in specs)
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, role in specs:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if role == "kernel":
            v.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif role == "norm_scale":
            v.mul_(SMALL).add_(1.0)
        else:
            v.mul_(SMALL)
        out[name] = v
    if dtype != torch.float32:
        cast = flat.to(dtype)
        del flat
        out, off = {}, 0
        for name, shape, _ in specs:
            n = math.prod(shape)
            out[name] = cast[off:off + n].view(shape)
            off += n
    return out
