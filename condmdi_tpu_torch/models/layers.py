"""Parameter-holding layers with the JAX package's initialisers.

Parameters are allocated empty and filled by `init_params(model, seed)` from
one explicit CPU `torch.Generator`, so construction never reads the global
RNG and a seed gives the same weights on every device. Kernels use Flax's
lecun-normal scale (std = 1/sqrt(fan_in)) or zeros; biases are zero; norm
scales are one. Every module that holds parameters is a `ParamModule`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _empty(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class ParamModule(nn.Module):
    """A module whose parameters `init_params` fills from its generator."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError


class Dense(ParamModule):
    """y = x @ weight.T + bias; weight [out, in] (Flax Dense kernel is [in, out])."""

    def __init__(self, in_features, out_features, *, zero_init=False, device=None, dtype=None):
        super().__init__()
        self.weight = _empty((out_features, in_features), device, dtype)
        self.bias = _empty((out_features,), device, dtype)
        self.zero_init = zero_init

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_(self.weight, self.weight.shape[1], self.zero_init, generator)
        _const_(self.bias, 0.0)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class ConvTransposeParams(ParamModule):
    """ConvTranspose1d weight [Cin, Cout, k] and bias [Cout], torch layout."""

    def __init__(self, in_channels, out_channels, kernel_size, *, device=None, dtype=None):
        super().__init__()
        self.weight = _empty((in_channels, out_channels, kernel_size), device, dtype)
        self.bias = _empty((out_channels,), device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        cin, _, k = self.weight.shape
        _lecun_(self.weight, cin * k, False, generator)
        _const_(self.bias, 0.0)


class GroupNormParams(ParamModule):
    """Norm affine weight/bias (Flax names them scale/bias)."""

    def __init__(self, channels, *, device=None, dtype=None):
        super().__init__()
        self.weight = _empty((channels,), device, dtype)
        self.bias = _empty((channels,), device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _const_(self.weight, 1.0)
        _const_(self.bias, 0.0)


class LayerNorm(GroupNormParams):
    """LayerNorm over the last axis with the affine weight/bias."""

    def __init__(self, features, eps=1e-5, *, device=None, dtype=None):
        super().__init__(features, device=device, dtype=dtype)
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)


@torch.no_grad()
def _lecun_(p: torch.Tensor, fan_in: int, zero: bool, generator: torch.Generator) -> None:
    if zero:
        p.zero_()
        return
    v = torch.randn(p.shape, generator=generator, dtype=torch.float32) / math.sqrt(fan_in)
    p.copy_(v)


@torch.no_grad()
def _const_(p: torch.Tensor, value: float) -> None:
    p.fill_(value)


def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter of `model` from one CPU generator seeded with `seed`."""
    generator = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, ParamModule):
            module.reset_parameters(generator)
    return model
