"""Parameter-holding layers with the JAX package's initialisers.

Parameters are allocated empty and filled by `init_params(model, seed)` from
one explicit CPU `torch.Generator`, so construction never reads the global
RNG and a seed gives the same weights on every device. Kernels use Flax's
lecun-normal scale (std = 1/sqrt(fan_in)) or zeros; biases are zero; norm
scales are one. Every module that holds parameters is a `ParamModule`.

`TrainDraws` and `dropout` are the random parts of a training forward:
Flax's `cond_mask` and `dropout` rng streams become one explicit
`torch.Generator` (or anything with the same `keep` method, as a test that
replays another framework's draws).
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
    """y = x @ weight.T + bias; weight [out, in] (Flax Dense kernel is [in, out]).

    `use_bias=False` holds no bias (Flax's `use_bias=False`); `orthogonal`
    marks a kernel that Flax initialises orthogonally (the GRU cell's
    recurrent kernels) instead of lecun-normal."""

    def __init__(self, in_features, out_features, *, zero_init=False, use_bias=True,
                 orthogonal=False, device=None, dtype=None):
        super().__init__()
        self.weight = _empty((out_features, in_features), device, dtype)
        self.bias = _empty((out_features,), device, dtype) if use_bias else None
        self.zero_init = zero_init
        self.orthogonal = orthogonal

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.orthogonal:
            _orthogonal_(self.weight, generator)
        else:
            _lecun_(self.weight, self.weight.shape[1], self.zero_init, generator)
        if self.bias is not None:
            _const_(self.bias, 0.0)

    def forward(self, x):
        w, b = self.weight, self.bias
        if x.dtype != w.dtype:  # Flax's promotion: bf16 input, f32 params -> f32
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w, b = x.to(dt), w.to(dt), None if b is None else b.to(dt)
        return F.linear(x, w, b)


class Conv1d(ParamModule):
    """A plain SAME convolution on [B, T, C]: weight [Cout, Cin/groups, k] (Flax's
    kernel [k, Cin/groups, Cout], `feature_group_count=groups`), bias [Cout]."""

    def __init__(self, in_channels, out_channels, kernel_size, groups=1, *, device=None,
                 dtype=None):
        super().__init__()
        self.weight = _empty((out_channels, in_channels // groups, kernel_size), device, dtype)
        self.bias = _empty((out_channels,), device, dtype)
        self.groups = groups

    def reset_parameters(self, generator: torch.Generator) -> None:
        _, cin, k = self.weight.shape
        _lecun_(self.weight, cin * k, False, generator)
        _const_(self.bias, 0.0)

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias, padding=self.weight.shape[-1] // 2,
                     groups=self.groups)
        return y.transpose(1, 2)


class TrainDraws:
    """The random draws of a training forward, from one generator on the
    model's device: condition dropout and every dropout mask."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def keep(self, shape, keep_prob: float, device) -> torch.Tensor:
        """A bool mask of `shape`, each entry True with probability `keep_prob`."""
        return torch.rand(shape, generator=self.generator, device=device) < keep_prob


def dropout(x: torch.Tensor, rate: float, draws) -> torch.Tensor:
    """Flax's Dropout: kept entries scaled by 1/(1-rate), the rest zero; the
    identity outside training (`draws` None) or at rate 0."""
    if draws is None or rate == 0.0:
        return x
    keep = draws.keep(x.shape, 1.0 - rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class ConvTransposeParams(ParamModule):
    """ConvTranspose1d weight [Cin, Cout, k] and bias [Cout], torch layout, applied
    channels-last: [B, T, Cin] → [B, T', Cout]."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, *,
                 device=None, dtype=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = _empty((in_channels, out_channels, kernel_size), device, dtype)
        self.bias = _empty((out_channels,), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias, stride=self.stride,
                               padding=self.padding)
        return y.transpose(1, 2).contiguous()

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
def _orthogonal_(p: torch.Tensor, generator: torch.Generator) -> None:
    """An orthogonal [out, in] kernel: Q of a normal draw's QR, columns signed by R's diagonal."""
    q, r = torch.linalg.qr(torch.randn(p.shape, generator=generator, dtype=torch.float32))
    p.copy_(q * torch.sign(torch.diagonal(r))[None, :])


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
