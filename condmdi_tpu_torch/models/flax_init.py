"""Flax's parameter initialisation replayed in torch.

`flax_params(model, seed)` gives the parameters that `flax_module.init(
jax.random.key(seed), …)` gives the Flax counterpart of one of the port's
models (MDM_UNET in every precision mode, MDM), so a run with no checkpoint
draws the same weights as the JAX package: the threefry-2x32 generator with
JAX's partitionable bit layout, each parameter's key folded from Flax's
module path and per-module counter (sha1 of the path, as flax.core.scope
`_fold_in_static`), lecun-normal as `jax.random.truncated_normal` draws
it, EmbedAction's table as `jax.random.normal` draws it, and the GRU cells'
recurrent kernels orthogonal as `jax.random.orthogonal` makes them (a normal
draw, its QR, Q's columns signed by R's diagonal). The threefry bits are
exact; the float steps (erf, erfinv, QR) may differ from XLA's in the last
bits.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from condmdi_tpu_torch.models.embeddings import EmbedAction
from condmdi_tpu_torch.models.layers import Conv1d, ConvTransposeParams, Dense, GroupNormParams
from condmdi_tpu_torch.models.unet import ChannelLayerNorm, QConv
from condmdi_tpu_torch.weights import load_flax_params

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: tuple[int, int], x0, x1):
    """Threefry-2x32 (20 rounds) of counters x0, x1: Python ints or int64
    tensors holding uint32 values."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """jax.random.fold_in for the threefry implementation."""
    return _threefry2x32(key, 0, data & _M32)


def _param_key(root: tuple[int, int], path: tuple[str, ...], counter: int) -> tuple[int, int]:
    """The key Flax's scope hands the `counter`-th parameter of the module at
    `path`: one fold_in of the first 4 bytes of sha1(path + counter)."""
    m = hashlib.sha1()
    for part in path:
        m.update(part.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, byteorder="big"))
    return _fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


def _random_bits(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """32 random bits per element, JAX's partitionable layout: threefry of the
    element's 64-bit index split in (hi, lo), the two words xor-ed."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32(key, idx >> 32, idx & _M32)
    return b0 ^ b1


def _uniform(key, shape, lo, hi, device) -> torch.Tensor:
    """jax.random.uniform in float32 on [lo, hi): 23 random mantissa bits."""
    bits = _random_bits(key, math.prod(shape), device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo).reshape(shape)


def _normal(key, shape, device) -> torch.Tensor:
    """jax.random.normal in float32: √2·erfinv of a uniform draw on (nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = _uniform(key, shape, lo, np.float32(1.0), device)
    return float(np.float32(np.sqrt(2))) * torch.special.erfinv(u)


def _orthogonal(key, shape, device) -> torch.Tensor:
    """jax.nn.initializers.orthogonal() of a square [n, n] kernel."""
    q, r = torch.linalg.qr(_normal(key, shape, device))
    return q * torch.sign(torch.diagonal(r))[None, :]


def _lecun_normal(key, shape, device) -> torch.Tensor:
    """jax.nn.initializers.lecun_normal: truncated_normal(-2, 2) * sqrt(1/fan_in) / 0.8796…,
    fan_in = the product of all but the last axis."""
    bits = _random_bits(key, math.prod(shape), device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    sqrt2 = torch.tensor(np.sqrt(2), dtype=torch.float32, device=device)
    lo, hi = torch.erf(-2.0 / sqrt2), torch.erf(2.0 / sqrt2)
    u = torch.maximum(lo, floats * (hi - lo) + lo)
    out = sqrt2 * torch.special.erfinv(u)
    bound = torch.tensor(2.0, dtype=torch.float32)
    out = out.clamp(torch.nextafter(-bound, bound).item(), torch.nextafter(bound, -bound).item())
    fan_in = math.prod(shape[:-1])
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
    return (out * float(stddev)).reshape(shape)


def flax_params(model: torch.nn.Module, seed: int = 0, device=None) -> dict[tuple, torch.Tensor]:
    """The parameters `flax_module.init(jax.random.key(seed), …)` gives the
    Flax counterpart of `model`, as {Flax path: tensor in Flax's layout}, made
    on `device` (the model's by default)."""
    if device is None:
        device = next(model.parameters()).device
    root = (seed >> 32 & _M32, seed & _M32)
    tree = {}

    def lecun(path, counter, shape, zero=False):
        if zero:
            return torch.zeros(shape, device=device)
        return _lecun_normal(_param_key(root, path, counter), shape, device)

    def key(path, counter=1):
        return _param_key(root, path, counter)

    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, QConv) and mod.precision_mode == "int8_prequant":
            cout, cin, k = mod.weight_q.shape
            tree[path + ("kernel_q",)] = torch.zeros((k, cin, cout), dtype=torch.int8,
                                                     device=device)
            tree[path + ("scale",)] = torch.ones(cout, device=device)
        elif isinstance(mod, QConv):
            cout, cin, k = mod.weight.shape
            tree[path + ("kernel",)] = lecun(path, 1, (k, cin, cout), mod.zero_init)
        elif isinstance(mod, (ConvTransposeParams, Conv1d)):  # Conv1d: k, Cin/groups, Cout
            a, b, k = mod.weight.shape
            cin, cout = (a, b) if isinstance(mod, ConvTransposeParams) else (b, a)
            tree[path + ("kernel",)] = lecun(path, 1, (k, cin, cout))
        elif isinstance(mod, Dense):
            dout, din = mod.weight.shape
            if mod.orthogonal:  # [din, din]: its transpose is the port's weight
                tree[path + ("kernel",)] = _orthogonal(key(path), (din, dout), device)
            else:
                tree[path + ("kernel",)] = lecun(path, 1, (din, dout), mod.zero_init)
            if mod.bias is None:
                continue
        elif isinstance(mod, GroupNormParams):  # GroupNorm and LayerNorm
            tree[path + ("scale",)] = torch.ones(mod.weight.shape, device=device)
        elif isinstance(mod, ChannelLayerNorm):
            tree[path + ("g",)] = torch.ones(mod.g.shape, device=device)
            tree[path + ("b",)] = torch.zeros(mod.b.shape, device=device)
            continue
        elif isinstance(mod, EmbedAction):
            shape = tuple(mod.action_embedding.shape)
            tree[path + ("action_embedding",)] = _normal(key(path), shape, device)
            continue
        else:
            continue
        tree[path + ("bias",)] = torch.zeros(mod.bias.shape, device=device)
    return tree


def load_params(model: torch.nn.Module, state_dict: dict[str, torch.Tensor]) -> torch.nn.Module:
    """Load a state_dict converted from a params tree: every parameter must be
    there; the QConvs' calibrated amax buffers, which a params tree does not
    hold, may be missing and keep their values."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith(".amax")]
    if missing or unexpected:
        raise KeyError(f"the parameters do not match the model: missing {missing[:3]}, "
                       f"unexpected {unexpected[:3]}")
    return model


def load_tree(model: torch.nn.Module, tree: dict[tuple, torch.Tensor]) -> torch.nn.Module:
    """Load a {Flax path: tensor} tree through weights.load_flax_params."""
    nested: dict = {}
    for path, value in tree.items():
        node = nested
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value.cpu().numpy()
    return load_params(model, load_flax_params({"params": nested}))


def load_flax_init(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill `model`'s parameters as `flax_module.init(jax.random.key(seed), …)`
    fills its Flax counterpart's."""
    return load_tree(model, flax_params(model, seed))
