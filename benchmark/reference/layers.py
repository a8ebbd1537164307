"""Plain layers shared by the references: channels-last [B, T, C] tensors,
weights in torch's layouts ([out, in] for Dense, [out, in, k] for a conv,
[in, out, k] for a transposed conv)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

EXACT = Precision("f32")


def dense(x, w, b, prec: Precision = EXACT):
    return F.linear(prec.op(x), prec.op(w), b)


def conv1d(x, w, b, stride=1, padding=0, prec: Precision = EXACT):
    """x [B, T, Cin] (channels past the weight's Cin are not read) → [B, T', Cout]."""
    x = x[..., : w.shape[1]]
    y = F.conv1d(prec.op(x).transpose(1, 2), prec.op(w), b, stride=stride, padding=padding)
    return y.transpose(1, 2)


def conv_transpose1d(x, w, b, stride=2, padding=1, prec: Precision = EXACT):
    y = F.conv_transpose1d(prec.op(x).transpose(1, 2), prec.op(w), b, stride=stride,
                           padding=padding)
    return y.transpose(1, 2)


def group_norm(y, gamma, beta, groups: int, eps: float = 1e-5):
    """GroupNorm over (T, the group's channels) per item, biased variance."""
    B, T, C = y.shape
    g = y.reshape(B, T, groups, C // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    return ((g - mean) / torch.sqrt(var + eps)).reshape(B, T, C) * gamma + beta


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


def mish(x):
    return x * torch.tanh(F.softplus(x, threshold=30.0))


def gelu(x):
    """The exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def sinusoid_table(n: int, d: int, device) -> torch.Tensor:
    """The transformer table: sin on even columns, cos on odd, [n, d] float32."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-math.log(10000.0) / d))
    pe = np.zeros((n, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.as_tensor(pe, dtype=torch.float32, device=device)


def timestep_embedding(P, t, table, prec: Precision = EXACT, prefix="embed_timestep"):
    """MDM's timestep MLP: Dense → SiLU → Dense over the table's row t."""
    h = dense(table[t], P[f"{prefix}.fc1.weight"], P[f"{prefix}.fc1.bias"], prec)
    return dense(F.silu(h), P[f"{prefix}.fc2.weight"], P[f"{prefix}.fc2.bias"], prec)


def text_embedding(P, text, uncond, prec: Precision = EXACT):
    """The text Dense over the CLIP embedding, zero rows where `uncond`."""
    text = torch.where(uncond[:, None], torch.zeros_like(text), text)
    return dense(text, P["embed_text.weight"], P["embed_text.bias"], prec)
