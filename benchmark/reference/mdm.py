"""MDM's transformer-encoder denoiser (arXiv 2209.14916, `trans_enc`), plain float32.

The conditioning vector (timestep MLP plus the text Dense over the CLIP
embedding, zero for the unconditioned half of CFG) is prepended as a token to
the motion's frames projected to the latent width; the sinusoidal table is
added over [token, frames]; `layers` post-LN encoder layers (self-attention
over `heads` contiguous head blocks, exact-erf GELU feed-forward, LayerNorm
eps 1e-5); the frames' outputs projected back to F features. Sampling runs
with dropout off.
"""

from __future__ import annotations

import math

import torch

from benchmark.counts import attention as attention_counts
from benchmark.counts.models import dense as dense_flops
from benchmark.reference.layers import (
    EXACT,
    dense,
    gelu,
    layer_norm,
    sinusoid_table,
    text_embedding,
    timestep_embedding,
)
from benchmark.reference.precision import Precision


def param_specs(cfg) -> list[tuple[str, tuple[int, ...], str]]:
    F, D, FF = cfg["njoints"], cfg["latent_dim"], cfg["ff_size"]
    specs = []

    def lin(name, cin, cout):
        specs.extend([(f"{name}.weight", (cout, cin), "kernel"), (f"{name}.bias", (cout,), "bias")])

    def norm(name, d):
        specs.extend([(f"{name}.weight", (d,), "norm_scale"), (f"{name}.bias", (d,), "norm_bias")])

    lin("embed_timestep.fc1", D, D)
    lin("embed_timestep.fc2", D, D)
    lin("embed_text", cfg["clip_dim"], D)
    lin("input_process", F, D)
    for i in range(cfg["layers"]):
        lin(f"layer{i}.qkv", D, 3 * D)
        lin(f"layer{i}.attn_out", D, D)
        norm(f"layer{i}.norm1", D)
        lin(f"layer{i}.ff1", D, FF)
        lin(f"layer{i}.ff2", FF, D)
        norm(f"layer{i}.norm2", D)
    lin("output_process", D, F)
    return specs


def attention(qkv, heads: int, prec: Precision = EXACT):
    """softmax(q kᵀ / √hd) v per head of a fused [B, T, 3D] projection."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads
    q, k, v = (u.reshape(B, T, heads, hd).transpose(1, 2) for u in qkv.chunk(3, dim=-1))
    scores = torch.matmul(prec.op(q), prec.op(k).transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(prec.op(probs), prec.op(v))
    return out.transpose(1, 2).reshape(B, T, D)


class MDM:
    """denoise(x, t, text, uncond) → the x0 prediction [B, T, F]."""

    def __init__(self, P: dict, cfg: dict, prec: Precision = EXACT, bf16_input: bool = False):
        if bf16_input:
            raise NotImplementedError("MDM's reference models no bfloat16 input (use_fp16)")
        self.P = {k: v.float() for k, v in P.items()}
        self.cfg, self.prec = cfg, prec
        self.table = sinusoid_table(5000, cfg["latent_dim"], next(iter(P.values())).device)

    def __call__(self, x, t, text, uncond, obs_x0=None, obs_mask=None):
        P, prec, cfg = self.P, self.prec, self.cfg
        emb = timestep_embedding(P, t, self.table, prec) + text_embedding(P, text, uncond, prec)
        h = dense(x, P["input_process.weight"], P["input_process.bias"], prec)
        h = torch.cat([emb[:, None, :], h], dim=1)
        h = h + self.table[: h.shape[1]]
        for i in range(cfg["layers"]):
            n = f"layer{i}"
            qkv = dense(h, P[f"{n}.qkv.weight"], P[f"{n}.qkv.bias"], prec)
            a = dense(attention(qkv, cfg["heads"], prec), P[f"{n}.attn_out.weight"],
                      P[f"{n}.attn_out.bias"], prec)
            h = layer_norm(h + a, P[f"{n}.norm1.weight"], P[f"{n}.norm1.bias"])
            f = dense(gelu(dense(h, P[f"{n}.ff1.weight"], P[f"{n}.ff1.bias"], prec)),
                      P[f"{n}.ff2.weight"], P[f"{n}.ff2.bias"], prec)
            h = layer_norm(h + f, P[f"{n}.norm2.weight"], P[f"{n}.norm2.bias"])
        return dense(h[:, 1:], P["output_process.weight"], P["output_process.bias"], prec)


Model = MDM


def forward_flops(cfg, B, frames) -> float:
    """Model FLOPs of a forward at batch B over `frames` frames and the
    conditioning token: every Dense layer and attention's two products."""
    F, D, FF = cfg["njoints"], cfg["latent_dim"], cfg["ff_size"]
    S = frames + 1
    total = dense_flops(B, D, D) * 2 + dense_flops(B, cfg["clip_dim"], D)
    total += dense_flops(B, F, D, frames) + dense_flops(B, D, F, frames)
    per_layer = (dense_flops(B, D, 3 * D, S) + attention_counts.flops(B, S, D, cfg["heads"])
                 + dense_flops(B, D, D, S) + dense_flops(B, D, FF, S) + dense_flops(B, FF, D, S))
    return total + cfg["layers"] * per_layer
