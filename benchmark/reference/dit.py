"""DiT's adaLN-Zero transformer (arXiv 2212.09748) as CondMDI's pre-norm DiT
denoiser (`dit_prenorm`, arXiv 2405.11126), plain float32.

The conditioning vector c is MDM's timestep MLP plus the text Dense over the
CLIP embedding (zero for the unconditioned half of CFG). The motion's frames,
projected to the latent width, get the sinusoidal table added and pass through
`layers` adaLN-Zero blocks: a Dense over SiLU(c) gives six modulation vectors
in DiT's order (shift, scale and gate for attention, then for the MLP); each
sublayer enters the residual as x + gate · f(LN(x) · (1 + scale) + shift), with
a LayerNorm that has no parameters; attention is self-attention over `heads`
contiguous head blocks, the MLP is Dense → GELU → Dense. The final layer is
DiT's: an adaLN shift and scale over a parameter-free LayerNorm, then a Dense
back to F features. Sampling runs with dropout off.

Departures from DiT-XL/2, all of them CondMDI's wiring (the port's and the
JAX package's):
  * a motion frame is a token: no patchify, and a 1-D sinusoid table added to
    the tokens in place of DiT's fixed 2-D one;
  * a CLIP-width text embedding through a Dense in place of the class
    embedding, with CFG's unconditioned rows made by zeroing the text;
  * MDM's timestep embedder (the sinusoid table's row t → Dense → SiLU → Dense)
    in place of DiT's frequency embedding → MLP;
  * the exact (erf) GELU, where DiT uses the tanh approximation;
  * LayerNorm eps 1e-5, where DiT uses 1e-6;
  * the model predicts x0 and has no learned-variance channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.counts import attention as attention_counts
from benchmark.counts.models import dense as dense_flops
from benchmark.reference.layers import (
    EXACT,
    dense,
    gelu,
    sinusoid_table,
    text_embedding,
    timestep_embedding,
)
from benchmark.reference.mdm import attention
from benchmark.reference.precision import Precision

EPS = 1e-5


def param_specs(cfg) -> list[tuple[str, tuple[int, ...], str]]:
    F_, D, FF = cfg["njoints"], cfg["latent_dim"], cfg["ff_size"]
    specs = []

    def lin(name, cin, cout):
        specs.extend([(f"{name}.weight", (cout, cin), "kernel"), (f"{name}.bias", (cout,), "bias")])

    lin("embed_timestep.fc1", D, D)
    lin("embed_timestep.fc2", D, D)
    lin("embed_text", cfg["clip_dim"], D)
    lin("input_process", F_, D)
    for i in range(cfg["layers"]):
        lin(f"block{i}.adaln.mod", D, 6 * D)
        lin(f"block{i}.attn.qkv", D, 3 * D)
        lin(f"block{i}.attn.out", D, D)
        lin(f"block{i}.mlp.fc1", D, FF)
        lin(f"block{i}.mlp.fc2", FF, D)
    lin("output_process.adaln.mod", D, 2 * D)
    lin("output_process.proj", D, F_)
    return specs


def _norm(x):
    """LayerNorm over the last axis with no scale or shift."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


def _modulated(x, shift, scale):
    return _norm(x) * (1 + scale[:, None]) + shift[:, None]


class DiT:
    """denoise(x, t, text, uncond) → the x0 prediction [B, T, F]."""

    def __init__(self, P: dict, cfg: dict, prec: Precision = EXACT):
        self.P = {k: v.float() for k, v in P.items()}
        self.cfg, self.prec = cfg, prec
        self.table = sinusoid_table(5000, cfg["latent_dim"], next(iter(P.values())).device)

    def __call__(self, x, t, text, uncond, obs_x0=None, obs_mask=None):
        P, prec, cfg = self.P, self.prec, self.cfg

        def lin(h, name):
            return dense(h, P[f"{name}.weight"], P[f"{name}.bias"], prec)

        c = timestep_embedding(P, t, self.table, prec) + text_embedding(P, text, uncond, prec)
        silu_c = F.silu(c)
        h = lin(x, "input_process") + self.table[: x.shape[1]]
        for i in range(cfg["layers"]):
            n = f"block{i}"
            sh_a, sc_a, g_a, sh_m, sc_m, g_m = lin(silu_c, f"{n}.adaln.mod").chunk(6, dim=-1)
            a = attention(lin(_modulated(h, sh_a, sc_a), f"{n}.attn.qkv"), cfg["heads"], prec)
            h = h + g_a[:, None] * lin(a, f"{n}.attn.out")
            f = lin(gelu(lin(_modulated(h, sh_m, sc_m), f"{n}.mlp.fc1")), f"{n}.mlp.fc2")
            h = h + g_m[:, None] * f
        shift, scale = lin(silu_c, "output_process.adaln.mod").chunk(2, dim=-1)
        return lin(_modulated(h, shift, scale), "output_process.proj")


Model = DiT


def forward_flops(cfg, B, frames) -> float:
    """Model FLOPs of a forward at batch B over `frames` frames: every Dense
    layer (the adaLN modulation Denses over c included) and attention's two
    products."""
    F_, D, FF = cfg["njoints"], cfg["latent_dim"], cfg["ff_size"]
    T = frames
    total = dense_flops(B, D, D) * 2 + dense_flops(B, cfg["clip_dim"], D)
    total += dense_flops(B, F_, D, T) + dense_flops(B, D, 2 * D) + dense_flops(B, D, F_, T)
    per_block = (dense_flops(B, D, 6 * D) + dense_flops(B, D, 3 * D, T)
                 + attention_counts.flops(B, T, D, cfg["heads"]) + dense_flops(B, D, D, T)
                 + dense_flops(B, D, FF, T) + dense_flops(B, FF, D, T))
    return total + cfg["layers"] * per_block
