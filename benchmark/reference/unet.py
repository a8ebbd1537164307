"""CondMDI's temporal UNet denoiser (keyframe-conditioned, AdaGN), plain float32.

From the paper (arXiv 2405.11126, section 4 and the appendix) and its card
`motion_abs_unet_adagn_xl`: the noisy motion with the observed keyframes put in
place, beside the observation mask, as 2F input channels; a timestep MLP plus
the text Dense as the conditioning vector; a 1-D UNet of `len(dim_mults)`
levels of two residual blocks each (conv k5 → GroupNorm(8) → AdaGN
(1 + scale, shift from the conditioning) → Mish, then conv k5 → GroupNorm →
Mish, plus a residual 1×1 conv where the width changes), a stride-2 conv down
and a transposed conv up, skip connections concatenated, a last block and a
1×1 conv back to F features. The input is zero-padded in time to `pad`.

With `bf16_input` (training under the card's `use_fp16`) the input reaches the
model in bfloat16 and the float32 parameters promote, as in the paper's code:
x, the keyframes and the text are rounded to bfloat16, the first block's
residual conv (1×1) computes in bfloat16, and its first half computes from
bfloat16-rounded operands; the rest is float32. The roundings pass their
gradients through rounded too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.counts import resblock as resblock_counts
from benchmark.counts.models import dense as dense_flops
from benchmark.reference.layers import (
    EXACT,
    conv1d,
    conv_transpose1d,
    dense,
    group_norm,
    mish,
    sinusoid_table,
    text_embedding,
    timestep_embedding,
)
from benchmark.reference.precision import Precision

GROUPS = 8


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _same(x):
    return x


def widths(cfg) -> list[tuple[int, int]]:
    F = cfg["njoints"]
    dims = [F] + [int(cfg["latent_dim"] * m) for m in cfg["dim_mults"]]
    return list(zip(dims[:-1], dims[1:]))


def param_specs(cfg) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, role) of every weight, in the port's state_dict names. Roles:
    'kernel' (fan-in scaled), 'bias', 'norm_scale', 'norm_bias'."""
    F, D = cfg["njoints"], cfg["latent_dim"]
    specs = []

    def lin(name, cin, cout):
        specs.extend([(f"{name}.weight", (cout, cin), "kernel"), (f"{name}.bias", (cout,), "bias")])

    def conv(name, cin, cout, k):
        specs.extend([(f"{name}.weight", (cout, cin, k), "kernel"),
                      (f"{name}.bias", (cout,), "bias")])

    def resblock(name, cin, cout):
        lin(f"{name}.time_mlp", D, 2 * cout)
        if cin != cout:
            conv(f"{name}.residual_conv", cin, cout, 1)
        for half, c_in in (("block1", cin), ("block2", cout)):
            conv(f"{name}.{half}.conv", c_in, cout, 5)
            specs.extend([(f"{name}.{half}.norm.weight", (cout,), "norm_scale"),
                          (f"{name}.{half}.norm.bias", (cout,), "norm_bias")])

    lin("embed_timestep.fc1", D, D)
    lin("embed_timestep.fc2", D, D)
    lin("embed_text", cfg["clip_dim"], D)
    lin("unet.time_fc1", D, 4 * D)
    lin("unet.time_fc2", 4 * D, D)
    levels = widths(cfg)
    for i, (cin, cout) in enumerate(levels):
        resblock(f"unet.down{i}_res1", 2 * F if i == 0 else cin, cout)
        resblock(f"unet.down{i}_res2", cout, cout)
        if i < len(levels) - 1:
            conv(f"unet.down{i}_downsample", cout, cout, 3)
    mid = levels[-1][1]
    resblock("unet.mid_block1", mid, mid)
    resblock("unet.mid_block2", mid, mid)
    for i, (cin, cout) in enumerate(reversed(levels[1:])):
        resblock(f"unet.up{i}_res1", 2 * cout, cin)
        resblock(f"unet.up{i}_res2", cin, cin)
        specs.extend([(f"unet.up{i}_upsample.weight", (cin, cin, 4), "kernel"),
                      (f"unet.up{i}_upsample.bias", (cin,), "bias")])
    first = levels[0][1]
    conv("unet.final_block.conv", first, first, 5)
    specs.extend([("unet.final_block.norm.weight", (first,), "norm_scale"),
                  ("unet.final_block.norm.bias", (first,), "norm_bias")])
    conv("unet.final_conv", first, F, 1)
    return specs


def _half(P, name, x, prec, scale=None, shift=None, res=None, q=_same):
    w, b = q(P[f"{name}.conv.weight"]), q(P[f"{name}.conv.bias"])
    y = conv1d(x, w, b, padding=w.shape[-1] // 2, prec=prec)
    y = group_norm(y, P[f"{name}.norm.weight"], P[f"{name}.norm.bias"], GROUPS)
    if scale is not None:
        y = y * (1.0 + scale[:, None, :]) + shift[:, None, :]
    y = mish(y)
    return y if res is None else y + res


def _conv1x1_bf16(x, w, b):
    """A 1×1 conv computed in bfloat16: operands and output bfloat16, the sums float32."""
    x = x[..., : w.shape[1]].to(torch.bfloat16)
    return F.linear(x, w[:, :, 0].to(torch.bfloat16), b.to(torch.bfloat16)).to(torch.float32)


def _resblock(P, name, x, c, prec, bf16=False):
    """`bf16`: the block reads a bfloat16 input (the first block under
    `bf16_input`), so its residual conv computes in bfloat16 and its first half
    from bfloat16-rounded operands."""
    cond = dense(c, P[f"{name}.time_mlp.weight"], P[f"{name}.time_mlp.bias"], prec)
    scale, shift = cond.chunk(2, dim=-1)
    w, b = P.get(f"{name}.residual_conv.weight"), P.get(f"{name}.residual_conv.bias")
    if w is None:
        res = x
    elif bf16:
        res = _conv1x1_bf16(x, w, b)
    else:
        res = conv1d(x, w, b, prec=prec)
    h = _half(P, f"{name}.block1", x, prec, scale, shift, q=_bf16 if bf16 else _same)
    return _half(P, f"{name}.block2", h, prec, res=res)


class UNet:
    """denoise(x, t, text, uncond, obs_x0, obs_mask) → the x0 prediction [B, T, F]."""

    def __init__(self, P: dict, cfg: dict, prec: Precision = EXACT, bf16_input: bool = False):
        self.P = {k: v.float() for k, v in P.items()}
        self.cfg, self.prec = cfg, prec
        self.bf16_input = bf16_input
        self.table = sinusoid_table(5000, cfg["latent_dim"], next(iter(P.values())).device)

    def __call__(self, x, t, text, uncond, obs_x0, obs_mask):
        P, prec, cfg = self.P, self.prec, self.cfg
        if self.bf16_input:
            x, obs_x0, text = _bf16(x), _bf16(obs_x0), _bf16(text)
        B, T, F = x.shape
        m = obs_mask.float()
        inp = torch.cat([obs_x0 * m + x * (1.0 - m), m], dim=-1)
        h = torch.zeros((B, cfg["pad"], 2 * F), device=x.device)
        h[:, :T] = inp
        emb = timestep_embedding(P, t, self.table, prec) + text_embedding(P, text, uncond, prec)
        c = mish(dense(mish(dense(emb, P["unet.time_fc1.weight"], P["unet.time_fc1.bias"], prec)),
                       P["unet.time_fc2.weight"], P["unet.time_fc2.bias"], prec))
        levels = len(cfg["dim_mults"])
        skips = []
        for i in range(levels):
            h = _resblock(P, f"unet.down{i}_res1", h, c, prec, self.bf16_input and i == 0)
            h = _resblock(P, f"unet.down{i}_res2", h, c, prec)
            skips.append(h)
            if i < levels - 1:
                h = conv1d(h, P[f"unet.down{i}_downsample.weight"],
                           P[f"unet.down{i}_downsample.bias"], stride=2, padding=1, prec=prec)
        h = _resblock(P, "unet.mid_block1", h, c, prec)
        h = _resblock(P, "unet.mid_block2", h, c, prec)
        for i in range(levels - 1):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _resblock(P, f"unet.up{i}_res1", h, c, prec)
            h = _resblock(P, f"unet.up{i}_res2", h, c, prec)
            h = conv_transpose1d(h, P[f"unet.up{i}_upsample.weight"],
                                 P[f"unet.up{i}_upsample.bias"], prec=prec)
        h = _half(P, "unet.final_block", h, prec)
        out = conv1d(h, P["unet.final_conv.weight"], P["unet.final_conv.bias"], prec=prec)
        return out[:, :T, :F]


Model = UNet


def forward_flops(cfg, B, frames) -> float:
    """Model FLOPs of a forward at batch B: every convolution, dense layer and
    resblock half, over the input padded to `pad` (whatever `frames`)."""
    F, D, pad = cfg["njoints"], cfg["latent_dim"], cfg["pad"]
    dims = [F] + [int(D * m) for m in cfg["dim_mults"]]
    levels = list(zip(dims[:-1], dims[1:]))
    total = dense_flops(B, D, D) * 2 + dense_flops(B, cfg["clip_dim"], D)  # timestep MLP, text
    total += dense_flops(B, D, 4 * D) + dense_flops(B, 4 * D, D)  # the UNet's time MLP

    def block(T, cin, cout):
        n = dense_flops(B, D, 2 * cout)  # time_mlp
        n += resblock_counts.flops(B, T, cin, cout) + resblock_counts.flops(B, T, cout, cout)
        return n + (dense_flops(B, cin, cout, T) if cin != cout else 0.0)

    T = pad
    for i, (cin, cout) in enumerate(levels):
        total += block(T, 2 * F if i == 0 else cin, cout) + block(T, cout, cout)
        if i < len(levels) - 1:
            T //= 2
            total += 2.0 * B * T * cout * cout * 3  # stride-2 conv k3
    mid = levels[-1][1]
    total += 2 * block(T, mid, mid)
    for cin, cout in reversed(levels[1:]):
        total += block(T, 2 * cout, cin) + block(T, cin, cin)
        total += 2.0 * B * T * cin * cin * 4  # transposed conv k4, stride 2
        T *= 2
    first = levels[0][1]
    total += resblock_counts.flops(B, T, first, first) + dense_flops(B, first, F, T)
    return total
