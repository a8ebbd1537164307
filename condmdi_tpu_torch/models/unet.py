"""Temporal 1-D UNet denoiser (CondMDI's flagship model), float mode.

Counterpart of condmdi_tpu/models/unet.py with `attention=False` and
`precision_mode="float"` (LinearAttention and the int8 QConv modes wait for
later slices). Submodules keep the Flax names (`down0_res1.block1.conv`, …)
so weights.py maps a Flax tree onto this state_dict by layout transforms
alone. The layout is [B, T, C].

Every resblock half (Conv1dBlock, Conv1dAdaGNBlock) calls
ops.resblock.fused_conv_gn_mish: the Hopper kernel on CUDA, its plain
version on the CPU. The bf16 kernel reads a packed copy of the conv weight,
which each half keeps and remakes when its weight changes; MDM_UNET pads its
input's channels to a multiple of 8 (526 → 528) so that the kernel's rows
are 16-byte aligned, and the first resblock ignores the padding. Downsample (k3 s2 p1), residual_conv (1×1), final_conv
(1×1) and the upsample ConvTranspose (k4 s2, Flax 'SAME' ≡ torch padding 1)
are plain convolutions the JAX package left to XLA; here they stay
F.conv1d / F.linear / F.conv_transpose1d.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.models.cfg import mask_cond
from condmdi_tpu_torch.models.embeddings import TimestepEmbedder
from condmdi_tpu_torch.models.layers import (
    ConvParams,
    ConvTransposeParams,
    Dense,
    GroupNormParams,
    init_params,
)
from condmdi_tpu_torch.ops.resblock import PackedConvWeight, fused_conv_gn_mish, mish


def _conv1d(x: torch.Tensor, p: ConvParams, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """A plain conv on [B, T, C]: 1×1 as a matmul, wider kernels via F.conv1d."""
    if p.weight.shape[-1] == 1 and stride == 1 and padding == 0:
        return F.linear(x, p.weight[:, :, 0], p.bias)
    y = F.conv1d(x.transpose(1, 2), p.weight, p.bias, stride=stride, padding=padding)
    return y.transpose(1, 2).contiguous()


class _ResblockHalf(nn.Module):
    """What both resblock halves hold: the conv and norm parameters, and the bf16
    kernel's packed copy of the conv weight (a plain attribute, not in the
    state_dict, remade when the weight changes)."""

    def __init__(self, in_channels, out_channels, kernel_size, n_groups, zero, device, dtype):
        super().__init__()
        self.n_groups = n_groups
        self.conv = ConvParams(in_channels, out_channels, kernel_size, zero_init=zero,
                               device=device, dtype=dtype)
        self.norm = GroupNormParams(out_channels, device=device, dtype=dtype)
        self.packed = PackedConvWeight()


class Conv1dBlock(_ResblockHalf):
    """Conv(k) → GroupNorm(8) → Mish (→ +res), one fused kernel call."""

    def __init__(self, in_channels, out_channels, kernel_size=5, n_groups=8, zero=False,
                 *, device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, n_groups, zero, device, dtype)

    def forward(self, x, res=None):
        return fused_conv_gn_mish(
            x, self.conv.weight, self.conv.bias, self.norm.weight, self.norm.bias,
            res=res, n_groups=self.n_groups, packed=self.packed,
        )


class Conv1dAdaGNBlock(_ResblockHalf):
    """Conv → GroupNorm → (1+scale)·x + shift → Mish, one fused kernel call."""

    def __init__(self, in_channels, out_channels, kernel_size=5, n_groups=8,
                 *, device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, n_groups, False, device, dtype)

    def forward(self, x, scale, shift):
        return fused_conv_gn_mish(
            x, self.conv.weight, self.conv.bias, self.norm.weight, self.norm.bias,
            scale=scale.to(x.dtype), shift=shift.to(x.dtype), n_groups=self.n_groups,
            packed=self.packed,
        )


class ResidualTemporalBlock(nn.Module):
    def __init__(self, in_channels, out_channels, embed_dim, kernel_size=5, adagn=True,
                 zero=True, *, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.adagn = adagn
        cond_dim = out_channels * 2 if adagn else out_channels
        self.time_mlp = Dense(embed_dim, cond_dim, zero_init=adagn, **dd)
        if in_channels != out_channels:
            self.residual_conv = ConvParams(in_channels, out_channels, 1, **dd)
        else:
            self.residual_conv = None
        if adagn:
            self.block1 = Conv1dAdaGNBlock(in_channels, out_channels, kernel_size, **dd)
        else:
            self.block1 = Conv1dBlock(in_channels, out_channels, kernel_size, **dd)
        self.block2 = Conv1dBlock(out_channels, out_channels, kernel_size, zero=zero, **dd)

    def forward(self, x, t_act):
        """x: [B, T, C_in (+ alignment channels, which block1 ignores)]; t_act: [B, E],
        the time embedding after its Mish (the same for every block, so the caller
        takes it once)."""
        cond = self.time_mlp(t_act)
        if self.residual_conv is None:
            res = x
        else:
            res = _conv1d(x[..., : self.residual_conv.weight.shape[1]], self.residual_conv)
        if self.adagn:
            scale, shift = cond.chunk(2, dim=-1)
            h = self.block1(x, scale, shift)
        else:
            h = self.block1(x) + cond[:, None, :].to(x.dtype)
        return self.block2(h, res=res)


class TemporalUnet(nn.Module):
    def __init__(self, input_dim, cond_dim, dim=512, dim_mults: Sequence[float] = (2, 2, 2, 2),
                 adagn=True, zero=True, added_input_channels=0, *, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        # the keyframe-conditioned input carries the mask beside the motion
        in_ch = input_dim + added_input_channels
        dims = [input_dim] + [int(dim * m) for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.n_res = len(in_out)
        rb = dict(embed_dim=dim, adagn=adagn, zero=zero, **dd)

        self.time_fc1 = Dense(cond_dim, dim * 4, **dd)
        self.time_fc2 = Dense(dim * 4, dim, **dd)
        for ind, (dim_in, dim_out) in enumerate(in_out):
            first_in = in_ch if ind == 0 else dim_in
            self.add_module(f"down{ind}_res1", ResidualTemporalBlock(first_in, dim_out, **rb))
            self.add_module(f"down{ind}_res2", ResidualTemporalBlock(dim_out, dim_out, **rb))
            if ind < self.n_res - 1:
                self.add_module(f"down{ind}_downsample", ConvParams(dim_out, dim_out, 3, **dd))
        mid = dims[-1]
        self.mid_block1 = ResidualTemporalBlock(mid, mid, **rb)
        self.mid_block2 = ResidualTemporalBlock(mid, mid, **rb)
        self.n_up = len(in_out) - 1
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out[1:])):
            self.add_module(f"up{ind}_res1", ResidualTemporalBlock(dim_out * 2, dim_in, **rb))
            self.add_module(f"up{ind}_res2", ResidualTemporalBlock(dim_in, dim_in, **rb))
            # `is_last` in the JAX loop compares against n_res - 1, which this
            # loop of n_res - 1 items never reaches: every level upsamples
            self.add_module(f"up{ind}_upsample", ConvTransposeParams(dim_in, dim_in, 4, **dd))
        self.final_block = Conv1dBlock(dims[1], dims[1], kernel_size=5, **dd)
        self.final_conv = ConvParams(dims[1], input_dim, 1, zero_init=zero, **dd)

    def forward(self, x, cond):
        """x: [B, T, C] (T divisible by 2^(len(dim_mults)-1)); cond: [B, cond_dim]."""
        c = mish(self.time_fc2(mish(self.time_fc1(cond))))  # every block's time_mlp(mish(·)) input
        h = []
        for ind in range(self.n_res):
            x = getattr(self, f"down{ind}_res1")(x, c)
            x = getattr(self, f"down{ind}_res2")(x, c)
            h.append(x)
            if ind < self.n_res - 1:
                x = _conv1d(x, getattr(self, f"down{ind}_downsample"), stride=2, padding=1)
        x = self.mid_block1(x, c)
        x = self.mid_block2(x, c)
        for ind in range(self.n_up):
            x = torch.cat([x, h.pop()], dim=-1)
            x = getattr(self, f"up{ind}_res1")(x, c)
            x = getattr(self, f"up{ind}_res2")(x, c)
            up = getattr(self, f"up{ind}_upsample")
            x = F.conv_transpose1d(x.transpose(1, 2), up.weight, up.bias, stride=2, padding=1)
            x = x.transpose(1, 2).contiguous()
        x = self.final_block(x)
        return _conv1d(x, self.final_conv)


class MDM_UNET(nn.Module):
    """UNet denoiser wrapper with keyframe + text/timestep conditioning.

    Built on `device` ("cuda" unless the caller passes "cpu"); parameters are
    allocated empty and filled from `seed` (init_params) unless `seed` is None,
    as when a checkpoint is loaded next.
    """

    def __init__(self, njoints=263, nfeats=1, latent_dim=512,
                 dim_mults: Sequence[float] = (2, 2, 2, 2), adagn=True, zero=True,
                 clip_dim=512, cond_mode="text", keyframe_conditioned=False,
                 pad_frames_to=224, *, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32, seed: Optional[int] = 0):
        super().__init__()
        if cond_mode != "text":
            raise NotImplementedError("only text conditioning is ported")
        device = resolve_device(device)
        dd = dict(device=device, dtype=dtype)
        self.input_feats = njoints * nfeats
        self.latent_dim = latent_dim
        self.keyframe_conditioned = keyframe_conditioned
        self.pad_frames_to = pad_frames_to
        self.embed_timestep = TimestepEmbedder(latent_dim, **dd)
        self.embed_text = Dense(clip_dim, latent_dim, **dd)
        self.unet = TemporalUnet(
            input_dim=self.input_feats, cond_dim=latent_dim, dim=latent_dim,
            dim_mults=dim_mults, adagn=adagn, zero=zero,
            added_input_channels=self.input_feats if keyframe_conditioned else 0, **dd,
        )
        if seed is not None:
            init_params(self, seed)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, F]
        timesteps: torch.Tensor,  # [B]
        y: Optional[dict[str, Any]] = None,
        obs_x0: Optional[torch.Tensor] = None,
        obs_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        y = y or {}
        B, T, Fdim = x.shape
        if (obs_x0 is None) != (obs_mask is None):
            raise ValueError("obs_x0 and obs_mask come together")

        if T > self.pad_frames_to:
            raise ValueError(f"{T} frames > pad target {self.pad_frames_to}")
        # One zeroed buffer takes the input: right-padded to the UNet length (a
        # multiple of 2^depth) and to a channel count that is a multiple of 8, so
        # that the resblock kernel's rows are 16-byte aligned (2F = 526 -> 528).
        # The first resblock ignores the alignment channels.
        channels = 2 * Fdim if self.keyframe_conditioned else Fdim
        buf = x.new_zeros((B, self.pad_frames_to, -(-channels // 8) * 8))
        if self.keyframe_conditioned:
            m = obs_mask.to(x.dtype)
            buf[:, :T, :Fdim] = obs_x0.to(x.dtype) * m + x * (1.0 - m)
            buf[:, :T, Fdim:channels] = m  # [B, T, 2F]
        else:
            buf[:, :T, :Fdim] = x

        emb = self.embed_timestep(timesteps)
        if "text_embed" in y:
            enc_text = y["text_embed"].to(emb.dtype)
            emb = emb + self.embed_text(mask_cond(enc_text, y.get("uncond", False)))

        x = self.unet(buf, emb)
        x = x[:, :T, :]
        if self.keyframe_conditioned:
            x = x[..., :Fdim]
        return x
