"""DiT-style denoisers with adaLN(-Zero) conditioning, for sampling.

Counterpart of condmdi_tpu/models/dit.py, with the same block zoo and arch
dispatch:

  dit_prenorm    adaLN-Zero pre-norm blocks, final norm before prediction
  dit_postnorm   post-norm blocks (torch TransformerEncoderLayer style)
  dit_concat     skip-concat input modulation blocks + final norm + skip out
  dit_concatv2   skip concat inside the MLP, no final norm, skip out
  dit_concatv3   v2 blocks without output-module skip
  *_scale        scale-only modulation (no shifts)

plus the optional second output head (`two_head`). Submodules keep the Flax
names (`block{i}.adaln.mod`, `attn.qkv`, `mlp.fc1`, …); a parameter-free
LayerNorm (Flax `use_bias=False, use_scale=False`) is a function call here
and has no state-dict entry. Every block's self-attention goes through
ops.attention.mha: the Hopper kernel on CUDA, its plain version on the CPU.

A forward given `draws` (a layers.TrainDraws) is the training forward:
condition dropout at `cond_mask_prob`, and dropout at `dropout` after the
positional encoding and after each MLP's activation, as in the Flax module.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.models.cfg import mask_cond
from condmdi_tpu_torch.models.embeddings import EmbedAction, PositionalEncoding, TimestepEmbedder
from condmdi_tpu_torch.models.layers import Dense, LayerNorm, dropout, init_params
from condmdi_tpu_torch.ops.attention import mha


def modulate(x: torch.Tensor, shift: Optional[torch.Tensor], scale: torch.Tensor) -> torch.Tensor:
    out = x * (1 + scale)
    return out + shift if shift is not None else out


def _plain_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without scale or bias, eps 1e-5."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-5)


class AdaLN(nn.Module):
    """SiLU → zero-init Dense producing n_chunks [B, 1, d_model] modulation tensors."""

    def __init__(self, cond_dim, d_model, n_chunks, *, device=None, dtype=None):
        super().__init__()
        self.n_chunks = n_chunks
        self.mod = Dense(cond_dim, n_chunks * d_model, zero_init=True, device=device, dtype=dtype)

    def forward(self, c: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.mod(F.silu(c))[:, None, :].chunk(self.n_chunks, dim=-1)


class _Attn(nn.Module):
    def __init__(self, d_model, num_heads, *, device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(d_model, 3 * d_model, device=device, dtype=dtype)
        self.out = Dense(d_model, d_model, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.out(mha(q, k, v, self.num_heads))


class _MLP(nn.Module):
    def __init__(self, d_model, ff_size, dropout=0.1, *, device=None, dtype=None):
        super().__init__()
        self.dropout = dropout
        self.fc1 = Dense(d_model, ff_size, device=device, dtype=dtype)
        self.fc2 = Dense(ff_size, d_model, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        return self.fc2(dropout(F.gelu(self.fc1(x)), self.dropout, draws))


class DiTBlockPreNorm(nn.Module):
    def __init__(self, d_model, num_heads, ff_size, dropout=0.1, *, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.adaln = AdaLN(d_model, d_model, 6, **dd)
        self.attn = _Attn(d_model, num_heads, **dd)
        self.mlp = _MLP(d_model, ff_size, dropout, **dd)

    def forward(self, x, c, skip=None, draws=None):
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = self.adaln(c)
        x = x + g_a * self.attn(modulate(_plain_layer_norm(x), sh_a, sc_a))
        return x + g_m * self.mlp(modulate(_plain_layer_norm(x), sh_m, sc_m), draws)


class DiTBlockPostNorm(nn.Module):
    def __init__(self, d_model, num_heads, ff_size, dropout=0.1, *, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.adaln = AdaLN(d_model, d_model, 6, **dd)
        self.attn = _Attn(d_model, num_heads, **dd)
        self.norm1 = LayerNorm(d_model, **dd)
        self.mlp = _MLP(d_model, ff_size, dropout, **dd)
        self.norm2 = LayerNorm(d_model, **dd)

    def forward(self, x, c, skip=None, draws=None):
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = self.adaln(c)
        x = modulate(self.norm1(x + g_a * self.attn(x)), sh_a, sc_a)
        return modulate(self.norm2(x + g_m * self.mlp(x, draws)), sh_m, sc_m)


class DiTBlockConcat(nn.Module):
    """Skip-concat input modulation."""

    def __init__(self, d_model, num_heads, ff_size, dropout=0.1, *, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.adaln = AdaLN(d_model, d_model, 6, **dd)
        self.norm0 = LayerNorm(2 * d_model, **dd)
        self.linear0 = Dense(2 * d_model, d_model, **dd)
        self.attn = _Attn(d_model, num_heads, **dd)
        self.norm1 = LayerNorm(d_model, **dd)
        self.mlp = _MLP(d_model, ff_size, dropout, **dd)

    def forward(self, x, c, skip, draws=None):
        sc0, sc1, sh_a, sc_a, g_a, g_m = self.adaln(c)
        h = self.norm0(torch.cat([x, skip], dim=-1))
        h = self.linear0(modulate(h, None, torch.cat([sc0, sc1], dim=-1)))
        h = h + g_a * self.attn(h)
        h = modulate(self.norm1(h), sh_a, sc_a)
        return h + g_m * self.mlp(h, draws)


class DiTBlockConcatV2(nn.Module):
    """Skip concat inside the MLP."""

    def __init__(self, d_model, num_heads, ff_size, scale_only=False, dropout=0.1, *,
                 device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.scale_only = scale_only
        self.dropout = dropout
        self.adaln = AdaLN(d_model, d_model, 4 if scale_only else 6, **dd)
        self.attn = _Attn(d_model, num_heads, **dd)
        self.norm1 = LayerNorm(d_model, **dd)
        self.fc1 = Dense(2 * d_model, ff_size, **dd)
        self.fc2 = Dense(ff_size, d_model, **dd)
        self.norm2 = LayerNorm(d_model, **dd)

    def forward(self, x, c, skip, draws=None):
        if self.scale_only:
            sc_a, g_a, sc_m, g_m = self.adaln(c)
            sh_a = sh_m = None
        else:
            sh_a, sc_a, g_a, sh_m, sc_m, g_m = self.adaln(c)
        x = modulate(self.norm1(x + g_a * self.attn(x)), sh_a, sc_a)
        h = F.gelu(self.fc1(torch.cat([x, skip], dim=-1)))
        h = self.fc2(dropout(h, self.dropout, draws))
        return modulate(self.norm2(x + g_m * h), sh_m, sc_m)


class DiTOutput(nn.Module):
    """Final prediction head with optional skip concat and norm + adaLN."""

    def __init__(self, out_feats, d_model, norm=False, skip=False, scale_only=False, *,
                 device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.norm, self.skip, self.scale_only = norm, skip, scale_only
        in_dim = 2 * d_model if skip else d_model
        if norm:
            self.adaln = AdaLN(d_model, in_dim, 1 if scale_only else 2, **dd)
        self.proj = Dense(in_dim, out_feats, zero_init=True, **dd)

    def forward(self, x, c, skip=None):
        if self.skip and skip is not None:
            x = torch.cat([x, skip], dim=-1)
        if self.norm:
            if self.scale_only:
                (scale,) = self.adaln(c)
                shift = None
            else:
                shift, scale = self.adaln(c)
            x = modulate(_plain_layer_norm(x), shift, scale)
        return self.proj(x)


_BLOCKS = {
    "dit_prenorm": (DiTBlockPreNorm, dict(final_norm=True, use_skip=False)),
    "dit_postnorm": (DiTBlockPostNorm, dict(final_norm=False, use_skip=False)),
    "dit_concatv2": (DiTBlockConcatV2, dict(final_norm=False, use_skip=True)),
    "dit_concatv3": (DiTBlockConcatV2, dict(final_norm=False, use_skip=False)),
    "dit_concat": (DiTBlockConcat, dict(final_norm=True, use_skip=True)),
}


def _dispatch(arch: str):
    """(key, block class, wiring): longest-prefix match; anything else is prenorm."""
    for key in ("dit_concatv2", "dit_concatv3", "dit_concat", "dit_prenorm", "dit_postnorm"):
        if arch.startswith(key):
            return key, *_BLOCKS[key]
    return "dit_prenorm", *_BLOCKS["dit_prenorm"]


class MDM_DiT(nn.Module):
    """DiT denoiser. Built on `device` ("cuda" unless the caller passes "cpu");
    parameters come from `seed` (init_params) unless `seed` is None."""

    def __init__(self, njoints=263, nfeats=1, latent_dim=512, ff_size=1024, num_layers=8,
                 num_heads=4, clip_dim=512, arch="dit_prenorm", cond_mode="text", num_actions=1,
                 two_head=False, dropout=0.1, cond_mask_prob=0.1, *,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32, seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        dd = dict(device=device, dtype=dtype)
        _, block_cls, wiring = _dispatch(arch)
        scale_only = "scale" in arch
        self.cond_mode = cond_mode
        self.num_layers = num_layers
        self.two_head = two_head
        self.dropout = dropout
        self.cond_mask_prob = cond_mask_prob
        self.input_feats = njoints * nfeats
        self.embed_timestep = TimestepEmbedder(latent_dim, **dd)
        if "text" in cond_mode:
            self.embed_text = Dense(clip_dim, latent_dim, **dd)
        if "action" in cond_mode:
            self.embed_action = EmbedAction(num_actions, latent_dim, **dd)
        self.input_process = Dense(self.input_feats, latent_dim, **dd)
        self.pos_enc = PositionalEncoding(latent_dim, device=device)
        for i in range(num_layers):
            if block_cls is DiTBlockConcatV2:
                blk = block_cls(latent_dim, num_heads, ff_size, scale_only=scale_only,
                                dropout=dropout, **dd)
            else:
                blk = block_cls(latent_dim, num_heads, ff_size, dropout, **dd)
            self.add_module(f"block{i}", blk)
        head = dict(norm=wiring["final_norm"], skip=wiring["use_skip"], scale_only=scale_only)
        self.output_process = DiTOutput(self.input_feats, latent_dim, **head, **dd)
        if two_head:
            self.output_process2 = DiTOutput(self.input_feats, latent_dim, **head, **dd)
        if seed is not None:
            init_params(self, seed)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[dict[str, Any]] = None, draws=None):
        y = y or {}
        p = self.cond_mask_prob
        emb = self.embed_timestep(timesteps)
        force_mask = y.get("uncond", False)
        if "text" in self.cond_mode and "text_embed" in y:
            text = mask_cond(y["text_embed"].to(x.dtype), force_mask, p, draws)
            emb = emb + self.embed_text(text)
        if "action" in self.cond_mode and "action" in y:
            emb = emb + mask_cond(self.embed_action(y["action"]), force_mask, p, draws)

        h = dropout(self.pos_enc(self.input_process(x)), self.dropout, draws)
        skip = h
        for i in range(self.num_layers):
            h = getattr(self, f"block{i}")(h, emb, skip, draws)
        out = self.output_process(h, emb, skip)
        if self.two_head:
            return out, self.output_process2(h, emb, skip)
        return out
