"""MDM transformer denoiser, float mode, for sampling.

Counterpart of condmdi_tpu/models/mdm.py for arch `trans_enc` and
`trans_dec` (with or without `emb_trans_dec`) and cond modes `text`,
`action` and `no_cond`:

  * input_process: Dense F → D;
  * a conditioning embedding: timestep MLP + text Dense (+ action row), with
    `y["uncond"]` (a bool or a [B] bool mask) zeroing the text or action;
  * trans_enc: the embedding prepended as a token, the sinusoidal table added
    over [cond, frames], N post-LN encoder layers (torch
    TransformerEncoderLayer semantics, exact-erf GELU, LayerNorm eps 1e-5);
  * trans_dec: N post-LN decoder layers over the frames (with the token
    prepended if `emb_trans_dec`), cross-attending to the embedding;
  * output_process: Dense D → F.

Submodules keep the Flax names (`layer{i}.qkv`, `norm1`, `embed_text`,
`input_process`, …) so weights.load_flax_params maps a Flax tree onto this
state_dict. The layout is [B, T, F].

Every self-attention goes through ops.attention: the Hopper kernel on CUDA,
its plain version on the CPU. The decoder's cross-attention to the one
conditioning token takes the plain version on every device, as in JAX. The
Dense projections, LayerNorm and GELU are plain PyTorch; the JAX package
left them to XLA. The model takes no obs_x0/obs_mask: keyframes reach it
through the sampler's InpaintingState.

`precision_mode="int8"` runs the encoder layers' four projections (`qkv`,
`attn_out`, `ff1`, `ff2`) as int8 QDense, as the JAX package does; attention
and every other Dense stay float.

Not ported here (ROADMAP Queue A 1): arch `gru` and the `*_large` output
head. Dropout and the classifier-free condition dropout act only in
training, which waits for its own slice.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.models.cfg import mask_cond
from condmdi_tpu_torch.models.embeddings import EmbedAction, PositionalEncoding, TimestepEmbedder
from condmdi_tpu_torch.models.layers import Dense, LayerNorm, init_params
from condmdi_tpu_torch.ops.attention import mha, multihead_attention
from condmdi_tpu_torch.ops.quant import QuantizedWeight, int8_matmul


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    """Exact-erf GELU (Flax `gelu(approximate=False)`) or ReLU."""
    return F.gelu(x) if activation == "gelu" else F.relu(x)


class QDense(Dense):
    """Dense with the JAX package's precision switch: "float", or "int8"
    (per-output-feature weight codes made in the weight's dtype, dynamic
    per-tensor activation scale, int32 accumulation) through
    ops.quant.int8_matmul: the Hopper int8 kernel on CUDA, its plain version
    on the CPU. The weight is quantized once per parameter and remade when it
    changes (`QuantizedWeight`)."""

    def __init__(self, in_features, out_features, precision_mode="float", *, device=None,
                 dtype=None):
        if precision_mode not in ("float", "int8"):
            raise ValueError(f"QDense precision_mode={precision_mode!r}: 'float' or 'int8'")
        super().__init__(in_features, out_features, device=device, dtype=dtype)
        self.precision_mode = precision_mode
        self.quantized = QuantizedWeight()

    def forward(self, x):
        if self.precision_mode == "float":
            return super().forward(x)
        q = self.quantized.get(self.weight, self.bias)
        return int8_matmul(x, self.weight, q.bias, packed=q.packed, quantized=(q.wq, q.w_scale))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: x = LN(x + Attn(x)); x = LN(x + FFN(x))."""

    def __init__(self, d_model, num_heads, ff_size, activation="gelu", precision_mode="float",
                 *, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.activation = activation
        self.qkv = QDense(d_model, 3 * d_model, precision_mode, **dd)
        self.attn_out = QDense(d_model, d_model, precision_mode, **dd)
        self.norm1 = LayerNorm(d_model, **dd)
        self.ff1 = QDense(d_model, ff_size, precision_mode, **dd)
        self.ff2 = QDense(ff_size, d_model, precision_mode, **dd)
        self.norm2 = LayerNorm(d_model, **dd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.attn_out(multihead_attention(self.qkv(x), self.num_heads)))
        return self.norm2(x + self.ff2(activate(self.ff1(x), self.activation)))


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer: self-attention, cross-attention to memory, FFN."""

    def __init__(self, d_model, num_heads, ff_size, activation="gelu", *, device=None,
                 dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.activation = activation
        self.qkv = Dense(d_model, 3 * d_model, **dd)
        self.attn_out = Dense(d_model, d_model, **dd)
        self.norm1 = LayerNorm(d_model, **dd)
        self.q_proj = Dense(d_model, d_model, **dd)
        self.kv_proj = Dense(d_model, 2 * d_model, **dd)
        self.cross_out = Dense(d_model, d_model, **dd)
        self.norm2 = LayerNorm(d_model, **dd)
        self.ff1 = Dense(d_model, ff_size, **dd)
        self.ff2 = Dense(ff_size, d_model, **dd)
        self.norm3 = LayerNorm(d_model, **dd)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.attn_out(multihead_attention(self.qkv(x), self.num_heads)))
        k, v = self.kv_proj(memory).chunk(2, dim=-1)
        x = self.norm2(x + self.cross_out(mha(self.q_proj(x), k, v, self.num_heads)))
        return self.norm3(x + self.ff2(activate(self.ff1(x), self.activation)))


def cal_multiple(n: int, multiple: int) -> int:
    """Round n up to the next multiple."""
    return n if n % multiple == 0 else (n // multiple + 1) * multiple


class MDM(nn.Module):
    """Motion Diffusion Model transformer denoiser.

    Built on `device` ("cuda" unless the caller passes "cpu"); parameters are
    allocated empty and filled from `seed` (init_params) unless `seed` is None,
    as when a checkpoint is loaded next.
    """

    def __init__(self, njoints=263, nfeats=1, latent_dim=512, ff_size=1024, num_layers=8,
                 num_heads=4, activation="gelu", clip_dim=512, arch="trans_enc",
                 emb_trans_dec=False, cond_mode="text", num_actions=1, precision_mode="float",
                 *, device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        if arch.endswith("_large"):
            raise NotImplementedError(
                f"arch {arch!r}: the *_large output head waits for a later slice (ROADMAP Queue A 1)"
            )
        if arch.startswith("gru"):
            raise NotImplementedError(
                f"arch {arch!r}: the GRU denoiser waits for a later slice (ROADMAP Queue A 1)"
            )
        if not arch.startswith(("trans_enc", "trans_dec")):
            raise ValueError(f"unknown arch {arch}")
        device = resolve_device(device)
        dd = dict(device=device, dtype=dtype)
        self.encoder = arch.startswith("trans_enc")
        self.emb_trans_dec = emb_trans_dec
        self.cond_mode = cond_mode
        self.num_layers = num_layers
        self.input_feats = njoints * nfeats
        self.embed_timestep = TimestepEmbedder(latent_dim, **dd)
        if "text" in cond_mode:
            self.embed_text = Dense(clip_dim, latent_dim, **dd)
        if "action" in cond_mode:
            self.embed_action = EmbedAction(num_actions, latent_dim, **dd)
        self.input_process = Dense(self.input_feats, latent_dim, **dd)
        self.pos_enc = PositionalEncoding(latent_dim, device=device)
        for i in range(num_layers):
            if self.encoder:
                layer = TransformerEncoderLayer(latent_dim, num_heads, ff_size, activation,
                                                precision_mode, **dd)
            else:
                layer = TransformerDecoderLayer(latent_dim, num_heads, ff_size, activation, **dd)
            self.add_module(f"layer{i}", layer)
        self.output_process = Dense(latent_dim, self.input_feats, **dd)
        if seed is not None:
            init_params(self, seed)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, F]
        timesteps: torch.Tensor,  # [B]
        y: Optional[dict[str, Any]] = None,
    ) -> torch.Tensor:
        y = y or {}
        emb = self.embed_timestep(timesteps)
        force_mask = y.get("uncond", False)
        if "text" in self.cond_mode and "text_embed" in y:
            emb = emb + self.embed_text(mask_cond(y["text_embed"].to(x.dtype), force_mask))
        if "action" in self.cond_mode and "action" in y:
            emb = emb + mask_cond(self.embed_action(y["action"]), force_mask)

        h = self.input_process(x)  # [B, T, D]
        layers = [getattr(self, f"layer{i}") for i in range(self.num_layers)]
        if self.encoder:
            xseq = self.pos_enc(torch.cat([emb[:, None, :], h], dim=1))  # [B, T+1, D]
            for layer in layers:
                xseq = layer(xseq)
            out = xseq[:, 1:, :]
        else:
            memory = emb[:, None, :]
            xseq = torch.cat([memory, h], dim=1) if self.emb_trans_dec else h
            xseq = self.pos_enc(xseq)
            for layer in layers:
                xseq = layer(xseq, memory)
            out = xseq[:, 1:, :] if self.emb_trans_dec else xseq
        return self.output_process(out)  # [B, T, F]
