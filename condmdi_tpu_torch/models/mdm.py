"""MDM transformer denoiser, float mode, for sampling.

Counterpart of condmdi_tpu/models/mdm.py for every arch (`trans_enc`,
`trans_dec` with or without `emb_trans_dec`, `gru`, and each with the
`_large` output head) and cond modes `text`, `action` and `no_cond`:

  * input_process: Dense F → D;
  * a conditioning embedding: timestep MLP + text Dense (+ action row), with
    `y["uncond"]` (a bool or a [B] bool mask) zeroing the text or action;
  * trans_enc: the embedding prepended as a token, the sinusoidal table added
    over [cond, frames], N post-LN encoder layers (torch
    TransformerEncoderLayer semantics, exact-erf GELU, LayerNorm eps 1e-5);
  * trans_dec: N post-LN decoder layers over the frames (with the token
    prepended if `emb_trans_dec`), cross-attending to the embedding;
  * gru: the sinusoidal table added over the frames, then N layers of Flax's
    GRU cell over time from a zero carry. As in the JAX package, the
    conditioning embedding does not reach the GRUs (the reference MDM
    concatenates it to every frame; ROADMAP Queue C 6);
  * output_process: Dense D → F, or for `*_large` OutputProcessLarge, the
    grouped-convolution head over the latent and the raw input.

Submodules keep the Flax names (`layer{i}.qkv`, `norm1`, `embed_text`,
`input_process`, `GRUCell_{i}.hr`, …) so weights.load_flax_params maps a Flax
tree onto this state_dict. The layout is [B, T, F].

Every self-attention goes through ops.attention: the Hopper kernel on CUDA,
its plain version on the CPU. The decoder's cross-attention to the one
conditioning token takes the plain version on every device, as in JAX. The
encoder layers' four projections (`QDense`) in float32 on CUDA take the
tf32x3 kernel of ops/dense.py where `dense_route` says so. Every other Dense
projection, LayerNorm, GELU, the GRU cells and the grouped convolutions are
plain PyTorch; the JAX package left them to XLA. The model
takes no obs_x0/obs_mask: keyframes reach it through the sampler's
InpaintingState.

`precision_mode="int8"` runs the encoder layers' four projections (`qkv`,
`attn_out`, `ff1`, `ff2`) as int8 QDense, as the JAX package does; attention
and every other Dense stay float.

Training: a forward given `draws` (a layers.TrainDraws) is the Flax
module's `train=True` call: the condition dropout at `cond_mask_prob` and
dropout at `dropout` where the Flax layers have it (after the positional
encoding, the attention output, the activation and the feed-forward output;
the decoder also after its cross-attention), all drawn from `draws`.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.models.cfg import mask_cond
from condmdi_tpu_torch.models.embeddings import EmbedAction, PositionalEncoding, TimestepEmbedder
from condmdi_tpu_torch.models.layers import Conv1d, Dense, LayerNorm, dropout, init_params
from condmdi_tpu_torch.ops.attention import mha, multihead_attention
from condmdi_tpu_torch.ops.dense import SplitDenseWeight, dense, dense_route
from condmdi_tpu_torch.ops.quant import QuantizedWeight, int8_matmul, live_scales
from condmdi_tpu_torch.ops.resblock import mish


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    """Exact-erf GELU (Flax `gelu(approximate=False)`) or ReLU."""
    return F.gelu(x) if activation == "gelu" else F.relu(x)


class QDense(Dense):
    """Dense with the JAX package's precision switch: "float", or "int8"
    (per-output-feature weight codes made in the weight's dtype, dynamic
    per-tensor activation scale, int32 accumulation) through
    ops.quant.int8_matmul: the Hopper int8 kernel on CUDA, its plain version
    on the CPU. The weight is quantized once per parameter and remade when it
    changes (`QuantizedWeight`).

    "float" on a float32 CUDA input takes the route `ops.dense.dense_route`
    names: the tf32x3 kernel (ops/dense.py; the weight split once per
    parameter and remade when it changes, `SplitDenseWeight`) or `F.linear`;
    `dense.routes` counts each. Every other input takes `F.linear`."""

    def __init__(self, in_features, out_features, precision_mode="float", *, device=None,
                 dtype=None):
        if precision_mode not in ("float", "int8"):
            raise ValueError(f"QDense precision_mode={precision_mode!r}: 'float' or 'int8'")
        super().__init__(in_features, out_features, device=device, dtype=dtype)
        self.precision_mode = precision_mode
        self.quantized = QuantizedWeight()
        self.split = SplitDenseWeight()

    def forward(self, x):
        if self.precision_mode == "float":  # the kernel in x's dtype, as the JAX QDense
            w, b = self.weight, self.bias
            if x.is_cuda and x.dtype == torch.float32:
                needs_grad = torch.is_grad_enabled() and (
                    x.requires_grad or w.requires_grad or b.requires_grad)
                route = dense_route(x.numel() // x.shape[-1], x.shape[-1], w.shape[0], x.dtype,
                                    needs_grad)
                dense.routes[route] += 1
                if route == "tf32x3":
                    return dense(x, self.split.get(w), b)
            return F.linear(x, w.to(x.dtype), b.to(x.dtype))
        q = self.quantized.get(self.weight, self.bias)
        w_scale, bias = q.w_scale, q.bias
        if torch.is_grad_enabled() and (self.weight.requires_grad or self.bias.requires_grad):
            w_scale, bias = live_scales(q, self.weight, self.bias)
        return int8_matmul(x, self.weight, bias, packed=q.packed, quantized=(q.wq, w_scale))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: x = LN(x + Attn(x)); x = LN(x + FFN(x))."""

    def __init__(self, d_model, num_heads, ff_size, activation="gelu", precision_mode="float",
                 dropout=0.1, *, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.activation = activation
        self.dropout = dropout
        self.qkv = QDense(d_model, 3 * d_model, precision_mode, **dd)
        self.attn_out = QDense(d_model, d_model, precision_mode, **dd)
        self.norm1 = LayerNorm(d_model, **dd)
        self.ff1 = QDense(d_model, ff_size, precision_mode, **dd)
        self.ff2 = QDense(ff_size, d_model, precision_mode, **dd)
        self.norm2 = LayerNorm(d_model, **dd)

    def forward(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        p = self.dropout
        a = self.attn_out(multihead_attention(self.qkv(x), self.num_heads))
        x = self.norm1(x + dropout(a, p, draws))
        h = dropout(activate(self.ff1(x), self.activation), p, draws)
        return self.norm2(x + dropout(self.ff2(h), p, draws))


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer: self-attention, cross-attention to memory, FFN."""

    def __init__(self, d_model, num_heads, ff_size, activation="gelu", dropout=0.1, *,
                 device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.activation = activation
        self.dropout = dropout
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

    def forward(self, x: torch.Tensor, memory: torch.Tensor, draws=None) -> torch.Tensor:
        p = self.dropout
        sa = self.attn_out(multihead_attention(self.qkv(x), self.num_heads))
        x = self.norm1(x + dropout(sa, p, draws))
        k, v = self.kv_proj(memory).chunk(2, dim=-1)
        ca = self.cross_out(mha(self.q_proj(x), k, v, self.num_heads))
        x = self.norm2(x + dropout(ca, p, draws))
        h = dropout(activate(self.ff1(x), self.activation), p, draws)
        return self.norm3(x + dropout(self.ff2(h), p, draws))


class GRUCell(nn.Module):
    """Flax's nn.GRUCell over a sequence, from a zero carry:
      r = σ(ir(x) + hr(h)),  z = σ(iz(x) + hz(h)),  n = tanh(in(x) + r ⊙ hn(h)),
      h' = (1 - z) ⊙ n + z ⊙ h,
    with ir/iz/in and hn biased, hr/hz not (so no b_hr, b_hz as torch.nn.GRU has),
    and the recurrent kernels initialised orthogonally."""

    def __init__(self, features: int, *, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(features, features, **dd))
        for name in ("hr", "hz"):
            self.add_module(name, Dense(features, features, use_bias=False, orthogonal=True, **dd))
        self.hn = Dense(features, features, orthogonal=True, **dd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] → every step's hidden state [B, T, D]."""
        i = [self._modules[n] for n in ("ir", "iz", "in")]
        w_h = torch.cat([self.hr.weight, self.hz.weight, self.hn.weight])
        b_h = F.pad(self.hn.bias, (2 * self.hn.bias.shape[0], 0))  # [0 | 0 | b_hn]
        # the input halves of the three gates for every step at once
        gi = F.linear(x, torch.cat([d.weight for d in i]), torch.cat([d.bias for d in i]))
        h = x.new_zeros(x.shape[0], x.shape[2])
        out = []
        for t in range(x.shape[1]):
            i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
            h_r, h_z, h_n = F.linear(h, w_h, b_h).chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
            out.append(h)
        return torch.stack(out, dim=1)


def cal_multiple(n: int, multiple: int) -> int:
    """Round n up to the next multiple."""
    return n if n % multiple == 0 else (n // multiple + 1) * multiple


def _interleave_channels(a: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-group channel-block interleave: group g of the result is [a's block g,
    b's block g]."""
    B, T, Ca = a.shape
    Cb = b.shape[-1]
    return torch.cat([a.reshape(B, T, groups, Ca // groups),
                      b.reshape(B, T, groups, Cb // groups)], dim=-1).reshape(B, T, Ca + Cb)


class OutputProcessLarge(nn.Module):
    """The `*_large` output head: the latent and a skip from the raw input, each
    widened ×out_mult by convolutions grouped per input feature, interleaved per
    group, then reduced back to the input features (k 5, SAME, then Mish, then
    k 1). `latent_proj` (k 1) lifts D to a multiple of the features first where
    D is not one."""

    def __init__(self, input_feats: int, latent_dim: int, out_mult: int = 1, *, device=None,
                 dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        F_, m = input_feats, out_mult
        self.groups = F_
        latent_in = cal_multiple(latent_dim, F_)
        self.skip_conv = Conv1d(F_, m * F_, 5, groups=F_, **dd)
        self.latent_proj = Conv1d(latent_dim, latent_in, 1, **dd) if latent_dim != latent_in \
            else None
        self.latent_conv = Conv1d(latent_in, m * latent_in, 5, groups=F_, **dd)
        self.final_conv1 = Conv1d(m * latent_in + m * F_, m * F_, 5, groups=F_, **dd)
        self.final_conv2 = Conv1d(m * F_, F_, 1, groups=F_, **dd)

    def forward(self, out: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        skip = self.skip_conv(skip)
        h = out if self.latent_proj is None else self.latent_proj(out)
        c = _interleave_channels(self.latent_conv(h), skip, self.groups)
        return self.final_conv2(mish(self.final_conv1(c)))


class MDM(nn.Module):
    """Motion Diffusion Model transformer denoiser.

    Built on `device` ("cuda" unless the caller passes "cpu"); parameters are
    allocated empty and filled from `seed` (init_params) unless `seed` is None,
    as when a checkpoint is loaded next.
    """

    def __init__(self, njoints=263, nfeats=1, latent_dim=512, ff_size=1024, num_layers=8,
                 num_heads=4, activation="gelu", clip_dim=512, arch="trans_enc",
                 emb_trans_dec=False, cond_mode="text", num_actions=1, precision_mode="float",
                 dropout=0.1, cond_mask_prob=0.1, out_mult=1, *,
                 device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        if not arch.startswith(("trans_enc", "trans_dec", "gru")):
            raise ValueError(f"unknown arch {arch}")
        device = resolve_device(device)
        dd = dict(device=device, dtype=dtype)
        self.arch = arch
        self.encoder = arch.startswith("trans_enc")
        self.emb_trans_dec = emb_trans_dec
        self.cond_mode = cond_mode
        self.num_layers = num_layers
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
            if arch.startswith("gru"):  # Flax names the cells at the model's scope
                self.add_module(f"GRUCell_{i}", GRUCell(latent_dim, **dd))
            elif self.encoder:
                layer = TransformerEncoderLayer(latent_dim, num_heads, ff_size, activation,
                                                precision_mode, dropout, **dd)
                self.add_module(f"layer{i}", layer)
            else:
                layer = TransformerDecoderLayer(latent_dim, num_heads, ff_size, activation,
                                                dropout, **dd)
                self.add_module(f"layer{i}", layer)
        if arch.endswith("_large"):
            self.output_process_large = OutputProcessLarge(self.input_feats, latent_dim, out_mult,
                                                           **dd)
        else:
            self.output_process = Dense(latent_dim, self.input_feats, **dd)
        if seed is not None:
            init_params(self, seed)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, F]
        timesteps: torch.Tensor,  # [B]
        y: Optional[dict[str, Any]] = None,
        draws=None,  # a layers.TrainDraws: the training forward
    ) -> torch.Tensor:
        y = y or {}
        p = self.cond_mask_prob
        emb = self.embed_timestep(timesteps)
        force_mask = y.get("uncond", False)
        if "text" in self.cond_mode and "text_embed" in y:
            text = mask_cond(y["text_embed"].to(x.dtype), force_mask, p, draws)
            emb = emb + self.embed_text(text)
        if "action" in self.cond_mode and "action" in y:
            emb = emb + mask_cond(self.embed_action(y["action"]), force_mask, p, draws)

        h = self.input_process(x)  # [B, T, D]
        if self.arch.startswith("gru"):
            out = dropout(self.pos_enc(h), self.dropout, draws)
            for i in range(self.num_layers):
                out = getattr(self, f"GRUCell_{i}")(out)
            return self._output(out, x)
        layers = [getattr(self, f"layer{i}") for i in range(self.num_layers)]
        if self.encoder:
            xseq = self.pos_enc(torch.cat([emb[:, None, :], h], dim=1))  # [B, T+1, D]
            xseq = dropout(xseq, self.dropout, draws)
            for layer in layers:
                xseq = layer(xseq, draws)
            out = xseq[:, 1:, :]
        else:
            memory = emb[:, None, :]
            xseq = torch.cat([memory, h], dim=1) if self.emb_trans_dec else h
            xseq = dropout(self.pos_enc(xseq), self.dropout, draws)
            for layer in layers:
                xseq = layer(xseq, memory, draws)
            out = xseq[:, 1:, :] if self.emb_trans_dec else xseq
        return self._output(out, x)

    def _output(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.arch.endswith("_large"):
            return self.output_process_large(out, x)
        return self.output_process(out)  # [B, T, F]
