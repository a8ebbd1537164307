"""Temporal 1-D UNet denoiser (CondMDI's flagship model).

Counterpart of condmdi_tpu/models/unet.py with `attention=False`
(LinearAttention waits for a later slice), in every precision mode of the
JAX package: "float", and the int8 serving modes "int8" (dynamic activation
scales), "int8_static" (calibrated per-tensor scales), "int8_static_pc"
(calibrated per-input-channel scales folded into the weights) and
"int8_prequant" (weights stored as int8 codes). Submodules keep the Flax names
(`down0_res1.block1.conv`, …) so weights.py maps a Flax tree onto this
state_dict by layout transforms alone. The layout is [B, T, C].

Float mode: every resblock half (Conv1dBlock, Conv1dAdaGNBlock) calls
ops.resblock.fused_conv_gn_mish: the Hopper kernel on CUDA, its plain
version on the CPU. The bf16 kernel reads a packed copy of the conv weight,
which each half keeps and remakes when its weight changes; MDM_UNET pads its
input's channels to a multiple of 8 (526 → 528) so that the kernel's rows
are 16-byte aligned, and the first resblock ignores the padding. Downsample
(k3 s2 p1), residual_conv (1×1) and final_conv (1×1) are plain convolutions
the JAX package left to XLA; here they stay F.conv1d / F.linear.

Int8 modes: every QConv (the resblock convs, residual_conv, the downsample
convs and final_conv) goes through ops.quant.int8_conv1d: the Hopper int8
kernel on CUDA, its plain version on the CPU, with the weight quantized once
per parameter (`QuantizedWeight`). The resblock halves run unfused, as in
the JAX package: QConv → GroupNorm → (AdaGN) → Mish (→ +res). The static
modes keep their calibrated amax as a float32 buffer per QConv; under
`ops.quant.calibration(model)` (Flax's `mutable=["act_scale"]`) the QConvs
record the running max of |x| and compute with dynamic int8. Cast an int8
model's weights with `cast_weights`, not `.to(dtype)`, which would round the
amax buffers too.

The upsample ConvTranspose (k4 s2, Flax 'SAME' ≡ torch padding 1) stays
float in every mode. `MixedStepDenoiser` is the float-tail mixed-step
sampler's denoiser: the int8 model for the early steps, its float twin,
which shares the same Parameter objects, for the last `k_float`.
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
    ConvTransposeParams,
    Dense,
    GroupNormParams,
    ParamModule,
    _const_,
    _empty,
    _lecun_,
    init_params,
)
from condmdi_tpu_torch.ops.quant import QuantizedWeight, int8_conv1d
from condmdi_tpu_torch.ops.resblock import PackedConvWeight, fused_conv_gn_mish, mish

PRECISION_MODES = ("float", "int8", "int8_static", "int8_static_pc", "int8_prequant")


def _conv1d(x: torch.Tensor, p, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """A plain conv on [B, T, C]: 1×1 as a matmul, wider kernels via F.conv1d."""
    if p.weight.shape[-1] == 1 and stride == 1 and padding == 0:
        return F.linear(x, p.weight[:, :, 0], p.bias)
    y = F.conv1d(x.transpose(1, 2), p.weight, p.bias, stride=stride, padding=padding)
    return y.transpose(1, 2).contiguous()


class QConv(ParamModule):
    """Conv1d [Cout, Cin, k] with the JAX package's precision switch.

    Float and the int8 modes hold `weight` and `bias` (Flax's kernel/bias), so
    one checkpoint serves them all; "int8_prequant" holds `weight_q` (int8)
    and `weight_scale` instead. The static modes and "int8_prequant" hold the
    calibrated `amax` buffer (float32; a scalar, or [Cin] for
    "int8_static_pc"). x may carry alignment channels past Cin; they are not
    read.
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 zero_init=False, precision_mode="float", *, device=None, dtype=None):
        super().__init__()
        if precision_mode not in PRECISION_MODES:
            raise ValueError(f"unknown precision_mode {precision_mode!r}")
        self.precision_mode = precision_mode
        self.in_channels, self.stride, self.padding = in_channels, stride, padding
        self.zero_init = zero_init
        shape = (out_channels, in_channels, kernel_size)
        if precision_mode == "int8_prequant":
            self.weight_q = nn.Parameter(torch.empty(shape, dtype=torch.int8, device=device),
                                         requires_grad=False)
            self.weight_scale = _empty((out_channels,), device, dtype)
        else:
            self.weight = _empty(shape, device, dtype)
        self.bias = _empty((out_channels,), device, dtype)
        if precision_mode in ("int8_static", "int8_static_pc", "int8_prequant"):
            amax_shape = (in_channels,) if precision_mode == "int8_static_pc" else ()
            self.register_buffer("amax", torch.zeros(amax_shape, dtype=torch.float32,
                                                     device=device))
        else:
            self.amax = None
        self.calibrating = False  # set by ops.quant.calibration
        self.quantized = QuantizedWeight()

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.precision_mode == "int8_prequant":
            _const_(self.weight_q, 0)
            _const_(self.weight_scale, 1.0)
        else:
            _, cin, k = self.weight.shape
            _lecun_(self.weight, cin * k, self.zero_init, generator)
        _const_(self.bias, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.precision_mode
        if mode == "float":
            cin = self.in_channels
            return _conv1d(x if x.shape[-1] == cin else x[..., :cin], self, self.stride,
                           self.padding)
        amax = self.amax
        if amax is not None and amax.dtype != torch.float32:
            raise TypeError("QConv.amax must stay float32: cast the model with cast_weights")
        per_channel = False
        if mode == "int8_prequant":
            weight, qmode = self.weight_q, "prequant"
        else:
            weight, qmode = self.weight, "int8"
        if amax is not None and self.calibrating:
            with torch.no_grad():  # running max of |x| in f32, then dynamic int8
                ax = x[..., : self.in_channels].abs()
                seen = ax.amax(dim=(0, 1)) if amax.ndim else ax.amax()
                amax.copy_(torch.maximum(amax, seen.float()))
            amax = None
        elif amax is not None:
            per_channel = mode == "int8_static_pc"
            qmode = {"int8_static": "static", "int8_static_pc": "static_pc"}.get(mode, qmode)
        q = self.quantized.get(weight, self.bias, amax, mode=qmode,
                               weight_scale=getattr(self, "weight_scale", None))
        return int8_conv1d(x, q.wq, q.w_scale, q.bias, self.stride, self.padding, q.a_scale,
                           per_channel=per_channel, packed=q.packed)


class _ResblockHalf(nn.Module):
    """What both resblock halves hold: the conv (a QConv) and norm parameters,
    and the bf16 fused kernel's packed copy of the conv weight (a plain
    attribute, not in the state_dict, remade when the weight changes)."""

    def __init__(self, in_channels, out_channels, kernel_size, n_groups, zero, precision_mode,
                 device, dtype):
        super().__init__()
        self.n_groups = n_groups
        self.precision_mode = precision_mode
        self.conv = QConv(in_channels, out_channels, kernel_size, padding=kernel_size // 2,
                          zero_init=zero, precision_mode=precision_mode, device=device,
                          dtype=dtype)
        self.norm = GroupNormParams(out_channels, device=device, dtype=dtype)
        self.packed = PackedConvWeight()

    def _unfused(self, x, scale=None, shift=None, res=None):
        """The int8 modes: QConv → GroupNorm → [AdaGN] → Mish [→ +res], unfused as
        in the JAX package, in x's dtype. The conv's output is copied once into
        [B, C, T] for torch's group_norm, AdaGN is one addcmul, Mish one call,
        and the residual add writes the [B, T, C] output: eight launches or
        fewer a half, since the served step is bound by the host's launches."""
        h = self.conv(x)
        y = F.group_norm(h.transpose(1, 2).contiguous(), self.n_groups, self.norm.weight,
                         self.norm.bias, eps=1e-5)
        if scale is not None:
            y = torch.addcmul(shift[:, :, None].to(y.dtype), y, 1.0 + scale[:, :, None].to(y.dtype))
        y = F.mish(y).transpose(1, 2)
        if res is None:
            return y.contiguous()
        return torch.add(res, y, out=torch.empty_like(res))


class Conv1dBlock(_ResblockHalf):
    """Conv(k) → GroupNorm(8) → Mish (→ +res); one fused kernel call in float mode."""

    def __init__(self, in_channels, out_channels, kernel_size=5, n_groups=8, zero=False,
                 precision_mode="float", *, device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, n_groups, zero, precision_mode,
                         device, dtype)

    def forward(self, x, res=None):
        if self.precision_mode != "float":
            return self._unfused(x, res=res)
        return fused_conv_gn_mish(
            x, self.conv.weight, self.conv.bias, self.norm.weight, self.norm.bias,
            res=res, n_groups=self.n_groups, packed=self.packed,
        )


class Conv1dAdaGNBlock(_ResblockHalf):
    """Conv → GroupNorm → (1+scale)·x + shift → Mish; one fused kernel call in float mode."""

    def __init__(self, in_channels, out_channels, kernel_size=5, n_groups=8,
                 precision_mode="float", *, device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, n_groups, False, precision_mode,
                         device, dtype)

    def forward(self, x, scale, shift):
        if self.precision_mode != "float":
            return self._unfused(x, scale, shift)
        return fused_conv_gn_mish(
            x, self.conv.weight, self.conv.bias, self.norm.weight, self.norm.bias,
            scale=scale.to(x.dtype), shift=shift.to(x.dtype), n_groups=self.n_groups,
            packed=self.packed,
        )


class ResidualTemporalBlock(nn.Module):
    def __init__(self, in_channels, out_channels, embed_dim, kernel_size=5, adagn=True,
                 zero=True, precision_mode="float", *, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.adagn = adagn
        cond_dim = out_channels * 2 if adagn else out_channels
        self.time_mlp = Dense(embed_dim, cond_dim, zero_init=adagn, **dd)
        if in_channels != out_channels:
            self.residual_conv = QConv(in_channels, out_channels, 1,
                                       precision_mode=precision_mode, **dd)
        else:
            self.residual_conv = None
        pm = dict(precision_mode=precision_mode, **dd)
        if adagn:
            self.block1 = Conv1dAdaGNBlock(in_channels, out_channels, kernel_size, **pm)
        else:
            self.block1 = Conv1dBlock(in_channels, out_channels, kernel_size, **pm)
        self.block2 = Conv1dBlock(out_channels, out_channels, kernel_size, zero=zero, **pm)

    def forward(self, x, t_act):
        """x: [B, T, C_in (+ alignment channels, which block1 ignores)]; t_act: [B, E],
        the time embedding after its Mish (the same for every block, so the caller
        takes it once)."""
        cond = self.time_mlp(t_act)
        if self.residual_conv is None:
            res = x
        else:
            res = self.residual_conv(x)
        if self.adagn:
            scale, shift = cond.chunk(2, dim=-1)
            h = self.block1(x, scale, shift)
        else:
            h = self.block1(x) + cond[:, None, :].to(x.dtype)
        return self.block2(h, res=res)


class TemporalUnet(nn.Module):
    def __init__(self, input_dim, cond_dim, dim=512, dim_mults: Sequence[float] = (2, 2, 2, 2),
                 adagn=True, zero=True, added_input_channels=0, precision_mode="float", *,
                 device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        pm = dict(precision_mode=precision_mode, **dd)
        # the keyframe-conditioned input carries the mask beside the motion
        in_ch = input_dim + added_input_channels
        dims = [input_dim] + [int(dim * m) for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.n_res = len(in_out)
        rb = dict(embed_dim=dim, adagn=adagn, zero=zero, **pm)

        self.time_fc1 = Dense(cond_dim, dim * 4, **dd)
        self.time_fc2 = Dense(dim * 4, dim, **dd)
        for ind, (dim_in, dim_out) in enumerate(in_out):
            first_in = in_ch if ind == 0 else dim_in
            self.add_module(f"down{ind}_res1", ResidualTemporalBlock(first_in, dim_out, **rb))
            self.add_module(f"down{ind}_res2", ResidualTemporalBlock(dim_out, dim_out, **rb))
            if ind < self.n_res - 1:
                self.add_module(f"down{ind}_downsample",
                                QConv(dim_out, dim_out, 3, stride=2, padding=1, **pm))
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
        self.final_block = Conv1dBlock(dims[1], dims[1], kernel_size=5, **pm)
        self.final_conv = QConv(dims[1], input_dim, 1, zero_init=zero, **pm)

    def forward(self, x, cond):
        """x: [B, T, C] (T divisible by 2^(len(dim_mults)-1)); cond: [B, cond_dim]."""
        c = mish(self.time_fc2(mish(self.time_fc1(cond))))  # every block's time_mlp(mish(·)) input
        h = []
        for ind in range(self.n_res):
            x = getattr(self, f"down{ind}_res1")(x, c)
            x = getattr(self, f"down{ind}_res2")(x, c)
            h.append(x)
            if ind < self.n_res - 1:
                x = getattr(self, f"down{ind}_downsample")(x)
        x = self.mid_block1(x, c)
        x = self.mid_block2(x, c)
        for ind in range(self.n_up):
            x = torch.cat([x, h.pop()], dim=-1)
            x = getattr(self, f"up{ind}_res1")(x, c)
            x = getattr(self, f"up{ind}_res2")(x, c)
            up = getattr(self, f"up{ind}_upsample")
            x = F.conv_transpose1d(x.transpose(1, 2), up.weight, up.bias, stride=2, padding=1)
            x = x.transpose(1, 2).contiguous()
        return self.final_conv(self.final_block(x))


class MDM_UNET(nn.Module):
    """UNet denoiser wrapper with keyframe + text/timestep conditioning.

    Built on `device` ("cuda" unless the caller passes "cpu"); parameters are
    allocated empty and filled from `seed` (init_params) unless `seed` is None,
    as when a checkpoint is loaded next.
    """

    def __init__(self, njoints=263, nfeats=1, latent_dim=512,
                 dim_mults: Sequence[float] = (2, 2, 2, 2), adagn=True, zero=True,
                 clip_dim=512, cond_mode="text", keyframe_conditioned=False,
                 pad_frames_to=224, precision_mode="float", *,
                 device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        if cond_mode != "text":
            raise NotImplementedError("only text conditioning is ported")
        if precision_mode not in PRECISION_MODES:
            raise ValueError(f"unknown precision_mode {precision_mode!r}")
        # what float_twin needs to build the same network in another mode
        self.config = dict(njoints=njoints, nfeats=nfeats, latent_dim=latent_dim,
                           dim_mults=tuple(dim_mults), adagn=adagn, zero=zero,
                           clip_dim=clip_dim, cond_mode=cond_mode,
                           keyframe_conditioned=keyframe_conditioned,
                           pad_frames_to=pad_frames_to, precision_mode=precision_mode)
        self.precision_mode = precision_mode
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
            added_input_channels=self.input_feats if keyframe_conditioned else 0,
            precision_mode=precision_mode, **dd,
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


def cast_weights(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating-point parameters (and the non-persistent tables) to
    `dtype`, leaving the calibrated amax buffers in float32, as the JAX bench
    casts its params and not its act_scale collection. The parameters become
    new objects: make a float twin after the cast, not before."""
    with torch.no_grad():
        for module in model.modules():
            for name, p in module._parameters.items():
                if p is not None and p.is_floating_point():
                    module._parameters[name] = nn.Parameter(p.to(dtype),
                                                            requires_grad=p.requires_grad)
            for name, b in module._buffers.items():
                if b is not None and b.is_floating_point() and name != "amax":
                    module._buffers[name] = b.to(dtype)
    return model


def float_twin(model: MDM_UNET) -> MDM_UNET:
    """The float-mode network over `model`'s own Parameter objects (and its
    tables): no copy of the weights. An in-place change of a shared
    parameter is seen by both, and the twin's packed resblock weights are
    remade from it."""
    twin = MDM_UNET(**{**model.config, "precision_mode": "float"}, device="meta", seed=None)
    params, buffers = dict(model.named_parameters()), dict(model.named_buffers())
    for name, _ in list(twin.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        twin.get_submodule(mod)._parameters[leaf] = params[name]
    for name, _ in list(twin.named_buffers()):
        mod, _, leaf = name.rpartition(".")
        twin.get_submodule(mod)._buffers[leaf] = buffers[name]
    return twin.train(model.training)


class MixedStepDenoiser:
    """The float-tail mixed-step denoiser, an `apply_fn` for SamplePipeline
    and MotionServer: `model` (an int8 mode) for model timesteps >= k_float,
    its float twin (`float_twin`, the same Parameter objects) below. t is the
    MODEL timestep (the 1000-step scale even under respacing), so k_float
    always means the last k_float steps of the full reverse process.

    The branch is chosen on the host from t[0]; on CUDA that reads one value
    back from the card per call.
    """

    def __init__(self, model: MDM_UNET, k_float: int):
        if k_float > 0 and model.precision_mode not in ("int8", "int8_static", "int8_static_pc"):
            raise ValueError(
                "a float tail (k_float > 0) needs precision_mode int8, int8_static or "
                f"int8_static_pc, not {model.precision_mode!r}: int8_prequant stores quantized "
                "weights the float twin cannot apply; float has no int8 leg to mix"
            )
        self.model = model
        self.k_float = int(k_float)
        self.twin = float_twin(model) if self.k_float > 0 else None

    def __call__(self, x, t, y=None, obs_x0=None, obs_mask=None):
        use_float = self.twin is not None and int(t[0]) < self.k_float
        return (self.twin if use_float else self.model)(x, t, y, obs_x0=obs_x0,
                                                        obs_mask=obs_mask)
