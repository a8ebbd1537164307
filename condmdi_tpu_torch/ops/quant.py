"""Int8 quantized conv1d and matmul: the serving path's int8 op.

Counterpart of condmdi_tpu/ops/quant.py. The JAX package lowered these ops
through XLA (`lax.conv_general_dilated` / `dot_general` with int32
accumulation); PyTorch on CUDA has no int8 conv1d, so the port carries a
hand-written kernel, csrc/quant.cu. `int8_conv1d` is the one entry that
reaches it:

  * a CUDA tensor goes to the kernel (built and bound by ops/_build.py), or
    the call raises; it never falls back to the plain version;
  * a CPU tensor goes to `plain_int8_conv1d`, the plain PyTorch version of
    the same arithmetic.

`int8_conv1d.launches` counts kernel launches and nothing else.
`int8_matmul` is the same op at k=1 over the rows of x. `conv1d_f32` is the
float32 conv beside them, which JAX also left to XLA.

Under autograd (grad enabled and x, a scale or the bias requiring grad) the
call goes through `Int8Conv1d`: the same forward, and a backward that
recomputes the plain version. That gives what JAX's autodiff gives through
its XLA op: nothing through the rounded codes, so a static or folded scale
passes no gradient to x and a dynamic one passes its amax term; the bias its
sum; and the float weight, where it is quantized in-graph, the gradient of
its per-channel scale (`QConv`/`QDense` hand the live scale over on that path,
`live_scales`). Under `torch.no_grad()` there is no Function.

The arithmetic is the JAX package's, operation by operation:

  * weights per output channel, symmetric: scale = max(amax, 1e-8) / 127.0
    (a division), codes clip(round(w / scale), -127, 127), round half to even;
  * activations per tensor, from the amax of the whole tensor (dynamic) or a
    calibrated amax (static); or per input channel, folded into the weights
    before they are quantized (`quant_conv1d_from_f32` with a rank-1 a_scale);
  * exact integer accumulation;
  * dequant acc.float() * (a_scale * w_scale), the scale product first (the
    folded form: acc.float() * w_scale), then + bias, then the cast back to
    the input's dtype.

Layouts follow the rest of the port: x [B, T, Cin] (it may carry trailing
alignment channels past the weight's Cin, which are not read), conv weights
in torch's [Cout, Cin, k], dense weights in torch's [Dout, Din].

`QuantizedWeight` is the per-parameter cache the modules keep: codes, scales,
the f32 bias and the kernel's packed codes, made once and remade when the
weight, the bias or a folded activation scale changes.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from condmdi_tpu_torch.ops.resblock import recompute_grads
from condmdi_tpu_torch.ops.weight_cache import copy_into, repacking, weight_key

_CHUNK = 128  # input channels per K step of the kernel: Cin is padded to a multiple of it
_TILE = 128  # output rows and output channels per CTA (csrc/quant.cu kBM, kBN)
_MAX_SPLIT = 8  # parts of a split tile: the CTAs of one cluster (csrc/quant.cu kMaxSplit)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TAPS = (1, 3, 5)  # the kernel widths the kernel is built for


# --------------------------------------------------------------------------- #
# quantization
# --------------------------------------------------------------------------- #
def weight_scale(w: torch.Tensor) -> torch.Tensor:
    """[Cout, ...] float → the per-output-channel scale [Cout], in w's dtype."""
    return torch.clamp(w.abs().amax(dim=tuple(range(1, w.ndim))), min=1e-8) / 127.0


def quantize_weight_per_channel(w: torch.Tensor):
    """[Cout, ...] float → (int8 codes of w's shape, scale [Cout] in w's dtype).

    Computed in w's dtype, as the JAX package computes it in its kernel's."""
    scale = weight_scale(w)
    view = (-1,) + (1,) * (w.ndim - 1)
    wq = torch.clamp(torch.round(w / scale.view(view)), -127, 127).to(torch.int8)
    return wq, scale


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """The activation scale of a recorded (or just taken) amax, in float32."""
    return torch.clamp(amax.float(), min=1e-8) / 127.0


def quantize_activation(x: torch.Tensor):
    """Dynamic per-tensor symmetric int8: (codes, scale) of float32 x."""
    scale = activation_scale(x.abs().amax())
    return _quantize(x, scale), scale


def _quantize(x: torch.Tensor, a_scale) -> torch.Tensor:
    return torch.clamp(torch.round(x / a_scale), -127, 127).to(torch.int8)


# --------------------------------------------------------------------------- #
# the plain version
# --------------------------------------------------------------------------- #
def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 products summed over K, as float64 [M, N].

    The CPU takes torch._int_mm (int32); elsewhere float64 products, exact
    while |sums| < 2^53 (they stay below 127^2 * k * Cin ~ 1.7e8)."""
    if a.device.type == "cpu":
        return torch._int_mm(a.contiguous(), b.contiguous()).double()
    return a.double() @ b.double()


def plain_int8_conv1d(x, wq, w_scale, bias=None, stride=1, padding=0, a_scale=None,
                      per_channel=False):
    """The plain PyTorch version of the kernel; returns x's dtype.

    a_scale None quantizes x dynamically (amax of all of x[..., :Cin]);
    otherwise it is the activation scale, a scalar or, with `per_channel`,
    [Cin], in which case the caller has folded it into wq and the dequant
    takes w_scale alone."""
    B, T, _ = x.shape
    cout, cin, k = wq.shape
    xf = x[..., :cin].float()
    if a_scale is None:
        xq, a_scale = quantize_activation(xf)
    else:
        xq = _quantize(xf, a_scale)
    cols = F.pad(xq, (0, 0, padding, padding)).unfold(1, k, stride)  # [B, T', Cin, k]
    t_out = cols.shape[1]
    acc = _int_matmul(cols.reshape(B * t_out, cin * k), wq.reshape(cout, cin * k).t())
    scale = w_scale.float() if per_channel else a_scale * w_scale.float()
    out = acc.float() * scale
    if bias is not None:
        out = out + bias
    return out.reshape(B, t_out, cout).to(x.dtype)


# --------------------------------------------------------------------------- #
# the entry that reaches the kernel
# --------------------------------------------------------------------------- #
def int8_conv1d(
    x: torch.Tensor,                       # [B, T, Cin (+ alignment channels)] float
    wq: torch.Tensor,                      # [Cout, Cin, k] int8
    w_scale: torch.Tensor,                 # [Cout]
    bias: Optional[torch.Tensor] = None,   # [Cout]
    stride: int = 1,
    padding: int = 0,
    a_scale: Optional[torch.Tensor] = None,  # None (dynamic), scalar, or [Cin] (per_channel)
    *,
    per_channel: bool = False,
    packed: Optional[torch.Tensor] = None,  # the caller's `pack_int8_weight(wq)`
) -> torch.Tensor:
    """Quantized conv: int8 x int8 → int32, dequant epilogue; x's dtype out."""
    if per_channel and (a_scale is None or a_scale.ndim != 1):
        raise ValueError("per_channel needs a [Cin] a_scale")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv1d: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w_scale, bias, a_scale)):
        return Int8Conv1d.apply(x, wq, w_scale, bias, a_scale, stride, padding, per_channel,
                                packed)
    return _forward(x, wq, w_scale, bias, a_scale, stride, padding, per_channel, packed)


int8_conv1d.launches = 0


def _forward(x, wq, w_scale, bias, a_scale, stride, padding, per_channel, packed):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return plain_int8_conv1d(x, wq, w_scale, bias, stride, padding, a_scale, per_channel)
    return _launch(x, wq, w_scale, bias, stride, padding, a_scale, per_channel, packed)


class Int8Conv1d(torch.autograd.Function):
    """The int8 conv under autograd: `_forward` (the kernel on the card), and a
    backward that recomputes `plain_int8_conv1d` and returns the gradients of
    x, w_scale, bias and a_scale (none for the int8 codes).

    Call as `Int8Conv1d.apply(x, wq, w_scale, bias, a_scale, stride, padding,
    per_channel, packed)`; `int8_conv1d` does so only under autograd.
    """

    @staticmethod
    def forward(ctx, x, wq, w_scale, bias, a_scale, stride, padding, per_channel, packed):
        ctx.save_for_backward(x, wq, w_scale, bias, a_scale)
        ctx.conv = (stride, padding, per_channel)
        return _forward(x, wq, w_scale, bias, a_scale, stride, padding, per_channel, packed)

    @staticmethod
    def backward(ctx, grad_out):
        stride, padding, per_channel = ctx.conv

        def plain(x, wq, w_scale, bias, a_scale):
            return plain_int8_conv1d(x, wq, w_scale, bias, stride, padding, a_scale, per_channel)

        needs = (ctx.needs_input_grad[0], False, *ctx.needs_input_grad[2:5])
        grads = recompute_grads(plain, ctx.saved_tensors, needs, grad_out)
        return (*grads, None, None, None, None)


def conv1d_f32(x, w, bias=None, stride=1, padding=0):
    """The float conv in JAX's layouts, x [B, T, Cin] (NWC) and w [k, Cin, Cout]
    (WIO), in full float32 (TF32 off for the call): `F.conv1d`, as JAX lowers
    its own through XLA."""
    from condmdi_tpu_torch.device import float32_exact

    with float32_exact():
        out = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride,
                       padding=padding).transpose(1, 2)
    return out + bias if bias is not None else out


def quant_conv1d_from_f32(x, kernel, bias=None, stride=1, padding=0, a_scale=None):
    """int8 conv from the stored float weight [Cout, Cin, k], quantized per call.

    A rank-1 a_scale [Cin] selects per-input-channel static activations,
    folded into the weight before it is quantized (w·s_c), with x quantized
    as x / s_c and the dequant by the weight scale alone."""
    if a_scale is not None and a_scale.ndim == 1:
        wq, w_scale = quantize_weight_per_channel(kernel.float() * a_scale[None, :, None])
        return int8_conv1d(x, wq, w_scale, bias, stride, padding, a_scale, per_channel=True)
    wq, w_scale = quantize_weight_per_channel(kernel.float())
    return int8_conv1d(x, wq, w_scale, bias, stride, padding, a_scale)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor, bias=None, *, packed=None,
                quantized=None) -> torch.Tensor:
    """Quantized dense: x [..., Din] × weight [Dout, Din] → x's dtype.

    Per-output-feature weight scale (computed in the weight's dtype, as the
    JAX package does), dynamic per-tensor activation scale; the k=1 case of
    `int8_conv1d` over the rows of x. `quantized` is a (wq, w_scale) pair made
    beforehand (`QuantizedWeight`)."""
    wq, w_scale = quantized if quantized is not None else quantize_weight_per_channel(weight)
    din = wq.shape[1]
    rows = x.reshape(1, -1, din)
    out = int8_conv1d(rows, wq.view(wq.shape[0], din, 1), w_scale, bias, packed=packed)
    return out.reshape(*x.shape[:-1], wq.shape[0])


# --------------------------------------------------------------------------- #
# the kernel's weight layout and the per-parameter cache
# --------------------------------------------------------------------------- #
def pack_int8_weight(wq: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, k] int8 → [Cout, k·Cin_pad]: row n holds tap 0's Cin_pad
    channels, then tap 1's, …, with Cin zero-padded to a multiple of 128, so
    that one K step of the kernel (a tap and 128 channels) of 128 output
    channels is one TMA box of the matrix."""
    cout, cin, k = wq.shape
    cin_pad = -(-cin // _CHUNK) * _CHUNK
    return F.pad(wq.permute(0, 2, 1), (0, cin_pad - cin)).reshape(cout, k * cin_pad).contiguous()


def int8_plan(B: int, T: int, cin: int, cout: int, k: int, stride: int, padding: int,
              sm_count: int) -> dict:
    """How the kernel cuts a conv on a card with `sm_count` SMs (csrc/quant.cu
    `make_plan`, exported as `condmdi_int8_conv1d_plan`; a card test holds the
    two together): code rows per batch item with the zero halo (`t_pad`), tiles
    of 128 rows of the batch-folded M and 128 output channels, K steps (a tap
    and 128 input channels each), and the split of the K steps over the CTAs
    of a cluster where the tiles are fewer than half the SMs: as many parts as
    fill one wave, at most 8, and half a wave for clusters of 4 or more."""
    t_pad = -(-(T + 2 * padding) // stride) * stride
    m_tiles = -(-(B * t_pad // stride) // _TILE)
    n_tiles = -(-cout // _TILE)
    steps = k * -(-cin // _CHUNK)
    tiles = m_tiles * n_tiles
    split = 1
    if 2 * tiles <= sm_count:
        split = min(sm_count // tiles, steps, _MAX_SPLIT)
        while split >= 4 and 2 * split * tiles > sm_count:  # clusters of 4+: half a wave
            split -= 1
    return dict(t_pad=t_pad, m_tiles=m_tiles, n_tiles=n_tiles, split=split, steps=steps)


class Quantized(NamedTuple):
    wq: torch.Tensor                  # [Cout, Cin, k] int8
    w_scale: torch.Tensor             # [Cout] float32
    bias: Optional[torch.Tensor]      # [Cout] float32
    a_scale: Optional[torch.Tensor]   # None (dynamic), [] or [Cin] float32
    packed: Optional[torch.Tensor]    # the kernel's layout of wq (CUDA only)


class QuantizedWeight:
    """The quantized copy of one QConv/QDense weight, remade when it is stale.

    Held by the module as a plain attribute (not in the state_dict). The key
    holds the version counter, data pointer, dtype, device and shape of the
    weight, the bias and, where the weight's codes or the static activation
    scale depend on it, the recorded amax, and the optimizer steps taken
    (ops/weight_cache.py); so `load_state_dict`, an in-place update, `.to()`,
    a recalibration and an optimizer step all invalidate it. (A write through
    `.data` bypasses the version counter and is not seen.) Under
    `weight_cache.repack_on_every_call()` it quantizes on every call into the
    tensors it holds, and from then on it re-quantizes into those tensors, which
    a train step's graph keeps writing and reading.
    """

    def __init__(self):
        self._key = None
        self._value: Optional[Quantized] = None
        self._pinned = False  # a captured graph writes and reads these very tensors

    def get(self, weight, bias, amax=None, *, mode="int8", weight_scale=None) -> Quantized:
        """mode: 'int8' (codes from the float weight, computed in f32 for a
        conv and in the weight's dtype for a dense), 'static' (plus the
        activation scale of `amax`), 'static_pc' (amax [Cin] folded into the
        weight), 'prequant' (`weight` is already int8 and `weight_scale` its
        scale)."""
        key = (mode, weight_key(weight), weight_key(bias), weight_key(amax),
               weight_key(weight_scale))
        if key == self._key and not repacking():
            return self._value
        self._pinned = self._pinned or repacking()
        with torch.no_grad():
            weight = weight.detach()
            a_scale = None if amax is None else activation_scale(amax.detach())
            if mode == "prequant":
                wq, w_scale = weight, weight_scale.detach()
            elif mode == "static_pc":
                wq, w_scale = quantize_weight_per_channel(weight.float() * a_scale[None, :, None])
            elif mode in ("int8", "static"):
                wq, w_scale = quantize_weight_per_channel(
                    weight.float() if weight.ndim == 3 else weight)
            else:
                raise ValueError(f"unknown quantization mode {mode!r}")
            if wq.ndim == 2:
                wq = wq[:, :, None]
            packed = pack_int8_weight(wq) if weight.device.type == "cuda" else None
            value = Quantized(wq, w_scale.float(), None if bias is None else bias.detach().float(),
                              a_scale, packed)
            if self._pinned and self._value is not None:  # a train step's graph reads these
                value = Quantized(*(copy_into(held, fresh)
                                    for held, fresh in zip(self._value, value)))
            self._value = value
        self._key = key
        return self._value


def live_scales(q: Quantized, weight, bias, mode="int8", weight_scale_param=None):
    """(w_scale, bias) of `q` made again from the parameters, for a call under
    autograd: the cached values bit for bit, with the gradients that the JAX
    package's in-graph quantization gives the float weight (through its
    per-channel scale; the rounded codes pass none), the stored scale of
    "prequant" and the bias. `mode` as for `QuantizedWeight.get`."""
    if mode == "prequant":
        w_scale = weight_scale_param
    elif mode == "static_pc":
        w_scale = weight_scale(weight.float() * q.a_scale[None, :, None])
    else:
        w_scale = weight_scale(weight.float() if weight.ndim == 3 else weight)
    return w_scale.float(), None if bias is None else bias.float()


# --------------------------------------------------------------------------- #
# the launch
# --------------------------------------------------------------------------- #
def _launch(x, wq, w_scale, bias, stride, padding, a_scale, per_channel, packed):
    """Check what the kernel takes, launch it on the current stream, count it.

    One C call launches the quantize pass and the conv (csrc/quant.cu); the
    count is one per call. Runs 41 times per int8 UNet forward: no device
    access on the host, no copies of tensors already laid out as the kernel
    reads them."""
    dtype, device = x.dtype, x.device
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"int8_conv1d: unsupported dtype {dtype}")
    for t in (x, wq, w_scale, bias, a_scale):
        if t is not None and t.device != device:
            raise TypeError("int8_conv1d: all inputs must lie on x's device")
    if wq.dtype != torch.int8 or wq.ndim != 3:
        raise TypeError("int8_conv1d: wq must be [Cout, Cin, k] int8")
    B, T, xc = x.shape
    cout, cin, k = wq.shape
    if xc < cin:
        raise ValueError(f"int8_conv1d: x has {xc} channels, the weight takes {cin}")
    if k not in _TAPS:
        raise NotImplementedError(f"the kernel is built for k in {_TAPS}, not {k}")
    if stride not in (1, 2) or not 0 <= padding < k:
        raise NotImplementedError(f"stride {stride}, padding {padding} are not built")
    t_out = (T + 2 * padding - k) // stride + 1
    if t_out <= 0:
        raise ValueError(f"int8_conv1d: no output for B={B}, T={T}, k={k}, stride={stride}")
    if x.stride(2) != 1:
        x = x.contiguous()
    if w_scale.shape != (cout,) or (bias is not None and bias.shape != (cout,)):
        raise ValueError(f"w_scale and bias must have shape ({cout},)")
    w_scale = w_scale if w_scale.dtype == torch.float32 and w_scale.is_contiguous() \
        else w_scale.float().contiguous()
    if bias is not None and not (bias.dtype == torch.float32 and bias.is_contiguous()):
        bias = bias.float().contiguous()
    if a_scale is None:
        a_scale = activation_scale((x if xc == cin else x[..., :cin]).abs().amax())
    elif a_scale.numel() != (cin if per_channel else 1):
        raise ValueError(f"a_scale has {a_scale.numel()} elements for Cin={cin}")
    if a_scale.dtype != torch.float32 or not a_scale.is_contiguous():
        a_scale = a_scale.float().contiguous()
    if packed is None:
        packed = pack_int8_weight(wq)
    cin_pad = -(-cin // _CHUNK) * _CHUNK
    if packed.shape != (cout, k * cin_pad) or packed.dtype != torch.int8:
        raise ValueError(f"packed weight {tuple(packed.shape)} does not match wq {tuple(wq.shape)}")
    out = torch.empty((B, t_out, cout), device=device, dtype=dtype)
    # the kernel's scratch: the codes with a zero halo of `padding` rows around each
    # batch item, T + 2 padding rows made even for stride 2 (written whole by the kernel)
    t_pad = -(-(T + 2 * padding) // stride) * stride
    codes = torch.empty((B, t_pad, cin_pad), device=device, dtype=torch.int8)

    from condmdi_tpu_torch.ops import _build

    lib = _build.load_quant()
    err = lib.condmdi_int8_conv1d(
        x.data_ptr(), code, x.stride(0), x.stride(1), a_scale.data_ptr(), int(per_channel),
        packed.data_ptr(), w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
        codes.data_ptr(), out.data_ptr(), B, T, cin, cin_pad, cout, k, stride, padding, t_out,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: {_build.error_string(lib, err)}")
    int8_conv1d.launches += 1
    return out


# --------------------------------------------------------------------------- #
# calibration of the static activation scales
# --------------------------------------------------------------------------- #
def _amax_buffers(model: torch.nn.Module) -> list[torch.Tensor]:
    return [b for name, b in model.named_buffers() if name.rsplit(".", 1)[-1] == "amax"]


def calibrate_act_scales_trajectory(
    model,
    sched,
    dcfg,
    shape: tuple,
    y: dict,
    *,
    guidance_param: float = 1.0,
    obs_x0: Optional[torch.Tensor] = None,
    obs_mask: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    step_noise=None,
    generator: Optional[torch.Generator] = None,
    headroom: float = 1.25,
    apply_fn=None,
):
    """Record the static activation scales along one sampling trajectory.

    One full DDPM run at the serving guidance (CFG batch doubling with
    `uncond`, as the served program runs it) in the model's calibration
    state: every QConv records the running max of |x| in float32 and
    computes with dynamic int8. The amaxes start from zero and are
    multiplied by `headroom` at the end. x_T (`noise`) and the per-step
    noise (`step_noise`) are injected, or drawn from `generator`. `apply_fn`
    (x, t, y, **obs) runs the model (by default the model itself), e.g. a
    bfloat16 model behind a float32 sampler. Warns when the calibration
    trajectory itself is not finite. Returns the model.
    """
    from condmdi_tpu_torch.diffusion.sampling import ddpm_sample_loop
    from condmdi_tpu_torch.models.cfg import make_cfg_denoiser, make_plain_denoiser

    apply_fn = model if apply_fn is None else apply_fn
    if guidance_param != 1.0:
        denoise = make_cfg_denoiser(apply_fn, y, guidance_param, obs_x0=obs_x0,
                                    obs_mask=obs_mask)
    else:
        denoise = make_plain_denoiser(apply_fn, y, obs_x0=obs_x0, obs_mask=obs_mask)
    buffers = _amax_buffers(model)
    with torch.no_grad():
        for b in buffers:
            b.zero_()
        with calibration(model):
            x_fin = ddpm_sample_loop(denoise, sched, dcfg, shape, generator=generator,
                                     noise=noise, step_noise=step_noise)
        if not bool(torch.isfinite(x_fin).all()):
            warnings.warn(
                "calibration trajectory (dynamic int8) is itself non-finite at guidance "
                f"{guidance_param}: int8 serving at this guidance is numerically unstable; "
                "use bf16 or a lower guidance",
                stacklevel=2,
            )
        for b in buffers:
            b.mul_(headroom)
    return model


def calibrate_act_scales(model, sched, x0, y, t_fracs=(0.999, 0.75, 0.5, 0.25, 0.0), *,
                         noise=None, generator=None, **apply_kw):
    """Record the static activation scales on q_sample(x0, t) at a spread of
    timestep fractions (the forward-process marginals). `noise` is one tensor
    per fraction, or drawn from `generator`. The amaxes start from zero.
    Returns the model."""
    from condmdi_tpu_torch.diffusion.gaussian import q_sample

    n = sched.num_timesteps
    with torch.no_grad():
        for b in _amax_buffers(model):
            b.zero_()
        with calibration(model):
            for i, frac in enumerate(t_fracs):
                it = torch.full((x0.shape[0],), int(frac * (n - 1)), dtype=torch.long,
                                device=x0.device)
                z = noise[i] if noise is not None else torch.randn(
                    x0.shape, generator=generator, device=x0.device)
                model(q_sample(sched, x0, it, z.to(x0.device)), sched.model_t(it), y, **apply_kw)
    return model


class calibration:
    """Context manager: the model's QConvs record activation ranges and
    compute with dynamic int8 (Flax's `mutable=["act_scale"]`)."""

    def __init__(self, model: torch.nn.Module):
        self.modules = [m for m in model.modules() if hasattr(m, "calibrating")]

    def __enter__(self):
        for m in self.modules:
            m.calibrating = True
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.calibrating = False
        return False


def quantize_params_tree(state_dict: dict) -> dict:
    """The port's counterpart of the JAX `quantize_params_tree`, on a state_dict
    of an MDM_UNET: every QConv weight [Cout, Cin, k] becomes `weight_q` (int8)
    and `weight_scale` [Cout], the layout `precision_mode="int8_prequant"`
    reads. The upsample ConvTranspose weights are rank 3 too but are not
    QConvs and are left as they are; everything else is kept."""
    out = {}
    for key, value in state_dict.items():
        mod, _, leaf = key.rpartition(".")
        if leaf == "weight" and value.ndim == 3 and "upsample" not in mod:
            wq, scale = quantize_weight_per_channel(value.float())
            out[f"{mod}.weight_q"] = wq
            out[f"{mod}.weight_scale"] = scale
        else:
            out[key] = value
    return out
