"""Gaussian diffusion core: q/posterior math and p_mean_variance.

Counterpart of condmdi_tpu/diffusion/gaussian.py (training losses wait for
the training slice). The denoiser enters as `denoise_fn(x, t_model)`,
already closed over weights and conditioning, so this module is
model-agnostic. Layout is [B, T, F]; observation masks are [B, T, F].

Reconstruction guidance takes the gradient of the keyframe loss through the
denoiser with `torch.autograd.grad`. On CUDA the kernels' autograd Functions
carry it (ops/resblock.py `ConvGnMish`, ops/quant.py `Int8Conv1d`,
ops/attention.py `fused_self_attention`): kernel forwards, backwards that
recompute the plain versions.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from condmdi_tpu_torch.diffusion.schedule import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class ModelMeanType(enum.Enum):
    PREVIOUS_X = "prev_x"
    START_X = "start_x"
    EPSILON = "eps"


class ModelVarType(enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


@dataclass(frozen=True)
class DiffusionConfig:
    """The sampling-side fields of the JAX package's DiffusionConfig."""

    model_mean_type: ModelMeanType = ModelMeanType.START_X
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL
    clip_range: Optional[float] = None


# --------------------------------------------------------------------------- #
# Closed-form q distributions
# --------------------------------------------------------------------------- #
def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    nd = x_start.ndim
    return (
        sched.extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
        + sched.extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start, x_t, t):
    nd = x_t.ndim
    posterior_mean = (
        sched.extract(sched.posterior_mean_coef1, t, nd) * x_start
        + sched.extract(sched.posterior_mean_coef2, t, nd) * x_t
    )
    posterior_variance = sched.extract(sched.posterior_variance, t, nd)
    posterior_log_variance = sched.extract(sched.posterior_log_variance_clipped, t, nd)
    return posterior_mean, posterior_variance, posterior_log_variance


def predict_xstart_from_eps(sched, x_t, t, eps):
    nd = x_t.ndim
    return (
        sched.extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - sched.extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps
    )


def predict_xstart_from_xprev(sched, x_t, t, xprev):
    nd = x_t.ndim
    return (
        sched.extract(1.0 / sched.posterior_mean_coef1, t, nd) * xprev
        - sched.extract(sched.posterior_mean_coef2 / sched.posterior_mean_coef1, t, nd)
        * x_t
    )


def predict_eps_from_xstart(sched, x_t, t, pred_xstart):
    nd = x_t.ndim
    return (
        sched.extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
    ) / sched.extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)


# --------------------------------------------------------------------------- #
# Inpainting / guidance state threaded through the sampler
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class InpaintingState:
    """Inpainting tensors and step gates.

    `inpainting_mask` is a full [B, T, F] bool mask (already combined with
    the validity mask); `inpainted_motion` is [B, T, F]; the gates are step
    thresholds compared against t.
    """

    inpainted_motion: torch.Tensor
    inpainting_mask: torch.Tensor  # bool [B, T, F]
    grad_weights: torch.Tensor  # [num_timesteps] gradient schedule × recon weight
    stop_imputation_at: int = 0
    stop_recguidance_at: int = 0
    imputate: bool = False
    reconstruction_guidance: bool = False
    replacement_distribution: str = "conditional"


def get_gradient_schedule(
    schedule_name: Optional[str], num_diffusion_steps: int, scale: float = 0.05
) -> np.ndarray:
    """Reconstruction-guidance weight per timestep."""
    if schedule_name is None or schedule_name == "none":
        return np.ones(num_diffusion_steps)
    if schedule_name == "first-half":
        half = num_diffusion_steps // 2
        return np.concatenate((np.ones(half), np.zeros(num_diffusion_steps - half)))
    if schedule_name == "last-half":
        half = num_diffusion_steps // 2
        return np.concatenate((np.zeros(half), np.ones(num_diffusion_steps - half)))
    if schedule_name == "exponential":
        ts = np.arange(num_diffusion_steps)[::-1]
        return np.exp(-scale * ts)
    if schedule_name == "sigmoid":
        ts = np.arange(num_diffusion_steps)
        s = scale / 5
        return 1 / (1 + np.exp(s * (-ts + num_diffusion_steps / 2)))
    if schedule_name == "half-sigmoid":
        ts = np.arange(num_diffusion_steps)
        s = scale / 5
        return 1 / (1 + np.exp(s * (-ts)))
    raise NotImplementedError(f"unknown gradient schedule: {schedule_name}")


def _per_batch(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((v.shape[0],) + (1,) * (ndim - 1))


# --------------------------------------------------------------------------- #
# p_mean_variance
# --------------------------------------------------------------------------- #
def p_mean_variance(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    x: torch.Tensor,
    t: torch.Tensor,
    inpaint: Optional[InpaintingState] = None,
) -> dict[str, torch.Tensor]:
    """p(x_{t-1} | x_t) mean/variance and the x0 prediction.

    Three branches: reconstruction guidance, conditional imputation, plain.
    """
    t_model = sched.model_t(t)
    nd = x.ndim

    use_recg = inpaint is not None and inpaint.reconstruction_guidance
    use_imp = (
        inpaint is not None
        and inpaint.imputate
        and inpaint.replacement_distribution == "conditional"
    )

    if use_recg:
        imask = inpaint.inpainting_mask.to(x.dtype)
        with torch.enable_grad():
            z = x.detach().requires_grad_(True)
            hat = denoise_fn(z, t_model)
            loss = ((inpaint.inpainted_motion - hat) ** 2 * imask).sum()
            (cond_grad,) = torch.autograd.grad(loss, z)
        hat_x = hat.detach()
        cond_grad = cond_grad * (1.0 - imask)

        recg_on = _per_batch((t >= inpaint.stop_recguidance_at).to(x.dtype), nd)
        w_r = sched.extract(inpaint.grad_weights, t, nd) * recg_on
        sqrt_ab = sched.extract(sched.sqrt_alphas_cumprod, t, nd)
        tilde_x = hat_x - (w_r * sqrt_ab / 2.0) * cond_grad

        if inpaint.imputate:
            imp_gate = _per_batch((t >= inpaint.stop_imputation_at).to(x.dtype), nd)
        else:
            imp_gate = torch.zeros_like(recg_on)
        keyframe_val = imp_gate * inpaint.inpainted_motion + (1 - imp_gate) * hat_x
        blended = tilde_x * (1.0 - imask) + keyframe_val * imask
        # with the recon gate AND the imputation gate off, fall back to hat_x
        any_on = torch.maximum(recg_on, imp_gate)
        model_output = any_on * blended + (1 - any_on) * hat_x
    elif use_imp:
        hat_x = denoise_fn(x, t_model)
        imask = inpaint.inpainting_mask.to(x.dtype)
        imp_gate = _per_batch((t >= inpaint.stop_imputation_at).to(x.dtype), nd)
        replaced = hat_x * (1.0 - imask) + inpaint.inpainted_motion * imask
        model_output = imp_gate * replaced + (1 - imp_gate) * hat_x
    else:
        model_output = denoise_fn(x, t_model)

    model_var_values = None
    if cfg.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        C = x.shape[-1]
        model_output, model_var_values = model_output[..., :C], model_output[..., C:]
        if cfg.model_var_type == ModelVarType.LEARNED:
            model_log_variance = model_var_values
        else:
            min_log = sched.extract(sched.posterior_log_variance_clipped, t, nd)
            max_log = sched.extract(sched.log_betas, t, nd)
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    elif cfg.model_var_type == ModelVarType.FIXED_LARGE:
        model_variance = sched.extract(sched.fixed_large_variance, t, nd)
        model_log_variance = sched.extract(sched.fixed_large_log_variance, t, nd)
    else:  # FIXED_SMALL
        model_variance = sched.extract(sched.posterior_variance, t, nd)
        model_log_variance = sched.extract(sched.posterior_log_variance_clipped, t, nd)

    def process_xstart(xs):
        if cfg.model_mean_type != ModelMeanType.START_X and cfg.clip_range is not None:
            return xs.clamp(-cfg.clip_range, cfg.clip_range)
        return xs

    if cfg.model_mean_type == ModelMeanType.PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(sched, x, t, model_output))
        model_mean = model_output
    elif cfg.model_mean_type == ModelMeanType.START_X:
        pred_xstart = process_xstart(model_output)
        model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    else:  # EPSILON
        pred_xstart = process_xstart(predict_xstart_from_eps(sched, x, t, model_output))
        model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)

    return {
        "mean": model_mean,
        "variance": model_variance,
        "log_variance": model_log_variance,
        "pred_xstart": pred_xstart,
        "model_output": model_output,
        "model_var_values": model_var_values,
    }
