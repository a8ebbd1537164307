"""Denoising samplers (DDPM / DDIM) as Python loops over the steps.

Counterpart of condmdi_tpu/diffusion/sampling.py (PLMS waits for a later
slice). Classifier-free guidance is folded into `denoise_fn` (the
batch-doubled forward of models/cfg.py); imputation and reconstruction
guidance happen in `p_mean_variance`.

Noise comes from an explicit `torch.Generator` on the schedule's device.
`step_noise` replaces it with one given tensor per step, so a test can feed
the same noise to this loop and to the JAX one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from condmdi_tpu_torch.diffusion.gaussian import (
    DiffusionConfig,
    InpaintingState,
    p_mean_variance,
    predict_eps_from_xstart,
    q_posterior_mean_variance,
    q_sample,
)
from condmdi_tpu_torch.diffusion.schedule import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
CondFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class SamplerConfig:
    method: str = "ddpm"  # ddpm | ddim
    eta: float = 0.0  # ddim stochasticity
    return_trajectory: bool = False  # also return every step's pred_xstart
    zero_noise: bool = False  # deterministic updates (testing/debugging)


def _nonzero_mask(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return (t != 0).float().reshape((t.shape[0],) + (1,) * (ndim - 1))


def _randn(shape, sched: DiffusionSchedule, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator, device=sched.device)


def _marginal_impute(sched, inpaint: InpaintingState, x, t_prev, noise):
    """'marginal' replacement: observed entries re-noised from q(x_{t-1}|x_0).

    At t_prev < 0 (the final step) the clean motion is imputed directly.
    """
    imask = inpaint.inpainting_mask.to(x.dtype)
    bshape = (-1,) + (1,) * (x.ndim - 1)
    noised = q_sample(sched, inpaint.inpainted_motion, t_prev.clamp(min=0), noise)
    noised = torch.where((t_prev >= 0).reshape(bshape), noised, inpaint.inpainted_motion)
    gate = (t_prev >= inpaint.stop_imputation_at - 1).to(x.dtype).reshape(bshape)
    return x * (1 - imask * gate) + noised * imask * gate


def _is_marginal(inpaint: Optional[InpaintingState]) -> bool:
    return (
        inpaint is not None
        and inpaint.imputate
        and inpaint.replacement_distribution == "marginal"
    )


def _step_noise(i, x, sched, sampler, generator, step_noise):
    if sampler.zero_noise:
        return torch.zeros_like(x)
    if step_noise is not None:
        return step_noise[i].to(device=x.device, dtype=x.dtype)
    return _randn(x.shape, sched, generator).to(x.dtype)


# --------------------------------------------------------------------------- #
# DDPM
# --------------------------------------------------------------------------- #
@torch.no_grad()
def ddpm_sample_loop(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    shape: tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    inpaint: Optional[InpaintingState] = None,
    cond_fn: Optional[CondFn] = None,
    cond_loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    cond_scale: float = 1.0,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
    sampler: SamplerConfig = SamplerConfig(),
    step_noise: Optional[Sequence[torch.Tensor]] = None,
):
    """Ancestral DDPM sampling.

    cond_fn(pred_xstart, t_model): score conditioning, replaces pred_xstart.
    cond_loss_fn(pred_xstart, t_model): mean-shift guidance; the gradient of
    -loss with respect to x_t flows through the denoiser and shifts the
    posterior mean by variance × grad × cond_scale.
    skip_timesteps / init_image: partial denoising from a noised init image.
    """
    B = shape[0]
    x = noise if noise is not None else _randn(shape, sched, generator)
    if skip_timesteps:
        t_start = sched.num_timesteps - 1 - skip_timesteps
        init = init_image if init_image is not None else torch.zeros_like(x)
        t0 = torch.full((B,), t_start, dtype=torch.long, device=x.device)
        x = q_sample(sched, init, t0, x)

    marginal = _is_marginal(inpaint)
    # conditional-replacement inpainting runs inside p_mean_variance
    pm_inpaint = None if marginal else inpaint

    traj = []
    steps = range(sched.num_timesteps - 1 - skip_timesteps, -1, -1)
    for i, ti in enumerate(steps):
        t = torch.full((B,), ti, dtype=torch.long, device=x.device)
        if cond_loss_fn is not None:
            with torch.enable_grad():
                z = x.detach().requires_grad_(True)
                out = p_mean_variance(denoise_fn, sched, cfg, z, t, inpaint=pm_inpaint)
                neg_loss = -cond_loss_fn(out["pred_xstart"], sched.model_t(t))
                (grad,) = torch.autograd.grad(neg_loss, z)
            out = {k: (v.detach() if v is not None else None) for k, v in out.items()}
            out["mean"] = out["mean"] + out["variance"] * grad * cond_scale
        else:
            out = p_mean_variance(denoise_fn, sched, cfg, x, t, inpaint=pm_inpaint)
        if cond_fn is not None:
            new_xstart = cond_fn(out["pred_xstart"], sched.model_t(t))
            mean, _, _ = q_posterior_mean_variance(sched, new_xstart, x, t)
            out = {**out, "mean": mean, "pred_xstart": new_xstart}
        z = _step_noise(i, x, sched, sampler, generator, step_noise)
        x = out["mean"] + _nonzero_mask(t, x.ndim) * torch.exp(0.5 * out["log_variance"]) * z
        if marginal:
            x = _marginal_impute(sched, inpaint, x, t - 1, _randn(x.shape, sched, generator))
        if sampler.return_trajectory:
            traj.append(out["pred_xstart"])
    if sampler.return_trajectory:
        return x, torch.stack(traj)
    return x


# --------------------------------------------------------------------------- #
# DDIM
# --------------------------------------------------------------------------- #
@torch.no_grad()
def ddim_sample_loop(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    shape: tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    inpaint: Optional[InpaintingState] = None,
    cond_fn: Optional[CondFn] = None,
    sampler: SamplerConfig = SamplerConfig(method="ddim"),
    step_noise: Optional[Sequence[torch.Tensor]] = None,
):
    """DDIM (eta-parameterized) sampling loop."""
    B = shape[0]
    eta = sampler.eta
    x = noise if noise is not None else _randn(shape, sched, generator)

    marginal = _is_marginal(inpaint)
    pm_inpaint = None if marginal else inpaint

    traj = []
    for i, ti in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        t = torch.full((B,), ti, dtype=torch.long, device=x.device)
        out = p_mean_variance(denoise_fn, sched, cfg, x, t, inpaint=pm_inpaint)
        if cond_fn is not None:
            out = {**out, "pred_xstart": cond_fn(out["pred_xstart"], sched.model_t(t))}

        eps = predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
        alpha_bar = sched.extract(sched.alphas_cumprod, t, x.ndim)
        alpha_bar_prev = sched.extract(sched.alphas_cumprod_prev, t, x.ndim)
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        z = _step_noise(i, x, sched, sampler, generator, step_noise)
        mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_prev) + torch.sqrt(
            (1 - alpha_bar_prev - sigma**2).clamp(min=0.0)
        ) * eps
        x = mean_pred + _nonzero_mask(t, x.ndim) * sigma * z
        if marginal:
            x = _marginal_impute(sched, inpaint, x, t - 1, _randn(x.shape, sched, generator))
        if sampler.return_trajectory:
            traj.append(out["pred_xstart"])
    if sampler.return_trajectory:
        return x, torch.stack(traj)
    return x
