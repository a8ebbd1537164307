"""Gaussian diffusion core: q/posterior math and p_mean_variance.

Counterpart of condmdi_tpu/diffusion/gaussian.py, training losses
included (`vb_terms_bpd`, `training_losses`, `calc_bpd_loop`), and the
`GaussianDiffusion` wrapper over the functions. The denoiser
enters as `denoise_fn(x, t_model)`, already closed over weights and
conditioning, so this module is model-agnostic. Layout is [B, T, F]; time
masks are [B, T]; observation masks are [B, T, F].

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

from condmdi_tpu_torch.diffusion.losses import (
    discretized_gaussian_log_likelihood,
    masked_l2,
    masked_l2_weighted,
    mean_flat,
    normal_kl,
)
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


class LossType(enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"

    def is_vb(self):
        return self in (LossType.KL, LossType.RESCALED_KL)


@dataclass(frozen=True)
class DiffusionConfig:
    """The JAX package's DiffusionConfig, field for field."""

    model_mean_type: ModelMeanType = ModelMeanType.START_X
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL
    loss_type: LossType = LossType.MSE
    lambda_rcxyz: float = 0.0
    lambda_vel: float = 0.0
    lambda_root_vel: float = 0.0
    lambda_vel_rcxyz: float = 0.0
    lambda_fc: float = 0.0
    data_rep: str = "hml_vec"
    clip_range: Optional[float] = None
    abs_3d: bool = True
    traj_only: bool = False
    apply_zero_mask: bool = False
    traj_extra_weight: float = 1.0
    time_weighted_loss: bool = False
    train_x0_as_eps: bool = False


# --------------------------------------------------------------------------- #
# Closed-form q distributions
# --------------------------------------------------------------------------- #
def q_mean_variance(sched: DiffusionSchedule, x_start, t):
    nd = x_start.ndim
    mean = sched.extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
    variance = sched.extract(1.0 - sched.alphas_cumprod, t, nd)
    log_variance = sched.extract(sched.log_one_minus_alphas_cumprod, t, nd)
    return mean, variance, log_variance


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


# --------------------------------------------------------------------------- #
# VLB terms
# --------------------------------------------------------------------------- #
def vb_terms_bpd(denoise_fn, sched, cfg, x_start, x_t, t, inpaint=None) -> dict:
    """The variational-bound term in bits per dim [B]: the decoder NLL at t = 0,
    KL(q(x_{t-1} | x_t, x_0) || p(x_{t-1} | x_t)) elsewhere."""
    true_mean, _, true_log_var = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(denoise_fn, sched, cfg, x_t, t, inpaint=inpaint)
    kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
    kl = mean_flat(kl) / np.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out["mean"], log_scales=0.5 * out["log_variance"]
    )
    decoder_nll = mean_flat(decoder_nll) / np.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}


# --------------------------------------------------------------------------- #
# Training losses
# --------------------------------------------------------------------------- #
def training_losses(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    time_mask: torch.Tensor,
    obs_mask: Optional[torch.Tensor] = None,
    zero_keyframe_loss: bool = False,
    keyframe_conditioned: bool = False,
    get_xyz: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> dict[str, torch.Tensor]:
    """The MSE-family training loss, per-sample [B] terms.

    Trajectory over-weighting, keyframe-loss zeroing, keyframe-MSE logging,
    the velocity loss and the time-weighted / x0-as-eps reweighting, as in
    the JAX package. The SMPL losses (rcxyz, fc) run only when `get_xyz`
    (forward kinematics to joints) is given and their lambda is non-zero.
    """
    x_t = q_sample(sched, x_start, t, noise)
    if cfg.apply_zero_mask:
        x_t = x_t * time_mask[..., None].to(x_t.dtype)

    terms: dict[str, torch.Tensor] = {}

    if cfg.loss_type in (LossType.KL, LossType.RESCALED_KL):
        terms["loss"] = vb_terms_bpd(denoise_fn, sched, cfg, x_start, x_t, t)["output"]
        if cfg.loss_type == LossType.RESCALED_KL:
            terms["loss"] = terms["loss"] * sched.num_timesteps
        return terms

    model_output = denoise_fn(x_t, sched.model_t(t))

    if cfg.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        C = x_t.shape[-1]
        model_output, model_var_values = model_output[..., :C], model_output[..., C:]
        # the vb term trains the variance only: the mean enters it detached
        frozen = torch.cat([model_output.detach(), model_var_values], dim=-1)
        terms["vb"] = vb_terms_bpd(lambda *_args: frozen, sched, cfg, x_start, x_t, t)["output"]
        if cfg.loss_type == LossType.RESCALED_MSE:
            terms["vb"] = terms["vb"] * (sched.num_timesteps / 1000.0)

    if cfg.model_mean_type == ModelMeanType.PREVIOUS_X:
        target = q_posterior_mean_variance(sched, x_start, x_t, t)[0]
    elif cfg.model_mean_type == ModelMeanType.START_X:
        target = x_start
    else:
        target = noise

    B, T, F = target.shape
    weights = torch.ones((B, 1, F), dtype=target.dtype, device=target.device)
    if cfg.traj_extra_weight != 1.0:
        # squared: the reference applies it outside the squared error
        weights[..., :4] *= cfg.traj_extra_weight**2

    if zero_keyframe_loss:
        if obs_mask is None:
            raise ValueError("zero_keyframe_loss needs obs_mask")
        full = time_mask[..., None] & ~obs_mask.bool()
        terms["rot_mse"] = masked_l2_weighted(target, model_output, full, weights,
                                              over_keyframes=True)
    else:
        terms["rot_mse"] = masked_l2_weighted(target, model_output, time_mask, weights)

    if keyframe_conditioned and obs_mask is not None:
        kf_mask = time_mask[..., None] & obs_mask.bool()
        terms["keyframes_mse"] = masked_l2_weighted(target, model_output, kf_mask, weights,
                                                    over_keyframes=True)

    target_xyz = output_xyz = None
    if cfg.lambda_rcxyz > 0.0 and get_xyz is not None:
        target_xyz, output_xyz = get_xyz(target), get_xyz(model_output)
        terms["rcxyz_mse"] = masked_l2(target_xyz.reshape(B, T, -1),
                                       output_xyz.reshape(B, T, -1), time_mask)

    if cfg.lambda_fc > 0.0 and get_xyz is not None:
        if target_xyz is None:
            target_xyz, output_xyz = get_xyz(target), get_xyz(model_output)
        def feet(xyz):  # L_Ankle, L_Foot, R_Ankle, R_Foot, without a host index
            return torch.stack([xyz[:, :, j] for j in (7, 10, 8, 11)], dim=2)

        gt_feet = feet(target_xyz)
        gt_vel = torch.linalg.norm(gt_feet[:, 1:] - gt_feet[:, :-1], dim=-1)
        fc_mask = (gt_vel <= 0.01)[..., None]
        pred_feet = feet(output_xyz)
        pred_vel = (pred_feet[:, 1:] - pred_feet[:, :-1]) * fc_mask
        terms["fc"] = masked_l2(pred_vel.reshape(B, T - 1, -1),
                                torch.zeros_like(pred_vel).reshape(B, T - 1, -1),
                                time_mask[:, 1:])

    if cfg.lambda_vel > 0.0:
        target_vel = target[:, 1:] - target[:, :-1]
        out_vel = model_output[:, 1:] - model_output[:, :-1]
        # the reference drops the last feature ("root location")
        terms["vel_mse"] = masked_l2(target_vel[..., :-1], out_vel[..., :-1], time_mask[:, 1:])

    loss = terms["rot_mse"]
    if "vb" in terms:
        loss = loss + terms["vb"]
    for key, lam in (("vel_mse", cfg.lambda_vel), ("rcxyz_mse", cfg.lambda_rcxyz),
                     ("fc", cfg.lambda_fc)):
        loss = loss + lam * terms[key] if key in terms else loss
    terms["loss"] = loss

    if cfg.time_weighted_loss:
        tw = sched.ratio_eps[t]
        terms["loss"] = terms["loss"] * (tw / tw.mean())
    if cfg.train_x0_as_eps:
        tw = sched.snr_weight[t]
        terms["loss"] = terms["loss"] * (tw / tw.mean())
    return terms


def calc_bpd_loop(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    x_start: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    step_noise=None,
) -> dict[str, torch.Tensor]:
    """The full variational bound: per-timestep VLB terms and x0 / eps MSEs
    ([B, S], column i for t = S-1-i, as the JAX scan stacks them), the prior
    KL and the total bits per dim.

    Noise for each step, from t = S-1 down to 0, comes from `generator`, or
    from `step_noise[i]` (the i-th step of that descending order) when given.
    """
    B = x_start.shape[0]
    S = sched.num_timesteps
    vb, xstart_mse, mse = [], [], []
    with torch.no_grad():
        for i, ti in enumerate(range(S - 1, -1, -1)):
            t = torch.full((B,), ti, dtype=torch.long, device=x_start.device)
            if step_noise is not None:
                noise = torch.as_tensor(step_noise[i], device=x_start.device, dtype=x_start.dtype)
            else:
                noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                    dtype=x_start.dtype)
            x_t = q_sample(sched, x_start, t, noise)
            out = vb_terms_bpd(denoise_fn, sched, cfg, x_start, x_t, t)
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            eps = predict_eps_from_xstart(sched, x_t, t, out["pred_xstart"])
            mse.append(mean_flat((eps - noise) ** 2))
            vb.append(out["output"])
        qt_mean, _, qt_log_var = q_mean_variance(
            sched, x_start, torch.full((B,), S - 1, dtype=torch.long, device=x_start.device))
        prior_kl = mean_flat(normal_kl(qt_mean, qt_log_var, 0.0, 0.0)) / np.log(2.0)
    vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))
    return {"total_bpd": vb.sum(dim=1) + prior_kl, "prior_bpd": prior_kl, "vb": vb,
            "xstart_mse": xstart_mse, "mse": mse}


class GaussianDiffusion:
    """The (schedule, config) pair with the module functions as methods, the
    interface of the reference GaussianDiffusion; the work is in the functions."""

    def __init__(self, sched: DiffusionSchedule, cfg: DiffusionConfig):
        self.sched = sched
        self.cfg = cfg

    @property
    def num_timesteps(self) -> int:
        return self.sched.num_timesteps

    def q_sample(self, x_start, t, noise):
        return q_sample(self.sched, x_start, t, noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        return q_posterior_mean_variance(self.sched, x_start, x_t, t)

    def p_mean_variance(self, denoise_fn, x, t, inpaint=None):
        return p_mean_variance(denoise_fn, self.sched, self.cfg, x, t, inpaint=inpaint)

    def training_losses(self, denoise_fn, x_start, t, noise, time_mask, **kw):
        return training_losses(denoise_fn, self.sched, self.cfg, x_start, t, noise, time_mask,
                               **kw)
