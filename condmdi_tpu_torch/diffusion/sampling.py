"""Denoising samplers (DDPM / DDIM / PLMS, and the DDIM reverse ODE): step
functions and the loops over them.

Counterpart of condmdi_tpu/diffusion/sampling.py. Classifier-free guidance is
folded into `denoise_fn` (the batch-doubled forward of models/cfg.py);
imputation and reconstruction guidance happen in `p_mean_variance`.

The JAX package runs a sampling run as one XLA program, a `lax.scan` over
the steps. `SamplerStep` is its scan body: (x, t, z[, z_marginal]) ->
(x, pred_xstart), the denoiser forward, `p_mean_variance` with conditional
imputation, the posterior mean (DDPM) or the DDIM update, the noise add and
marginal imputation. Two loops drive it, with the same draws in the same
order:

  * `ddpm_sample_loop` / `ddim_sample_loop` call it eagerly on fresh tensors;
  * `run_on_buffers` writes each step's t and noise into static buffers
    (`StepBuffers`) and runs a body that updates x in place (`step_body`):
    what a CUDA graph replays (sampling/pipeline.py captures one per
    denoiser branch, utils/cuda_graph.py). On the CPU the body runs as it is.

So a graph run and an eager run from the same generator seed give the same
bits. Three cases stay eager by rule, since their step runs autograd or host
code each step (`SamplerStep.capturable`): `cond_fn`, `cond_loss_fn` and
inpainting with reconstruction guidance (`autograd.grad` through the
denoiser). `skip_timesteps` only moves the start: the same step function.

PLMS (`PLMSStep`) has two parts, as the JAX loop has: a first step of two
model calls (pseudo improved Euler, when the order is above 1), always
eager, then the Adams-Bashforth body over an eps history, newest first,
which the JAX package runs as its scan and `plms_run_on_buffers` runs over
static buffers (`PLMSBuffers`: x, t, the history and the step's four
coefficients) for a graph to replay. `ddim_reverse_sample_loop` runs the
deterministic DDIM ODE from x_0 to x_T, eagerly.

Noise comes from an explicit `torch.Generator` on the schedule's device.
`step_noise` replaces it with one given tensor per step, so a test can feed
the same noise to this loop and to the JAX one.

While a loop runs a step, `current_model_step()` is that step's model
timestep on the host: a denoiser that switches models by timestep
(models/unet.py `MixedStepDenoiser`) reads it instead of reading t back from
the card.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from condmdi_tpu_torch.diffusion.gaussian import (
    DiffusionConfig,
    InpaintingState,
    p_mean_variance,
    predict_eps_from_xstart,
    predict_xstart_from_eps,
    q_posterior_mean_variance,
    q_sample,
)
from condmdi_tpu_torch.diffusion.schedule import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
CondFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_host = threading.local()


@dataclass(frozen=True)
class GuidanceParams:
    """Static switches for sampler-level guidance plumbing."""

    use_cond_fn: bool = False


@dataclass(frozen=True)
class SamplerConfig:
    method: str = "ddpm"  # ddpm | ddim | plms
    eta: float = 0.0  # ddim stochasticity
    order: int = 2  # plms Adams-Bashforth order (1-4)
    return_trajectory: bool = False  # also return every step's pred_xstart
    zero_noise: bool = False  # deterministic updates (testing/debugging)


def current_model_step():
    """The model timestep (a host number) of the step that the sampler loop on
    this thread is running; None outside a loop."""
    return getattr(_host, "t_model", None)


@contextlib.contextmanager
def at_model_step(t_model):
    """`current_model_step()` is `t_model` while open: one step run outside a
    loop (a server's warm-up)."""
    saved, _host.t_model = current_model_step(), t_model
    try:
        yield
    finally:
        _host.t_model = saved


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
# the step
# --------------------------------------------------------------------------- #
class SamplerStep:
    """One reverse step of `method` ("ddpm" or "ddim"): the JAX scan body.

    `step(x, t, z, z_marginal)` -> (x at the next step, pred_xstart): z is the
    step's noise (float32 as drawn, or x's dtype), z_marginal the marginal
    imputation's (None without it). cond_fn(pred_xstart, t_model) replaces
    pred_xstart; cond_loss_fn(pred_xstart, t_model) shifts the DDPM posterior
    mean by variance × grad(-loss) × cond_scale, the gradient taken through
    the denoiser.
    """

    def __init__(self, method: str, denoise_fn: DenoiseFn, sched: DiffusionSchedule,
                 cfg: DiffusionConfig, sampler: SamplerConfig = SamplerConfig(),
                 inpaint: Optional[InpaintingState] = None, cond_fn: Optional[CondFn] = None,
                 cond_loss_fn=None, cond_scale: float = 1.0):
        if method not in ("ddpm", "ddim"):
            raise ValueError(f"SamplerStep runs ddpm or ddim, not {method!r} (PLMSStep: plms)")
        if cond_loss_fn is not None and method != "ddpm":
            raise ValueError("cond_loss_fn guides the DDPM sampler only")
        self.method, self.denoise_fn, self.sched, self.cfg = method, denoise_fn, sched, cfg
        self.eta = sampler.eta
        self.inpaint, self.cond_fn = inpaint, cond_fn
        self.cond_loss_fn, self.cond_scale = cond_loss_fn, cond_scale
        self.marginal = _is_marginal(inpaint)
        # conditional-replacement inpainting runs inside p_mean_variance
        self.pm_inpaint = None if self.marginal else inpaint

    @property
    def capturable(self) -> bool:
        """False where the step runs autograd or host code of its own: cond_fn,
        cond_loss_fn, reconstruction guidance. Those runs stay eager."""
        recg = self.inpaint is not None and self.inpaint.reconstruction_guidance
        return self.cond_fn is None and self.cond_loss_fn is None and not recg

    def __call__(self, x, t, z, z_marginal=None):
        body = self._ddpm if self.method == "ddpm" else self._ddim
        x_next, pred_xstart = body(x, t, z.to(x.dtype))
        if self.marginal:
            x_next = _marginal_impute(self.sched, self.inpaint, x_next, t - 1, z_marginal)
        return x_next, pred_xstart

    def _ddpm(self, x, t, z):
        sched, cfg = self.sched, self.cfg
        if self.cond_loss_fn is not None:
            with torch.enable_grad():
                zx = x.detach().requires_grad_(True)
                out = p_mean_variance(self.denoise_fn, sched, cfg, zx, t, inpaint=self.pm_inpaint)
                neg_loss = -self.cond_loss_fn(out["pred_xstart"], sched.model_t(t))
                (grad,) = torch.autograd.grad(neg_loss, zx)
            out = {k: (v.detach() if v is not None else None) for k, v in out.items()}
            out["mean"] = out["mean"] + out["variance"] * grad * self.cond_scale
        else:
            out = p_mean_variance(self.denoise_fn, sched, cfg, x, t, inpaint=self.pm_inpaint)
        if self.cond_fn is not None:
            new_xstart = self.cond_fn(out["pred_xstart"], sched.model_t(t))
            mean, _, _ = q_posterior_mean_variance(sched, new_xstart, x, t)
            out = {**out, "mean": mean, "pred_xstart": new_xstart}
        x_next = out["mean"] + _nonzero_mask(t, x.ndim) * torch.exp(0.5 * out["log_variance"]) * z
        return x_next, out["pred_xstart"]

    def _ddim(self, x, t, z):
        sched = self.sched
        out = p_mean_variance(self.denoise_fn, sched, self.cfg, x, t, inpaint=self.pm_inpaint)
        if self.cond_fn is not None:
            out = {**out, "pred_xstart": self.cond_fn(out["pred_xstart"], sched.model_t(t))}

        eps = predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
        alpha_bar = sched.extract(sched.alphas_cumprod, t, x.ndim)
        alpha_bar_prev = sched.extract(sched.alphas_cumprod_prev, t, x.ndim)
        sigma = (
            self.eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_prev) + torch.sqrt(
            (1 - alpha_bar_prev - sigma**2).clamp(min=0.0)
        ) * eps
        return mean_pred + _nonzero_mask(t, x.ndim) * sigma * z, out["pred_xstart"]


def sampler_steps(method: str, sched: DiffusionSchedule, skip_timesteps: int = 0) -> range:
    """The respaced steps a run visits, in order (DDPM may skip the first ones)."""
    first = sched.num_timesteps - 1 - (skip_timesteps if method == "ddpm" else 0)
    return range(first, -1, -1)


def initial_x(shape, sched, generator=None, noise=None, skip_timesteps=0, init_image=None):
    """x_T: `noise`, or drawn from `generator`; with skip_timesteps, the init
    image (zeros if None) noised to the first step visited."""
    x = noise if noise is not None else _randn(shape, sched, generator)
    if skip_timesteps:
        t_start = sched.num_timesteps - 1 - skip_timesteps
        init = init_image if init_image is not None else torch.zeros_like(x)
        t0 = torch.full((shape[0],), t_start, dtype=torch.long, device=x.device)
        x = q_sample(sched, init, t0, x)
    return x


def _finish(x, traj, sampler):
    if sampler.return_trajectory:
        return x, torch.stack(traj)
    return x


def eager_loop(step: SamplerStep, x, steps, generator=None, step_noise=None,
               sampler: SamplerConfig = SamplerConfig()):
    """Every step called on fresh tensors: t, then the step's noise, then the
    marginal noise, each drawn as the step starts."""
    sched, B = step.sched, x.shape[0]
    traj = []
    saved = current_model_step()
    try:
        for i, ti in enumerate(steps):
            _host.t_model = sched.model_t_host(ti)
            t = torch.full((B,), ti, dtype=torch.long, device=x.device)
            z = _step_noise(i, x, sched, sampler, generator, step_noise)
            zm = _randn(x.shape, sched, generator) if step.marginal else None
            x, pred_xstart = step(x, t, z, zm)
            if sampler.return_trajectory:
                traj.append(pred_xstart)
    finally:
        _host.t_model = saved
    return _finish(x, traj, sampler)


# --------------------------------------------------------------------------- #
# the loop over static buffers (what a CUDA graph replays)
# --------------------------------------------------------------------------- #
@dataclass
class StepBuffers:
    """The static inputs of one step: x (updated in place by `step_body`), t [B],
    z float32 and, with marginal imputation, z_marginal float32."""

    x: torch.Tensor
    t: torch.Tensor
    z: torch.Tensor
    z_marginal: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, shape, dtype, device, marginal: bool) -> "StepBuffers":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape[:1], dtype=torch.long, device=device),
                   torch.zeros(shape, **f32),
                   torch.zeros(shape, **f32) if marginal else None)


def step_body(step: SamplerStep, buf: StepBuffers) -> Callable[[], torch.Tensor]:
    """One step over `buf` with x written back in place; returns pred_xstart.
    This is the function a graph captures."""

    def body():
        x_next, pred_xstart = step(buf.x, buf.t, buf.z, buf.z_marginal)
        buf.x.copy_(x_next)
        return pred_xstart

    return body


def run_on_buffers(run_step: Callable[[int, int], torch.Tensor], buf: StepBuffers,
                   sched: DiffusionSchedule, x, steps, generator=None, step_noise=None,
                   sampler: SamplerConfig = SamplerConfig()):
    """The loop as a replay drives it: x into `buf`; each step its t and its
    noise written into `buf` (drawn in `eager_loop`'s order, into the buffers),
    then `run_step(i, ti)`, which replays the step's graph or runs
    `step_body` itself, and returns pred_xstart. Returns a copy of the last x."""
    buf.x.copy_(x)
    traj = []
    saved = current_model_step()
    try:
        for i, ti in enumerate(steps):
            _host.t_model = sched.model_t_host(ti)
            buf.t.fill_(ti)
            if sampler.zero_noise:
                buf.z.zero_()
            elif step_noise is not None:
                buf.z.copy_(step_noise[i].to(device=buf.z.device, dtype=buf.x.dtype))
            else:
                torch.randn(buf.z.shape, generator=generator, out=buf.z)
            if buf.z_marginal is not None:
                torch.randn(buf.z_marginal.shape, generator=generator, out=buf.z_marginal)
            pred_xstart = run_step(i, ti)
            if sampler.return_trajectory:
                traj.append(pred_xstart.clone())
    finally:
        _host.t_model = saved
    return _finish(buf.x.clone(), traj, sampler)


# --------------------------------------------------------------------------- #
# the loops
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
    """Ancestral DDPM sampling, eagerly (`SamplerStep` for the guidance
    arguments). skip_timesteps / init_image: partial denoising from a noised
    init image."""
    step = SamplerStep("ddpm", denoise_fn, sched, cfg, sampler, inpaint, cond_fn, cond_loss_fn,
                       cond_scale)
    x = initial_x(shape, sched, generator, noise, skip_timesteps, init_image)
    return eager_loop(step, x, sampler_steps("ddpm", sched, skip_timesteps), generator,
                      step_noise, sampler)


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
    """DDIM (eta-parameterized) sampling loop, eagerly."""
    step = SamplerStep("ddim", denoise_fn, sched, cfg, sampler, inpaint, cond_fn)
    x = initial_x(shape, sched, generator, noise)
    return eager_loop(step, x, sampler_steps("ddim", sched), generator, step_noise, sampler)


def ddim_reverse_sample_loop(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    x0: torch.Tensor,
) -> torch.Tensor:
    """Deterministic DDIM reverse ODE x_0 → x_T (reference :1418), eagerly."""
    B, nd = x0.shape[0], x0.ndim
    x = x0
    saved = current_model_step()
    try:
        with torch.no_grad():
            for ti in range(sched.num_timesteps):
                _host.t_model = sched.model_t_host(ti)
                t = torch.full((B,), ti, dtype=torch.long, device=x.device)
                out = p_mean_variance(denoise_fn, sched, cfg, x, t)
                eps = (sched.extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x
                       - out["pred_xstart"]) / sched.extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)
                alpha_bar_next = sched.extract(sched.alphas_cumprod_next, t, nd)
                x = out["pred_xstart"] * torch.sqrt(alpha_bar_next) + torch.sqrt(
                    1 - alpha_bar_next) * eps
    finally:
        _host.t_model = saved
    return x


# --------------------------------------------------------------------------- #
# PLMS (pseudo linear multistep, Adams-Bashforth order 1-4)
# --------------------------------------------------------------------------- #
# index k: the coefficients over [e_t, e_{t-1}, ...] with k + 1 taps, padded to 4
_AB_COEFS = (
    (1.0, 0.0, 0.0, 0.0),
    (3.0 / 2.0, -1.0 / 2.0, 0.0, 0.0),
    (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0, 0.0),
    (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0),
)


def plms_body_steps(sched: DiffusionSchedule) -> range:
    """The steps of the multistep body, after the first step at S - 1."""
    return range(sched.num_timesteps - 2, -1, -1)


class PLMSStep:
    """PLMS (reference plms_sample:1589): `first(x)` takes the first step at
    t = S - 1 (two model calls when the order is above 1); `step(x, t, hist,
    coefs)` is one step of the multistep body, the JAX scan's: the model's
    eps, the step's Adams-Bashforth coefficients (`coefs`, the row of
    `_AB_COEFS` for the taps available) over [eps, hist...], the update, and
    the history shifted with eps in front. `inpaint` goes to p_mean_variance
    as it is, as the JAX loop passes it."""

    def __init__(self, denoise_fn: DenoiseFn, sched: DiffusionSchedule, cfg: DiffusionConfig,
                 sampler: SamplerConfig = SamplerConfig(method="plms"),
                 inpaint: Optional[InpaintingState] = None):
        self.order = int(sampler.order)
        if not 1 <= self.order <= 4:
            raise ValueError(f"PLMS order {self.order} is not in 1-4")
        self.denoise_fn, self.sched, self.cfg, self.inpaint = denoise_fn, sched, cfg, inpaint
        self.coef_table = torch.tensor(_AB_COEFS, dtype=torch.float32, device=sched.device)

    @property
    def capturable(self) -> bool:
        """False with reconstruction guidance (autograd through the denoiser)."""
        return not (self.inpaint is not None and self.inpaint.reconstruction_guidance)

    def coefs(self, j: int) -> torch.Tensor:
        """The coefficients of body step j (0-based): min(j + 2, order) taps."""
        return self.coef_table[min(j + 2, self.order) - 1]

    def model_eps(self, x, t):
        out = p_mean_variance(self.denoise_fn, self.sched, self.cfg, x, t, inpaint=self.inpaint)
        return predict_eps_from_xstart(self.sched, x, t, out["pred_xstart"]), out

    def first(self, x):
        """(x after the first step, eps of the first call, its pred_xstart)."""
        sched, nd, B = self.sched, x.ndim, x.shape[0]
        ti = sched.num_timesteps - 1
        t0 = torch.full((B,), ti, dtype=torch.long, device=x.device)
        _host.t_model = sched.model_t_host(ti)
        eps0, out0 = self.model_eps(x, t0)
        alpha_bar_prev0 = sched.extract(sched.alphas_cumprod_prev, t0, nd)
        if self.order > 1:  # pseudo improved Euler (Heun)
            mean_pred = out0["pred_xstart"] * torch.sqrt(alpha_bar_prev0) + torch.sqrt(
                1 - alpha_bar_prev0) * eps0
            _host.t_model = sched.model_t_host(max(ti - 1, 0))
            eps2, _ = self.model_eps(mean_pred, (t0 - 1).clamp(min=0))
            eps_prime = (eps0 + eps2) / 2
        else:
            eps_prime = eps0
        pred_prime = predict_xstart_from_eps(sched, x, t0, eps_prime)
        x = pred_prime * torch.sqrt(alpha_bar_prev0) + torch.sqrt(1 - alpha_bar_prev0) * eps_prime
        return x, eps0, out0["pred_xstart"]

    def step(self, x, t, hist, coefs):
        """(x at the next step, the shifted history, pred_xstart)."""
        sched, nd = self.sched, x.ndim
        eps, out = self.model_eps(x, t)
        taps = torch.cat([eps[None], hist], dim=0)[:4]
        if taps.shape[0] < 4:
            taps = torch.cat([taps, taps.new_zeros((4 - taps.shape[0],) + taps.shape[1:])])
        eps_prime = (coefs.to(x.dtype).reshape((4,) + (1,) * nd) * taps).sum(dim=0)
        pred_prime = predict_xstart_from_eps(sched, x, t, eps_prime)
        alpha_bar_prev = sched.extract(sched.alphas_cumprod_prev, t, nd)
        mean_pred = pred_prime * torch.sqrt(alpha_bar_prev) + torch.sqrt(
            1 - alpha_bar_prev) * eps_prime
        nz = _nonzero_mask(t, nd)
        sample = mean_pred * nz + out["pred_xstart"] * (1 - nz)
        return sample, torch.cat([eps[None], hist[:-1]], dim=0), out["pred_xstart"]

    def initial_history(self, eps0):
        hist = eps0.new_zeros((self.order,) + eps0.shape)
        hist[0] = eps0
        return hist


@dataclass
class PLMSBuffers:
    """The static inputs of one PLMS body step: x and the eps history (updated in
    place by `plms_step_body`), t [B] and the step's coefficients [4]."""

    x: torch.Tensor
    t: torch.Tensor
    hist: torch.Tensor
    coefs: torch.Tensor

    @classmethod
    def create(cls, shape, dtype, device, order: int) -> "PLMSBuffers":
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape[:1], dtype=torch.long, device=device),
                   torch.zeros((order,) + tuple(shape), dtype=dtype, device=device),
                   torch.zeros(4, dtype=torch.float32, device=device))


def plms_step_body(step: PLMSStep, buf: PLMSBuffers) -> Callable[[], torch.Tensor]:
    """One body step over `buf`, x and the history written back in place; returns
    pred_xstart. The function a graph captures."""

    def body():
        x_next, hist, pred_xstart = step.step(buf.x, buf.t, buf.hist, buf.coefs)
        buf.x.copy_(x_next)
        buf.hist.copy_(hist)
        return pred_xstart

    return body


def plms_eager_loop(step: PLMSStep, x):
    """The first step, then every body step on fresh tensors."""
    B = x.shape[0]
    saved = current_model_step()
    try:
        x, eps0, _ = step.first(x)
        hist = step.initial_history(eps0)
        for j, ti in enumerate(plms_body_steps(step.sched)):
            _host.t_model = step.sched.model_t_host(ti)
            t = torch.full((B,), ti, dtype=torch.long, device=x.device)
            x, hist, _ = step.step(x, t, hist, step.coefs(j))
    finally:
        _host.t_model = saved
    return x


def plms_run_on_buffers(run_step: Callable[[int, int], torch.Tensor], buf: PLMSBuffers,
                        step: PLMSStep, x):
    """The loop as a replay drives it: the first step eagerly, its x and eps into
    `buf`; each body step its t and coefficients written into `buf`, then
    `run_step(j, ti)` (a graph replay, or `plms_step_body` itself). Returns a
    copy of the last x."""
    saved = current_model_step()
    try:
        x, eps0, _ = step.first(x)
        buf.x.copy_(x)
        buf.hist.copy_(step.initial_history(eps0))
        for j, ti in enumerate(plms_body_steps(step.sched)):
            _host.t_model = step.sched.model_t_host(ti)
            buf.t.fill_(ti)
            buf.coefs.copy_(step.coefs(j))
            run_step(j, ti)
    finally:
        _host.t_model = saved
    return buf.x.clone()


@torch.no_grad()
def plms_sample_loop(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    shape: tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    inpaint: Optional[InpaintingState] = None,
    sampler: SamplerConfig = SamplerConfig(method="plms", order=2),
):
    """PLMS sampling (reference plms_sample_loop:1690), eagerly: a first
    (Heun) step, then the Adams-Bashforth body over an eps history."""
    step = PLMSStep(denoise_fn, sched, cfg, sampler, inpaint)
    return plms_eager_loop(step, initial_x(shape, sched, generator, noise))
