"""End-to-end sampling pipeline: model + schedule + guidance → motions.

Counterpart of condmdi_tpu/sampling/pipeline.py for the DDPM and DDIM
samplers (PLMS waits for a later slice, ROADMAP Queue A 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from condmdi_tpu_torch.data.humanml_repr import recover_from_ric
from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.diffusion.gaussian import (
    DiffusionConfig,
    InpaintingState,
    get_gradient_schedule,
)
from condmdi_tpu_torch.diffusion.sampling import (
    SamplerConfig,
    ddim_sample_loop,
    ddpm_sample_loop,
)
from condmdi_tpu_torch.diffusion.schedule import DiffusionSchedule
from condmdi_tpu_torch.models.cfg import make_cfg_denoiser, make_plain_denoiser


def build_inpainting_state(
    inpainted_motion: torch.Tensor,
    inpainting_mask: torch.Tensor,
    time_mask: Optional[torch.Tensor] = None,
    imputate: bool = False,
    reconstruction_guidance: bool = False,
    reconstruction_weight: float = 5.0,
    gradient_schedule: Optional[str] = None,
    stop_imputation_at: int = 0,
    stop_recguidance_at: int = 0,
    replacement_distribution: str = "conditional",
    diffusion_steps: int = 1000,
) -> InpaintingState:
    """Assemble the inpainting state from CondSynt-style options.

    The gradient schedule is indexed by the RESPACED step, with length
    diffusion_steps, as in the reference.
    """
    if time_mask is not None:
        inpainting_mask = inpainting_mask & time_mask[..., None].bool()
    grad_ws = get_gradient_schedule(gradient_schedule, diffusion_steps)
    return InpaintingState(
        inpainted_motion=inpainted_motion,
        inpainting_mask=inpainting_mask,
        grad_weights=torch.as_tensor(
            np.asarray(grad_ws * reconstruction_weight, np.float32),
            device=inpainted_motion.device,
        ),
        stop_imputation_at=int(stop_imputation_at),
        stop_recguidance_at=int(stop_recguidance_at),
        imputate=imputate,
        reconstruction_guidance=reconstruction_guidance,
        replacement_distribution=replacement_distribution,
    )


@dataclass
class SamplePipeline:
    """Callable sampler bound to a model apply_fn + diffusion setup.

    Runs on `device` ("cuda" unless the caller passes "cpu"); the schedule is
    moved there.
    """

    apply_fn: Callable[..., torch.Tensor]  # (x, t, y, **obs) -> model out
    sched: DiffusionSchedule
    dcfg: DiffusionConfig
    sampler: SamplerConfig = SamplerConfig()
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.sched = self.sched.to(self.device)

    def denoiser(
        self,
        y: dict[str, Any],
        guidance_param: float = 1.0,
        obs_x0: Optional[torch.Tensor] = None,
        obs_mask: Optional[torch.Tensor] = None,
    ):
        if guidance_param != 1.0:
            return make_cfg_denoiser(
                self.apply_fn, y, guidance_param, obs_x0=obs_x0, obs_mask=obs_mask
            )
        return make_plain_denoiser(self.apply_fn, y, obs_x0=obs_x0, obs_mask=obs_mask)

    def sample(
        self,
        shape: tuple[int, ...],
        y: dict[str, Any],
        guidance_param: float = 1.0,
        obs_x0: Optional[torch.Tensor] = None,
        obs_mask: Optional[torch.Tensor] = None,
        inpaint: Optional[InpaintingState] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        denoise = self.denoiser(y, guidance_param, obs_x0, obs_mask)
        method = self.sampler.method
        if method == "ddpm":
            loop = ddpm_sample_loop
        elif method == "ddim":
            loop = ddim_sample_loop
        else:
            raise ValueError(f"sampler {method!r} is not ported")
        return loop(
            denoise, self.sched, self.dcfg, shape, generator=generator,
            noise=noise, inpaint=inpaint, sampler=self.sampler, step_noise=step_noise,
        )

    def sample_to_joints(
        self, features: torch.Tensor, denormalize: Callable[[torch.Tensor], torch.Tensor],
        abs_3d: bool,
    ) -> torch.Tensor:
        """Denormalized features → [B, T, 22, 3] joints (recover_from_ric)."""
        return recover_from_ric(denormalize(features), 22, abs_3d=abs_3d)
