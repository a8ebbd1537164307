"""Beta schedules, timestep respacing, and the precomputed schedule.

Counterpart of condmdi_tpu/diffusion/schedule.py. Respacing is folded into
one `DiffusionSchedule` at construction: the respaced betas are derived as
the reference's SpacedDiffusion does, and `timestep_map` turns a respaced
step into the original-process timestep fed to the model (`model_t`). All
coefficients are computed in float64 numpy and stored as float32 tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np
import torch


def get_named_beta_schedule(
    schedule_name: str, num_diffusion_timesteps: int, scale_betas: float = 1.0
) -> np.ndarray:
    """'linear' (Ho et al., rescaled for any step count) or 'cosine'."""
    if schedule_name == "linear":
        scale = scale_betas * 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999) -> np.ndarray:
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def space_timesteps(num_timesteps: int, section_counts) -> list[int]:
    """The retained subset of timesteps ('ddimN' or per-section counts), sorted."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return sorted(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken = []
        for _ in range(section_count):
            taken.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken
        start_idx += size
    return sorted(all_steps)


@dataclass(frozen=True)
class DiffusionSchedule:
    """All precomputed diffusion coefficients, indexed by (respaced) step."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    # FIXED_LARGE variance pair (posterior_variance[1], betas[1:])
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    log_betas: torch.Tensor
    # time-weighted-loss helpers
    ratio_eps: torch.Tensor
    snr_weight: torch.Tensor
    # respacing: retained original-step index per respaced step
    timestep_map: torch.Tensor
    num_timesteps: int
    original_num_steps: int
    rescale_timesteps: bool

    @classmethod
    def create(
        cls,
        betas: np.ndarray,
        use_timesteps=None,
        rescale_timesteps: bool = False,
        device: str | torch.device = "cpu",
    ) -> "DiffusionSchedule":
        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        original_num_steps = len(betas)

        if use_timesteps is not None:
            use = set(int(u) for u in use_timesteps)
            base_alphas_cumprod = np.cumprod(1.0 - betas)
            last = 1.0
            new_betas, tmap = [], []
            for i, ac in enumerate(base_alphas_cumprod):
                if i in use:
                    new_betas.append(1 - ac / last)
                    last = ac
                    tmap.append(i)
            betas = np.array(new_betas, dtype=np.float64)
            timestep_map = np.array(tmap, dtype=np.int64)
        else:
            timestep_map = np.arange(original_num_steps, dtype=np.int64)

        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        posterior_log_variance_clipped = np.log(
            np.append(posterior_variance[1], posterior_variance[1:])
        )

        c = np.zeros_like(betas)
        c[1:] = (1 - alphas_cumprod[:-1]) / (1 - alphas_cumprod[1:]) * np.sqrt(alphas[1:])
        d = np.zeros_like(betas)
        d[1:] = np.sqrt(alphas_cumprod[:-1]) / (1 - alphas_cumprod[1:]) * betas[1:]
        e = c + d
        f = d * np.sqrt(1.0 - alphas_cumprod) / np.sqrt(alphas_cumprod)
        ratio_eps = f / (e + f + 1e-8)

        fixed_large_var = np.append(posterior_variance[1], betas[1:])

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            alphas_cumprod_next=f32(alphas_cumprod_next),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
            posterior_mean_coef1=f32(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            ),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
            ),
            fixed_large_variance=f32(fixed_large_var),
            fixed_large_log_variance=f32(np.log(fixed_large_var)),
            log_betas=f32(np.log(betas)),
            ratio_eps=f32(ratio_eps),
            snr_weight=f32(np.sqrt(alphas_cumprod) / np.sqrt(1.0 - alphas_cumprod)),
            timestep_map=torch.as_tensor(timestep_map, device=device),
            num_timesteps=int(len(betas)),
            original_num_steps=int(original_num_steps),
            rescale_timesteps=bool(rescale_timesteps),
        )

    def to(self, device: str | torch.device) -> "DiffusionSchedule":
        """The same schedule with every tensor on `device`."""
        kw = {}
        for fld in fields(self):
            v = getattr(self, fld.name)
            kw[fld.name] = v.to(device) if isinstance(v, torch.Tensor) else v
        return DiffusionSchedule(**kw)

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def extract(self, arr: torch.Tensor, t: torch.Tensor, broadcast_ndim: int) -> torch.Tensor:
        """arr[t] reshaped to broadcast over a rank-`broadcast_ndim` batch."""
        out = arr[t]
        return out.reshape(out.shape + (1,) * (broadcast_ndim - out.ndim))

    def model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Respaced step index → original-process timestep fed to the model."""
        new_t = self.timestep_map[t]
        if self.rescale_timesteps:
            return new_t.float() * (1000.0 / self.original_num_steps)
        return new_t
