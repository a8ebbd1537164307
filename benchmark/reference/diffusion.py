"""The Gaussian diffusion the cells sample and train with, plain float64 → float32.

The cosine schedule of Nichol & Dhariwal (arXiv 2102.09672, eq. 17, betas
capped at 0.999), the model predicting x0 (MDM, CondMDI), the posterior
q(x_{t-1} | x_t, x0) with its "fixed small" variance (log-variance clipped at
step 1's), ancestral DDPM sampling, and classifier-free guidance as
out_uncond + s · (out_cond − out_uncond).
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Schedule:
    def __init__(self, steps: int, device):
        ab = lambda s: math.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2  # noqa: E731
        betas = np.array([min(1 - ab((i + 1) / steps) / ab(i / steps), 0.999)
                          for i in range(steps)], dtype=np.float64)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        var = betas * (1.0 - acp_prev) / (1.0 - acp)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.steps = steps
        self.sqrt_acp = f32(np.sqrt(acp))
        self.sqrt_1m_acp = f32(np.sqrt(1.0 - acp))
        self.coef1 = f32(betas * np.sqrt(acp_prev) / (1.0 - acp))
        self.coef2 = f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp))
        self.log_var = f32(np.log(np.append(var[1], var[1:])))

    def q_sample(self, x0, t, noise):
        return self.sqrt_acp[t][:, None, None] * x0 + self.sqrt_1m_acp[t][:, None, None] * noise

    def ddpm_step(self, x, x0, t: int, z):
        mean = self.coef1[t] * x0 + self.coef2[t] * x
        return mean + (math.exp(0.5 * float(self.log_var[t])) * z if t > 0 else 0.0)


def cfg_denoise(model, x, t: int, text, scale: float, **obs):
    """One CFG forward: the conditioned and unconditioned rows in one batch."""
    B = x.shape[0]
    tt = torch.full((2 * B,), t, dtype=torch.long, device=x.device)
    uncond = torch.arange(2 * B, device=x.device) >= B
    obs2 = {k: torch.cat([v, v]) for k, v in obs.items()}
    out = model(torch.cat([x, x]), tt, torch.cat([text, text]), uncond, **obs2)
    return out[B:] + scale * (out[:B] - out[B:])


@torch.no_grad()
def ddpm_sample(model, sched: Schedule, x_T, noises, text, scale: float, **obs):
    """The 1000-step ancestral sampler from x_T; `noises(i)` is step i's noise."""
    x = x_T
    for i, t in enumerate(range(sched.steps - 1, -1, -1)):
        x0 = cfg_denoise(model, x, t, text, scale, **obs)
        x = sched.ddpm_step(x, x0, t, noises(i))
    return x
