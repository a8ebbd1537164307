"""Classifier-free guidance as a batch-doubled denoiser wrapper.

Counterpart of condmdi_tpu/models/cfg.py:
  out = out_uncond + text_scale * (out_cond − out_uncond)
with the cond and uncond branches concatenated into one forward of twice
the batch (`y["uncond"]` masks the text of the second half), and
obs_x0/obs_mask passed through both.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def make_cfg_denoiser(
    apply_fn: Callable[..., torch.Tensor],
    y: dict[str, Any],
    text_scale: float,
    obs_x0: Optional[torch.Tensor] = None,
    obs_mask: Optional[torch.Tensor] = None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """denoise_fn(x, t) applying CFG through one batch-doubled forward.

    `apply_fn(x, t, y, obs_x0=..., obs_mask=...)` is the bare model forward.
    """

    def denoise(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        force = torch.cat([
            torch.zeros(B, dtype=torch.bool, device=x.device),
            torch.ones(B, dtype=torch.bool, device=x.device),
        ])
        y2 = dict(y)
        # duplicate per-sample conditioning rows
        for k, v in y.items():
            if isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == B:
                y2[k] = torch.cat([v, v], dim=0)
        y2["uncond"] = force
        kw = {}
        if obs_x0 is not None:
            kw["obs_x0"] = torch.cat([obs_x0, obs_x0], dim=0)
            kw["obs_mask"] = torch.cat([obs_mask, obs_mask], dim=0)
        out = apply_fn(x2, t2, y2, **kw)
        out_cond, out_uncond = out[:B], out[B:]
        return out_uncond + text_scale * (out_cond - out_uncond)

    return denoise


def make_plain_denoiser(
    apply_fn: Callable[..., torch.Tensor],
    y: dict[str, Any],
    obs_x0: Optional[torch.Tensor] = None,
    obs_mask: Optional[torch.Tensor] = None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Bare denoiser closure without CFG (guidance_param == 1)."""

    def denoise(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        kw = {}
        if obs_x0 is not None:
            kw = {"obs_x0": obs_x0, "obs_mask": obs_mask}
        return apply_fn(x, t, y, **kw)

    return denoise
