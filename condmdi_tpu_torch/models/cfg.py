"""Classifier-free guidance as a batch-doubled denoiser wrapper.

Counterpart of condmdi_tpu/models/cfg.py:
  out = out_uncond + text_scale * (out_cond − out_uncond)
with the cond and uncond branches concatenated into one forward of twice
the batch (`y["uncond"]` masks the text of the second half), and
obs_x0/obs_mask passed through both. The denoisers hold their conditioning
in buffers that a captured CUDA graph keeps (sampling/pipeline.py), and each
request's values are copied into them (`load`). `mask_cond` is that masking,
shared by the denoisers, with the training-time condition dropout.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def mask_cond(cond: torch.Tensor, force_mask, cond_mask_prob: float = 0.0,
              draws=None) -> torch.Tensor:
    """Zero the condition: everywhere for `force_mask=True`, on the rows of a [B]
    bool mask; then, in training (`draws` given, a `layers.TrainDraws`), on each
    row with probability `cond_mask_prob` (one Bernoulli keep draw per row)."""
    if isinstance(force_mask, bool):
        if force_mask:
            return torch.zeros_like(cond)
    else:
        cond = torch.where(force_mask[:, None], torch.zeros_like(cond), cond)
    if draws is not None and cond_mask_prob > 0.0:
        keep = draws.keep((cond.shape[0], 1), 1.0 - cond_mask_prob, cond.device)
        cond = cond * keep.to(cond.dtype)
    return cond


def _batch_rows(v, B: int) -> bool:
    return isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == B


def conditioning_signature(y: dict[str, Any], obs_x0=None, obs_mask=None) -> tuple:
    """What a denoiser's buffers are built for: each tensor's shape, dtype and
    device, each other value of y as it is (a captured graph keeps it)."""

    def sig(v):
        if isinstance(v, torch.Tensor):
            return ("tensor", tuple(v.shape), v.dtype, v.device)
        return ("value", v)

    return (tuple((k, sig(v)) for k, v in sorted(y.items())),
            None if obs_x0 is None else (sig(obs_x0), sig(obs_mask)))


def _doubled_in(held: torch.Tensor, fresh: torch.Tensor, what: str) -> None:
    """[fresh; fresh] written into `held`, which must be that shape already."""
    if (2 * fresh.shape[0],) + tuple(fresh.shape[1:]) != tuple(held.shape) \
            or fresh.dtype != held.dtype:
        raise ValueError(f"{what}: {tuple(fresh.shape)} {fresh.dtype} does not fill the "
                         f"denoiser's doubled buffer {tuple(held.shape)} {held.dtype}")
    torch.cat([fresh, fresh], dim=0, out=held)


def _copy_in(held, fresh, what):
    if not isinstance(held, torch.Tensor):
        if held is not fresh and held != fresh:
            raise ValueError(f"{what}: {fresh!r} where the denoiser was built for {held!r}")
        return
    if fresh.shape != held.shape or fresh.dtype != held.dtype:
        raise ValueError(f"{what}: {tuple(fresh.shape)} {fresh.dtype} where the denoiser's "
                         f"buffer is {tuple(held.shape)} {held.dtype}")
    held.copy_(fresh)


class CfgDenoiser:
    """denoise_fn(x, t) applying CFG through one batch-doubled forward.

    `apply_fn(x, t, y, obs_x0=..., obs_mask=...)` is the bare model forward. The
    conditioning lives in buffers of the doubled batch that a captured graph
    keeps: y's rows of x's batch (doubled), y's other tensors, the uncond
    mask (False for the first half, True for the second), obs_x0 and obs_mask
    (doubled). They are built at the first call, when x's batch is known, and
    `load` copies another request's values into them.
    """

    def __init__(self, apply_fn: Callable[..., torch.Tensor], y: dict[str, Any],
                 text_scale: float, obs_x0: Optional[torch.Tensor] = None,
                 obs_mask: Optional[torch.Tensor] = None):
        self.apply_fn, self.text_scale = apply_fn, text_scale
        self.y2: Optional[dict[str, Any]] = None
        self.obs: dict[str, torch.Tensor] = {}
        self.load(y, obs_x0, obs_mask)

    def load(self, y: dict[str, Any], obs_x0=None, obs_mask=None) -> None:
        """A request's conditioning into the buffers (kept until they exist)."""
        if self.y2 is None:
            self._pending = (y, obs_x0, obs_mask)
            return
        B = self.B
        for k, v in y.items():
            if _batch_rows(v, B):
                _doubled_in(self.y2[k], v, f"y[{k!r}]")
            elif k != "uncond":
                _copy_in(self.y2[k], v, f"y[{k!r}]")
        if (obs_x0 is None) != (not self.obs):
            raise ValueError("the denoiser was built with(out) obs_x0")
        if obs_x0 is not None:
            _doubled_in(self.obs["obs_x0"], obs_x0, "obs_x0")
            _doubled_in(self.obs["obs_mask"], obs_mask, "obs_mask")

    def _build(self, B: int, device) -> None:
        y, obs_x0, obs_mask = self._pending
        self.B, self._pending = B, None
        self.y2 = {k: (torch.cat([v, v], dim=0) if _batch_rows(v, B)
                       else v.clone() if isinstance(v, torch.Tensor) else v)
                   for k, v in y.items()}
        # duplicate per-sample conditioning rows; the second half is unconditioned
        self.y2["uncond"] = torch.cat([
            torch.zeros(B, dtype=torch.bool, device=device),
            torch.ones(B, dtype=torch.bool, device=device),
        ])
        if obs_x0 is not None:
            self.obs = {"obs_x0": torch.cat([obs_x0, obs_x0], dim=0),
                        "obs_mask": torch.cat([obs_mask, obs_mask], dim=0)}

    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        if self.y2 is None:
            self._build(B, x.device)
        elif B != self.B:
            raise ValueError(f"x has batch {B}; the denoiser's buffers hold {self.B}")
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        out = self.apply_fn(x2, t2, self.y2, **self.obs)
        out_cond, out_uncond = out[:B], out[B:]
        return out_uncond + self.text_scale * (out_cond - out_uncond)


class PlainDenoiser:
    """Bare denoiser without CFG (guidance_param == 1), its conditioning in
    buffers a captured graph keeps (y's tensors and obs_x0/obs_mask, copies of
    the first request's); `load` copies another request's values in."""

    def __init__(self, apply_fn: Callable[..., torch.Tensor], y: dict[str, Any],
                 obs_x0: Optional[torch.Tensor] = None,
                 obs_mask: Optional[torch.Tensor] = None):
        self.apply_fn = apply_fn
        self.y = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in y.items()}
        self.obs = {} if obs_x0 is None else {"obs_x0": obs_x0.clone(),
                                              "obs_mask": obs_mask.clone()}

    def load(self, y: dict[str, Any], obs_x0=None, obs_mask=None) -> None:
        for k, v in y.items():
            _copy_in(self.y[k], v, f"y[{k!r}]")
        if (obs_x0 is None) != (not self.obs):
            raise ValueError("the denoiser was built with(out) obs_x0")
        if obs_x0 is not None:
            _copy_in(self.obs["obs_x0"], obs_x0, "obs_x0")
            _copy_in(self.obs["obs_mask"], obs_mask, "obs_mask")

    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.apply_fn(x, t, self.y, **self.obs)


def make_cfg_denoiser(
    apply_fn: Callable[..., torch.Tensor],
    y: dict[str, Any],
    text_scale: float,
    obs_x0: Optional[torch.Tensor] = None,
    obs_mask: Optional[torch.Tensor] = None,
) -> CfgDenoiser:
    """denoise_fn(x, t) applying CFG through one batch-doubled forward."""
    return CfgDenoiser(apply_fn, y, text_scale, obs_x0=obs_x0, obs_mask=obs_mask)


def make_plain_denoiser(
    apply_fn: Callable[..., torch.Tensor],
    y: dict[str, Any],
    obs_x0: Optional[torch.Tensor] = None,
    obs_mask: Optional[torch.Tensor] = None,
) -> PlainDenoiser:
    """Bare denoiser without CFG (guidance_param == 1)."""
    return PlainDenoiser(apply_fn, y, obs_x0=obs_x0, obs_mask=obs_mask)
