"""Distribution losses and masked MSE losses in the [B, T, F] layout.

Counterpart of condmdi_tpu/diffusion/losses.py, function for function. The
masked losses keep the JAX package's normalisation:
  masked_l2          : sum(err^2 * mask) / (sum(mask) * F)
  masked_l2_weighted : sum(err^2 * w_norm * tw * mask) / sum(mask)
    where w_norm = weights / weights.sum(features) per sample.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def sum_flat(x: torch.Tensor) -> torch.Tensor:
    """Sum over all non-batch dimensions."""
    return x.sum(dim=tuple(range(1, x.ndim)))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL between two diagonal Gaussians (any broadcastable shapes; floats allowed)."""
    logvar1, logvar2 = (torch.as_tensor(v, dtype=torch.float32) if not isinstance(v, torch.Tensor)
                        else v for v in (logvar1, logvar2))
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to 1/255 bins ([-1, 1] data)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(
        x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta)
    )


def masked_l2(a: torch.Tensor, b: torch.Tensor, time_mask: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE over valid frames [B]: a, b [B, T, F]; time_mask [B, T]."""
    m = time_mask.to(a.dtype)[..., None]
    loss = sum_flat((a - b) ** 2 * m)
    n = sum_flat(m) * a.shape[-1]  # valid frames x feature count
    return loss / n.clamp(min=1.0)


def masked_l2_weighted(
    a: torch.Tensor,
    b: torch.Tensor,
    mask: torch.Tensor,
    weights: torch.Tensor,
    time_weights: Optional[torch.Tensor] = None,
    over_keyframes: bool = False,
) -> torch.Tensor:
    """Feature-weighted masked MSE, per sample [B].

    a, b [B, T, F]; mask [B, T] (a time mask), or [B, T, F] when
    `over_keyframes`; weights [B, 1, F], normalised to sum 1 over F;
    time_weights [B, T, F] or None.
    """
    loss = (a - b) ** 2
    loss = loss * (weights / weights.sum(dim=(1, 2), keepdim=True))
    if time_weights is not None:
        loss = loss * time_weights
    m = mask.to(a.dtype) if over_keyframes else mask.to(a.dtype)[..., None]
    loss = sum_flat(loss * m)
    # over keyframes the denominator is the sum over the full [B, T, F] mask
    n = sum_flat(m) if over_keyframes else mask.to(a.dtype).sum(dim=1)
    return loss / n.clamp(min=1e-8)
