"""Timestep samplers: uniform, and loss-second-moment importance sampling.

Counterpart of condmdi_tpu/diffusion/resample.py. `LossAwareState` keeps a
history of the last 10 losses per timestep; once every timestep has a full
history it samples t with weights proportional to sqrt(E[loss^2]), mixed
with a uniform share of 0.001, and uniformly before that. Draws come from a
`torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def uniform_sample_t(batch: int, num_timesteps: int, generator: Optional[torch.Generator] = None,
                     device: str | torch.device = "cpu"):
    """(t [B] int64, weights [B] = 1)."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator, device=device)
    return t, torch.ones((batch,), dtype=torch.float32, device=device)


@dataclass
class LossAwareState:
    """Rolling per-timestep loss history for importance sampling."""

    history: torch.Tensor  # [T, K] float32
    counts: torch.Tensor  # [T] int64
    history_per_term: int = 10
    uniform_prob: float = 0.001

    @classmethod
    def create(cls, num_timesteps: int, history_per_term: int = 10, uniform_prob: float = 0.001,
               device: str | torch.device = "cpu"):
        return cls(torch.zeros((num_timesteps, history_per_term), dtype=torch.float32,
                               device=device),
                   torch.zeros((num_timesteps,), dtype=torch.long, device=device),
                   history_per_term, uniform_prob)

    def weights(self) -> torch.Tensor:
        """Per-timestep sampling weights; uniform until every history is full."""
        n = self.history.shape[0]
        warmed = bool((self.counts == self.history_per_term).all())
        if not warmed:
            return torch.full((n,), 1.0 / n, dtype=torch.float32, device=self.history.device)
        w = torch.sqrt(torch.mean(self.history**2, dim=-1))
        w = w / w.sum().clamp(min=1e-12)
        return w * (1 - self.uniform_prob) + self.uniform_prob / n

    def sample(self, batch: int, generator: Optional[torch.Generator] = None):
        """(t [B], importance weights [B] = 1 / (T p(t)))."""
        w = self.weights()
        t = torch.multinomial(w, batch, replacement=True, generator=generator)
        return t, (1.0 / (w.shape[0] * w[t])).float()

    def update(self, ts: torch.Tensor, losses: torch.Tensor) -> "LossAwareState":
        """Record per-sample losses at their timesteps, in batch order: a full
        history shifts left and appends, an open one fills its next slot."""
        K = self.history_per_term
        hist, cnt = self.history.clone(), self.counts.clone()
        for t, loss in zip(ts.tolist(), losses.detach().float().cpu().tolist()):
            if int(cnt[t]) == K:
                hist[t] = torch.cat([hist[t, 1:], hist.new_tensor([loss])])
            else:
                hist[t, int(cnt[t])] = loss
                cnt[t] += 1
        return LossAwareState(hist, cnt, self.history_per_term, self.uniform_prob)

    def state_dict(self) -> dict:
        return {"history": self.history, "counts": self.counts}

    def load_state_dict(self, d: dict) -> None:
        self.history = d["history"].to(self.history.device)
        self.counts = d["counts"].to(self.counts.device)


def create_named_schedule_sampler(name: str, num_timesteps: int,
                                  device: str | torch.device = "cpu"):
    """'uniform' → None (use uniform_sample_t); 'loss-second-moment' → a LossAwareState."""
    if name == "uniform":
        return None
    if name == "loss-second-moment":
        return LossAwareState.create(num_timesteps, device=device)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
