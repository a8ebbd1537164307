"""Sinusoidal tables and the timestep MLP.

Counterpart of condmdi_tpu/models/embeddings.py: the transformer sin/cos
table (which doubles as the timestep-embedding input), the guided-diffusion
timestep embedding, TimestepEmbedder (pe[t] → Dense → SiLU → Dense),
PositionalEncoding and EmbedAction. The port samples only, so
PositionalEncoding has no dropout: Flax applies none with
`deterministic=True`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from condmdi_tpu_torch.models.layers import Dense, ParamModule


def sinusoidal_table(max_len: int, d_model: int, dtype=np.float32) -> np.ndarray:
    """Classic transformer sin/cos table, shape (max_len, d_model)."""
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    position = np.arange(0, max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Guided-diffusion sinusoidal timestep embedding: [cos | sin] halves."""
    half = dim // 2
    freqs = torch.exp(
        -np.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """t -> MLP(pe[t]): Dense(D, D) → SiLU → Dense(D, D). Output [B, D]."""

    def __init__(self, latent_dim: int, max_len: int = 5000, *, device=None, dtype=None):
        super().__init__()
        self.register_buffer(
            "pe", torch.as_tensor(sinusoidal_table(max_len, latent_dim), device=device),
            persistent=False,
        )
        self.fc1 = Dense(latent_dim, latent_dim, device=device, dtype=dtype)
        self.fc2 = Dense(latent_dim, latent_dim, device=device, dtype=dtype)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        h = self.pe[timesteps.long()].to(self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(h)))


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table over the time axis of [B, T, D] input."""

    def __init__(self, d_model: int, max_len: int = 5000, *, device=None):
        super().__init__()
        self.register_buffer(
            "pe", torch.as_tensor(sinusoidal_table(max_len, d_model), device=device),
            persistent=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[: x.shape[1]].to(x.dtype)


class EmbedAction(ParamModule):
    """Action id → learned embedding row; the table is N(0, 1) at init."""

    def __init__(self, num_actions: int, latent_dim: int, *, device=None, dtype=None):
        super().__init__()
        self.action_embedding = nn.Parameter(
            torch.empty((num_actions, latent_dim), device=device, dtype=dtype)
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        table = self.action_embedding
        table.copy_(torch.randn(table.shape, generator=generator, dtype=torch.float32))

    def forward(self, action_ids: torch.Tensor) -> torch.Tensor:
        return self.action_embedding[action_ids.reshape(-1).long()]
