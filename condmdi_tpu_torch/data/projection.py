"""Random-projection data transform (GMD's invertible 263×263 mixing).

Counterpart of condmdi_tpu/data/projection.py (reference dataset.py:503
init_random_projection / :531 random_projection / :536
inv_random_projection): a fixed invertible matrix whose first 3 rows (rot
vel, x vel, z vel) are scaled by `scale`, normalised by
sqrt(263 - 3 + 3·scale²). The shipped matrices (rand_proj.npy,
inv_rand_proj.npy) load where present; otherwise a pair is made from
`default_rng(seed)`, the same draws as the JAX package, and saved when a
directory is named. Plain numpy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from condmdi_tpu_torch.utils.assets import find_assets_dir


class RandomProjection:
    def __init__(self, proj: np.ndarray, inv_proj: np.ndarray):
        self.proj = proj.astype(np.float32)
        self.inv_proj = inv_proj.astype(np.float32)

    @classmethod
    def load_or_create(cls, save_at: Optional[str] = None, scale: float = 10.0, dim: int = 263,
                       seed: int = 0) -> "RandomProjection":
        """From `save_at` where it holds the pair (else made and saved there), or
        without it from the assets directory (else made, not saved)."""
        if save_at:
            search = [save_at]
        else:
            assets = find_assets_dir()
            search = [str(assets)] if assets is not None else []
        for d in search:
            p, ip = Path(d) / "rand_proj.npy", Path(d) / "inv_rand_proj.npy"
            if p.exists() and ip.exists():
                return cls(np.load(p), np.load(ip))
        rng = np.random.default_rng(seed)
        m = rng.normal(0.0, 1.0, size=(dim, dim))
        m[[0, 1, 2], :] *= scale
        m = m / np.sqrt(dim - 3 + 3 * scale**2)
        inv = np.linalg.inv(m)
        if save_at:
            Path(save_at).mkdir(parents=True, exist_ok=True)
            np.save(Path(save_at) / "rand_proj.npy", m)
            np.save(Path(save_at) / "inv_rand_proj.npy", inv)
        return cls(m, inv)

    def __call__(self, motion: np.ndarray) -> np.ndarray:
        return motion @ self.proj

    def inverse(self, data: np.ndarray) -> np.ndarray:
        return data @ self.inv_proj
