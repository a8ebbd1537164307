"""Curated fixed-dataset fixtures for reproducible sampling runs.

Counterpart of condmdi_tpu/data/fixed_dataset.py (`conditional
--use_fixed_dataset`): an .npz of motions, lengths, time masks and captions,
saved once and reloaded bit for bit; `make_synthetic_fixture` makes one
deterministically through the synthetic dataset where no curated file exists.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

DEFAULT_PATH = Path("save/fixed_dataset/humanml_abs3d.npz")


def save_fixed_dataset(batch: dict, path: str | Path = DEFAULT_PATH) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path,
        motion=batch["motion"],
        lengths=batch["lengths"],
        time_mask=batch["time_mask"],
        text=np.asarray(batch.get("text", []), dtype=object),
    )
    return path


def load_fixed_dataset(num_samples: int, path: str | Path = DEFAULT_PATH,
                       text_encoder=None) -> dict:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"fixed dataset not found at {path}")
    data = np.load(path, allow_pickle=True)
    n = min(num_samples, len(data["motion"]))
    batch = {
        "motion": data["motion"][:n],
        "lengths": data["lengths"][:n],
        "time_mask": data["time_mask"][:n],
        "text": list(data["text"][:n]),
    }
    if text_encoder is not None:
        batch["text_embed"] = text_encoder.encode(batch["text"])
    return batch


def make_synthetic_fixture(path: str | Path = DEFAULT_PATH, n: int = 8, T: int = 196,
                           seed: int = 1234, device: str | torch.device = "cuda") -> Path:
    """Deterministic stand-in fixture built through the real codec on `device`."""
    from condmdi_tpu_torch.data.dataset import DatasetConfig, SyntheticMotionDataset, collate

    ds = SyntheticMotionDataset(DatasetConfig(max_motion_length=T, abs_3d=True), size=n,
                                seed=seed, device=device)
    batch = collate([ds[i] for i in range(n)], T)
    return save_fixed_dataset(batch, path)
