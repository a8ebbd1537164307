"""Tensor layout conversion at the legacy-API boundary.

Counterpart of condmdi_tpu/utils/layout.py (plain numpy, copied so that the
port imports nothing of the JAX package). Internal layout: [B, T, F]
(features last). Reference/PyTorch layout: [B, F(njoints), 1(nfeats), T]
(tensors.py:61, mdm.py:241). These helpers convert at checkpoint, CLI and
file boundaries only.
"""

from __future__ import annotations

import numpy as np


def from_reference_layout(x: np.ndarray) -> np.ndarray:
    """[B, F, 1, T] (or [B, F, nfeats, T]) → [B, T, F*nfeats]."""
    b, f, nf, t = x.shape
    return np.moveaxis(x.reshape(b, f * nf, t), 1, 2)


def to_reference_layout(x: np.ndarray, nfeats: int = 1) -> np.ndarray:
    """[B, T, F] → [B, F/nfeats, nfeats, T]."""
    b, t, f = x.shape
    return np.moveaxis(x, 1, 2).reshape(b, f // nfeats, nfeats, t)
