"""Global RNG seeding (reference utils/fixseed.py:6).

Counterpart of condmdi_tpu/utils/seed.py. The data layer draws its crop
offsets and caption choices from the GLOBAL numpy RNG, and the diversity and
multimodality metrics draw their pairs from it too, so an entry point that
wants reproducible runs pins the globals, exactly as every reference
train/eval script does via fixseed(args.seed). The port also seeds torch's
default generator; numpy's and Python's streams are the JAX package's.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
