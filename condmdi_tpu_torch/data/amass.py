"""AMASS dataset (NeMF's 764-dim field representation) and its layout masks.

Counterpart of condmdi_tpu/data/amass.py (reference
data_loaders/amass_utils.py: the MAT_POS / ROTMAT / HEIGHT / ROT6D / ROT
joint-to-feature matrices over the 764-dim field vector; and
data_loaders/amass/data/dataset.py:39: dict-of-fields tensors, per-field
mean/std normalisation, clip length 128). Plain numpy, the same arrays.

764-dim layout (the field order of the concatenated item):
  [0:3]      trans
  [3:219]    rotmat      24×3×3
  [219:291]  pos         24×3
  [291:363]  velocity    24×3
  [363:371]  contacts    8
  [371:395]  height      24
  [395:398]  root_vel    3
  [398:470]  global_vel  24×3
  [470:614]  global_xform 24×6
  [614:620]  root_orient 6
  [620:764]  rot6d       24×6
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

AMASS_DIM = 764
AMASS_JOINTS = 24
AMASS_CLIP_LENGTH = 128


def _build_masks():
    MAT_POS = np.zeros((24, 764), dtype=bool)
    MAT_POS[0, :3] = True  # the root position is trans
    for j in range(24):
        ub = 3 + 24 * 3 * 3 + 3 * (j + 1)
        MAT_POS[j, ub - 3: ub] = True

    MAT_ROTMAT = np.zeros((24, 764), dtype=bool)
    for j in range(24):
        ub = 3 + 9 * (j + 1)
        MAT_ROTMAT[j, ub - 9: ub] = True

    MAT_HEIGHT = np.zeros((24, 764), dtype=bool)
    for j in range(24):
        ub = 3 + 24 * 9 + 24 * 3 + 24 * 3 + 8 + (j + 1)
        MAT_HEIGHT[j, ub - 1: ub] = True

    MAT_ROT6D = np.zeros((24, 764), dtype=bool)
    base = 3 + 24 * 9 + 24 * 3 + 24 * 3 + 8 + 24 + 3 + 24 * 3 + 24 * 6 + 6
    for j in range(24):
        ub = base + 6 * (j + 1)
        MAT_ROT6D[j, ub - 6: ub] = True

    MAT_ROT = np.zeros((24, 764), dtype=bool)
    lb0 = 3 + 24 * 9 + 24 * 3 + 24 * 3 + 8 + 24 + 3 + 24 * 3 + 24 * 6
    MAT_ROT[0, lb0: lb0 + 6] = True  # root_orient
    for j in range(24):
        ub = 3 + 24 * 9 + 24 * 3 + 24 * 3 + 8 + 24 + 3 + 24 * 3 + (j + 1) * 6
        MAT_ROT[j, ub - 6: ub] = True  # global_xform

    return MAT_POS, MAT_ROTMAT, MAT_HEIGHT, MAT_ROT6D, MAT_ROT


MAT_POS, MAT_ROTMAT, MAT_HEIGHT, MAT_ROT6D, MAT_ROT = _build_masks()


def amass_joint_to_full_mask(joint_mask: np.ndarray, mode: str = "all") -> np.ndarray:
    """[..., T, 24] bool → [..., T, 764] (reference joint_to_full_mask_amass,
    editing_util.py:14): pos, rotmat and rot always; height and rot6d too for 'all'."""
    mats = [MAT_POS, MAT_ROTMAT, MAT_ROT]
    if mode == "all":
        mats += [MAT_HEIGHT, MAT_ROT6D]
    mat = np.stack(mats).any(axis=0).astype(np.float32)
    return (np.asarray(joint_mask).astype(np.float32) @ mat) > 0.5


FIELD_SLICES = {
    "trans": (0, 3),
    "rotmat": (3, 219),
    "pos": (219, 291),
    "velocity": (291, 363),
    "contacts": (363, 371),
    "height": (371, 395),
    "root_vel": (395, 398),
    "global_vel": (398, 470),
    "global_xform": (470, 614),
    "root_orient": (614, 620),
    "rot6d": (620, 764),
}

# NeMF's on-disk field order, the 764-d layout that FIELD_SLICES and the MAT_*
# masks index (the reference concatenates in glob() order, which depends on the
# file system; here it is pinned). The disk keys 'angular' and 'velocity' go to
# 291:363 and 398:470 ('velocity' and 'global_vel' in FIELD_SLICES).
AMASS_FIELD_ORDER = (
    "trans", "rotmat", "pos", "angular", "contacts", "height",
    "root_vel", "velocity", "global_xform", "root_orient", "rot6d",
)


class AMASSDataset:
    """File-backed AMASS: NeMF's preprocessed per-field .pt tensors, read with
    torch.load, normalised by the per-field mean/std files."""

    def __init__(self, root_dir: str = "dataset/amass/generative", split: str = "train"):
        import torch

        self.root = Path(root_dir)
        ds_dir = self.root / split
        if not ds_dir.is_dir():
            raise FileNotFoundError(f"AMASS data not found at {ds_dir}")
        self.ds = {}
        for f in sorted(ds_dir.glob("*.pt")):
            self.ds[f.name.split("-")[0]] = torch.load(f, map_location="cpu")
        if "trans" not in self.ds:
            raise FileNotFoundError("AMASS field tensors missing: ['trans']")
        self.field_order = [k for k in AMASS_FIELD_ORDER if k in self.ds]
        self.clip_length = AMASS_CLIP_LENGTH
        self.mean = torch.load(self.root / "mean-male-128-30fps.pt", map_location="cpu")
        self.std = torch.load(self.root / "std-male-128-30fps.pt", map_location="cpu")

    def __len__(self):
        return len(self.ds["trans"])

    def __getitem__(self, idx: int) -> dict:
        pieces = []
        for key in self.field_order:
            v = (self.ds[key][idx] - self.mean[key][0]) / self.std[key][0]
            pieces.append(np.asarray(v).reshape(self.clip_length, -1))
        motion = np.concatenate(pieces, axis=-1).astype(np.float32)
        return dict(motion=motion, length=self.clip_length, caption="", tokens=[])


class SyntheticAMASSDataset:
    """Random-field AMASS stand-in: the JAX package's draws (764 dims, clip 128)."""

    def __init__(self, size: int = 16, seed: int = 0, clip_length: int = AMASS_CLIP_LENGTH):
        rng = np.random.default_rng(seed)
        self.items = [rng.standard_normal((clip_length, AMASS_DIM)).astype(np.float32) * 0.5
                      for _ in range(size)]
        self.clip_length = clip_length

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return dict(motion=self.items[idx], length=self.clip_length, caption="", tokens=[])
