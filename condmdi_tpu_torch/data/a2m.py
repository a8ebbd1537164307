"""Action-to-motion datasets: HumanAct12 / UESTC.

Counterpart of condmdi_tpu/data/a2m.py (reference data_loaders/a2m/{dataset.py,
humanact12poses.py, uestc.py}): action-conditioned pose datasets in the rot6d
25×6 representation (24 SMPL joints + 1 translation row), fixed 60-frame clips,
per-action labels, numpy items on the host.

File-backed loading needs the reference's prepared pickles
(dataset/HumanAct12Poses/humanact12poses.pkl etc.) and raises
FileNotFoundError without them; `SyntheticA2MDataset` makes the JAX package's
synthetic clips (the same default_rng draws in the same order, so a seed gives
the same items bit for bit). The crops draw from the global np.random, as in
the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

HUMANACT12_ACTIONS = [
    "warm_up", "walk", "run", "jump", "drink", "lift_dumbbell", "sit", "eat",
    "turn steering wheel", "phone", "boxing", "throw",
]

A2M_NJOINTS = 25  # 24 rot6d joints + 1 translation row
A2M_NFEATS = 6
A2M_NUM_FRAMES = 60


def axis_angle_poses_to_rot6d(poses: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """[T, 24, 3] axis-angle + [T, 3] translation → [T, 25, 6] a2m features
    (float32 on the CPU)."""
    import torch

    from condmdi_tpu_torch.geometry.rotations import axis_angle_to_matrix, matrix_to_rotation_6d

    mats = axis_angle_to_matrix(torch.as_tensor(np.asarray(poses, np.float32)))
    r6 = matrix_to_rotation_6d(mats).numpy()  # [T, 24, 6]
    trans_row = np.zeros((poses.shape[0], 1, 6), np.float32)
    trans_row[:, 0, :3] = trans
    return np.concatenate([r6, trans_row], axis=1).astype(np.float32)


class HumanAct12Dataset:
    """File-backed HumanAct12 (needs humanact12poses.pkl)."""

    def __init__(self, datapath: str = "dataset/HumanAct12Poses", split: str = "train",
                 num_frames: int = A2M_NUM_FRAMES):
        import pickle

        pkl = Path(datapath) / "humanact12poses.pkl"
        if not pkl.exists():
            raise FileNotFoundError(f"{pkl} not found (prepare/download_a2m_datasets.sh)")
        data = pickle.load(open(pkl, "rb"))
        self.poses = data["poses"]
        self.joints = data.get("joints3D")
        self.labels = data["y"]
        self.num_frames = num_frames
        self.num_actions = 12

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, idx: int) -> dict:
        pose = self.poses[idx].reshape(-1, 24, 3)
        T = pose.shape[0]
        # crop/pad to num_frames (reference a2m/dataset.py sampling)
        if T >= self.num_frames:
            start = np.random.randint(0, T - self.num_frames + 1)
            pose = pose[start : start + self.num_frames]
            length = self.num_frames
        else:
            pad = np.tile(pose[-1:], (self.num_frames - T, 1, 1))
            pose = np.concatenate([pose, pad], axis=0)
            length = T
        trans = np.zeros((self.num_frames, 3), np.float32)
        motion = axis_angle_poses_to_rot6d(pose.astype(np.float32), trans)
        return dict(
            motion=motion.reshape(self.num_frames, -1),  # [T, 150]
            length=length,
            action=int(self.labels[idx]),
            caption=HUMANACT12_ACTIONS[int(self.labels[idx])],
            tokens=[],
        )


class SyntheticA2MDataset:
    """Synthetic action-conditioned rot6d clips (tests)."""

    def __init__(self, size: int = 24, num_actions: int = 12, seed: int = 0,
                 num_frames: int = A2M_NUM_FRAMES):
        rng = np.random.default_rng(seed)
        self.num_actions = num_actions
        self.num_frames = num_frames
        self.items = []
        for i in range(size):
            action = i % num_actions
            base = rng.standard_normal((1, A2M_NJOINTS * A2M_NFEATS)) * 0.1
            walk = np.cumsum(
                rng.standard_normal((num_frames, A2M_NJOINTS * A2M_NFEATS)) * 0.02,
                axis=0,
            )
            self.items.append(
                dict(
                    motion=(base + walk + action * 0.05).astype(np.float32),
                    length=num_frames,
                    action=action,
                    caption=HUMANACT12_ACTIONS[action % 12],
                    tokens=[],
                )
            )

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx]


class UESTCDataset:
    """File-backed UESTC (reference data_loaders/a2m/uestc.py:51).

    Needs the prepared VIBE rotation pickles + info files downloaded by
    prepare/download_a2m_datasets.sh. 40 action classes; clips cropped/padded
    to num_frames like HumanAct12; rot6d 25×6 features via the same
    axis-angle conversion.
    """

    NUM_ACTIONS = 40

    def __init__(self, datapath: str = "dataset/uestc", split: str = "train",
                 num_frames: int = A2M_NUM_FRAMES):
        import pickle

        root = Path(datapath)
        info = root / "info"
        if not info.is_dir():
            raise FileNotFoundError(f"{info} not found (prepare/download_a2m_datasets.sh)")
        self.actions = [
            l.strip() for l in open(info / "action_classes.txt") if l.strip()
        ]
        vibe_pkl = root / "vibe_cache_refined.pkl"
        if not vibe_pkl.exists():
            raise FileNotFoundError(f"{vibe_pkl} not found")
        self.cache = pickle.load(open(vibe_pkl, "rb"))
        names_file = info / f"{'train' if split == 'train' else 'test'}.txt"
        self.indices = (
            [int(l) for l in open(names_file) if l.strip()]
            if names_file.exists()
            else list(range(len(self.cache["rotations"])))
        )
        self.num_frames = num_frames

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int) -> dict:
        ind = self.indices[idx]
        rotvec = np.asarray(self.cache["rotations"][ind], np.float32).reshape(-1, 24, 3)
        label = int(self.cache["y"][ind]) if "y" in self.cache else 0
        T = rotvec.shape[0]
        if T >= self.num_frames:
            start = np.random.randint(0, T - self.num_frames + 1)
            rotvec = rotvec[start : start + self.num_frames]
            length = self.num_frames
        else:
            rotvec = np.concatenate(
                [rotvec, np.tile(rotvec[-1:], (self.num_frames - T, 1, 1))], axis=0
            )
            length = T
        trans = np.zeros((self.num_frames, 3), np.float32)
        motion = axis_angle_poses_to_rot6d(rotvec, trans)
        return dict(
            motion=motion.reshape(self.num_frames, -1),
            length=length,
            action=label,
            caption=self.actions[label] if label < len(self.actions) else str(label),
            tokens=[],
        )
