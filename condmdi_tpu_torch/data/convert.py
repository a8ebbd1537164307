"""abs↔rel motion representation converters (eval-pipeline plumbing).

Counterpart of condmdi_tpu/data/convert.py. Parity targets: reference
data_loaders/humanml/data/dataset.py — motion_to_rel_data:1198,
motion_to_abs_data:1253, module functions sample_to_motion:1301,
abs3d_to_rel:1327, rel_to_abs3d:1364; and utils/editing_util.py:232,:260 for
the root-channel converters.

The reference loops over the batch on the host; here the whole batch goes
through one batched `extract_features` on the tensor's device. All functions
take and return the [B, T, F] layout; features arrive NORMALIZED and leave
NORMALIZED (with the stats of the target representation), exactly like the
reference. `*_stats` are NormStats (numpy mean/std), moved to the data's
device and dtype.
"""

from __future__ import annotations

import torch

from condmdi_tpu_torch.data.humanml_repr import (
    extract_features,
    recover_from_ric,
    recover_root_rot_pos,
)
from condmdi_tpu_torch.geometry.quaternion import qrot


def _stats(stats, like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(stats.mean, dtype=like.dtype, device=like.device),
            torch.as_tensor(stats.std, dtype=like.dtype, device=like.device))


def _batched_rel_features(joints: torch.Tensor) -> torch.Tensor:
    """[B, T, 22, 3] → [B, T, 263] relative features (last frame duplicated
    to restore length, reference :1214-1216)."""
    feats = extract_features(joints, 0.002)  # [B, T-1, F]
    return torch.cat([feats, feats[:, -1:, :]], dim=1)


def _with_abs_root(feats: torch.Tensor) -> torch.Tensor:
    """Relative root channels 0:3 → the integrated yaw angle and world xz."""
    _, r_pos, rot_ang = recover_root_rot_pos(feats, abs_3d=False, return_rot_ang=True)
    return torch.cat([rot_ang[..., None], r_pos[..., 0:1], r_pos[..., 2:3], feats[..., 3:]],
                     dim=-1)


def joints_to_rel_features(joints: torch.Tensor, rel_stats) -> torch.Tensor:
    """motion_to_rel_data: joints → normalized relative features."""
    feats = _batched_rel_features(joints)
    mean, std = _stats(rel_stats, feats)
    return (feats - mean) / std


def joints_to_abs_features(joints: torch.Tensor, abs_stats) -> torch.Tensor:
    """motion_to_abs_data: joints → normalized absolute-root features.

    Build relative features, then overwrite the root channels with the
    integrated absolute yaw angle and absolute xz (reference :1275-1280).
    """
    feats = _with_abs_root(_batched_rel_features(joints))
    mean, std = _stats(abs_stats, feats)
    return (feats - mean) / std


def abs3d_to_rel(sample_abs: torch.Tensor, abs_stats, rel_stats) -> torch.Tensor:
    """Normalized abs features → normalized rel features (reference :1327)."""
    mean, std = _stats(abs_stats, sample_abs)
    joints = recover_from_ric(sample_abs * std + mean, 22, abs_3d=True)
    return joints_to_rel_features(joints, rel_stats)


def rel_to_abs3d(sample_rel: torch.Tensor, rel_stats, abs_stats) -> torch.Tensor:
    """Normalized rel features → normalized abs features (reference :1364)."""
    mean, std = _stats(rel_stats, sample_rel)
    joints = recover_from_ric(sample_rel * std + mean, 22, abs_3d=False)
    return joints_to_abs_features(joints, abs_stats)


def sample_to_motion(sample_abs: torch.Tensor, abs_stats) -> torch.Tensor:
    """Normalized abs features → global joints [B, T, 22, 3] (ref :1301)."""
    mean, std = _stats(abs_stats, sample_abs)
    return recover_from_ric(sample_abs * std + mean, 22, abs_3d=True)


# --------------------------------------------------------------------------- #
# Direct root-channel converters (reference utils/editing_util.py:232,:260) —
# operate on the 4 root feature channels only, no skeleton round trip.
# --------------------------------------------------------------------------- #
def relative_to_global(data: torch.Tensor) -> torch.Tensor:
    """[..., T, F] features with RELATIVE root channels → ABSOLUTE root
    channels (yaw angle + world xz), other channels untouched."""
    return _with_abs_root(data)


def global_to_relative(data: torch.Tensor) -> torch.Tensor:
    """Inverse of relative_to_global (reference undo_recover_root_rot_pos,
    editing_util.py:260): absolute yaw/xz → per-frame velocities rotated into
    the local frame; the last frame's velocity is lost (shifted left),
    matching the reference's behavior exactly."""
    gl_rot, gl_x, gl_z = data[..., 0], data[..., 1], data[..., 2]

    # forward differences; frame 0 diff slot stays 0 (reference writes into
    # positions 1:), then shifts left by one
    dx = torch.cat([torch.zeros_like(gl_x[..., :1]), torch.diff(gl_x, dim=-1)], dim=-1)
    dz = torch.cat([torch.zeros_like(gl_z[..., :1]), torch.diff(gl_z, dim=-1)], dim=-1)
    rel = torch.stack([dx, torch.zeros_like(dx), dz], dim=-1)
    zeros = torch.zeros_like(gl_rot)
    quat = torch.stack([torch.cos(gl_rot), zeros, torch.sin(gl_rot), zeros], dim=-1)
    rel = qrot(quat, rel)
    # shift left: rel_pos[t] = rel_pos[t+1] (last element duplicated)
    rel = torch.cat([rel[..., 1:, :], rel[..., -1:, :]], dim=-2)

    drot = torch.cat([torch.diff(gl_rot, dim=-1), torch.zeros_like(gl_rot[..., :1])], dim=-1)
    return torch.cat([drot[..., None], rel[..., 0:1], rel[..., 2:3], data[..., 3:]], dim=-1)
