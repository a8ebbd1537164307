"""Keyframe observation-mask generator on tensors, for all 12 edit modes.

Counterpart of condmdi_tpu/training/keyframes.py (`get_keyframes_mask`,
`joint_to_full_mask`); returned masks are [B, T, F] bool (features last) and
every mode gates frames >= length to False.

The eight deterministic modes give JAX's masks exactly. The four random modes
(`gmd_keyframes`, `random_frames`, `random_joints`, `random`) keep JAX's
sampling semantics but draw from a `torch.Generator` instead of `jax.random`,
so their masks differ from JAX's draw for draw:
  * exactly min(k, length) distinct frames below `length` are chosen (k is
    n_keyframes, 20, or itself drawn uniformly from [1, length));
  * `random_joints` observes a random number of (frame, joint) cells of the
    chosen frames, and the root on every chosen frame;
  * `random` observes a random number of (frame, feature) cells of the chosen
    frames, then gives each chosen frame one forced feature: an empty frame
    gains it, a full one loses it (reference editing_util.py:205-211).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from condmdi_tpu_torch.data import layout as L

HML_EDIT_MODES = (
    "benchmark_sparse",
    "benchmark_clip",
    "uncond",
    "right_wrist",
    "lower_body",
    "pelvis_feet",
    "pelvis_vr",
    "pelvis",
    "gmd_keyframes",
    "random_frames",
    "random_joints",
    "random",
)
_JOINT_SUBSETS = {
    "right_wrist": [0, 21],
    "lower_body": L.HML_LOWER_BODY_JOINTS,
    "pelvis_feet": L.HML_PELVIS_FEET,
    "pelvis_vr": L.HML_PELVIS_VR,
    "pelvis": [0],
}
_RANDOM_FRAMES_K = 20  # the reference hardcodes 20 keyframes in random_frames


def joint_to_full_mask(joint_mask: torch.Tensor, feature_mode: str = "pos_rot_vel") -> torch.Tensor:
    """[..., T, 22] bool joint mask → [..., T, 263] bool feature mask."""
    assert feature_mode in ("pos", "pos_rot", "pos_rot_vel")
    mats = [L.MAT_POS, L.MAT_CNT]
    if feature_mode in ("pos_rot", "pos_rot_vel"):
        mats.append(L.MAT_ROT)
    if feature_mode == "pos_rot_vel":
        mats.append(L.MAT_VEL)
    mat = torch.as_tensor(np.stack(mats).any(axis=0), device=joint_mask.device)  # [22, 263]
    return (joint_mask[..., :, None] & mat).any(dim=-2)


def _choose_k_frames(gen: torch.Generator, T: int, length: int, k: int) -> torch.Tensor:
    """Bool [T]: exactly min(k, length) distinct random frames < length."""
    fm = torch.zeros(T, dtype=torch.bool)
    n = min(k, length)
    if n > 0:
        fm[torch.randperm(length, generator=gen)[:n]] = True
    return fm


def _randint(gen: torch.Generator, low: int, high: int) -> int:
    return int(torch.randint(low, high, (), generator=gen))


def _choose_cells(gen: torch.Generator, fm: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Bool [T, width]: n distinct random cells of the rows that `fm` selects
    (all of them if n exceeds their count)."""
    rows = torch.nonzero(fm).flatten()
    cells = torch.zeros((fm.shape[0], width), dtype=torch.bool)
    picked = torch.randperm(len(rows) * width, generator=gen)[:n]
    cells[rows[picked // width], picked % width] = True
    return cells


def _random_joints(gen, T, length, J):
    num_kf = _randint(gen, 1, max(length, 2))
    fm = _choose_k_frames(gen, T, length, num_kf)
    num_joints = _randint(gen, 0, max((J - 1) * num_kf, 1))
    jm = _choose_cells(gen, fm, J, num_joints)
    jm[:, 0] = fm  # the root is observed on every keyframe
    return jm


def _random_features(gen, T, length, F):
    num_kf = _randint(gen, 1, max(length, 2))
    fm = _choose_k_frames(gen, T, length, num_kf)
    num_feat = _randint(gen, 1, max(F * num_kf, 2))
    cells = _choose_cells(gen, fm, F, num_feat)
    forced = torch.zeros((T, F), dtype=torch.bool)
    forced[torch.arange(T), torch.randint(0, F, (T,), generator=gen)] = True
    forced &= fm[:, None]
    col_sum = cells.sum(dim=1)
    is_empty = (col_sum == 0) & fm
    is_full = (col_sum == F) & fm
    cells |= forced & is_empty[:, None]
    cells &= ~(forced & is_full[:, None])
    return cells


def get_keyframes_mask(
    lengths: torch.Tensor,  # [B] int
    T: int,
    edit_mode: str = "benchmark_sparse",
    trans_length: int = 10,
    feature_mode: str = "pos_rot_vel",
    n_keyframes: int = 5,
    n_features: int = 263,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The [B, T, F] observation mask for a batch, on `lengths`' device.

    The random modes draw from `generator` (a CPU `torch.Generator`; a fresh
    unseeded one if None), item by item in batch order. The `random` mode
    builds a feature mask directly; every other mode goes joint → feature
    through `joint_to_full_mask`.
    """
    J = 22
    B = lengths.shape[0]
    device = lengths.device
    frames = torch.arange(T, device=device)
    valid = frames[None, :] < lengths[:, None]  # [B, T]

    if edit_mode in ("gmd_keyframes", "random_frames", "random_joints", "random"):
        gen = generator if generator is not None else torch.Generator()
        lens = [int(v) for v in lengths.cpu()]
        if edit_mode == "random":
            return torch.stack([_random_features(gen, T, n, n_features) for n in lens]).to(device)
        if edit_mode == "random_joints":
            jm = torch.stack([_random_joints(gen, T, n, J) for n in lens])
        else:
            k = n_keyframes if edit_mode == "gmd_keyframes" else _RANDOM_FRAMES_K
            fm = torch.stack([_choose_k_frames(gen, T, n, k) for n in lens])
            jm = fm[:, :, None].expand(B, T, J)
        return joint_to_full_mask(jm.to(device), feature_mode)

    if edit_mode == "benchmark_sparse":
        fm = ((frames % trans_length) == 0)[None, :] & valid
        jm = fm[:, :, None].expand(B, T, J)
    elif edit_mode == "benchmark_clip":
        end_frame = torch.div(lengths - trans_length, 2, rounding_mode="floor")[:, None]
        fm = ((frames[None, :] < end_frame) | (frames[None, :] >= end_frame + trans_length)) & valid
        jm = fm[:, :, None].expand(B, T, J)
    elif edit_mode == "uncond":
        jm = torch.zeros((B, T, J), dtype=torch.bool, device=device)
    elif edit_mode in _JOINT_SUBSETS:
        joints = torch.zeros(J, dtype=torch.bool, device=device)
        joints[_JOINT_SUBSETS[edit_mode]] = True
        jm = valid[:, :, None] & joints
    else:
        raise ValueError(f"unknown edit_mode {edit_mode}")
    return joint_to_full_mask(jm, feature_mode)
