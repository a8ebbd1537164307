"""AMASS forward kinematics and the 764-dim NeMF field builders on tensors.

Counterpart of condmdi_tpu/data/amass_fk.py (reference
data_loaders/amass/utils/fk.py ForwardKinematicsLayer, utils.py load_data /
prep_to_save / batch_to_dict / dict_to_batch / dict_to_xyz / dict_to_posrot,
helper_functions.py's velocity estimators): the path that turns SMPL
axis-angle poses into the 764-dim representation of the AMASS in-betweening
models (data/amass.py holds the layout masks).

FK walks the 24-joint tree with one batched [N, 3, 3] product per joint;
`global_to_local` is one gather and one batched product (no joint loop), as in
the JAX package. Everything runs on the device of its inputs and is
differentiable. The rest-pose offsets come from the SMPL body-model files
where present, otherwise from the same synthetic `default_rng(0)` skeleton as
the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from condmdi_tpu_torch.geometry.quaternion import qinv, qrot
from condmdi_tpu_torch.geometry.rotations import (
    axis_angle_to_matrix,
    euler_angles_to_matrix,
    matrix_to_axis_angle,
    matrix_to_quaternion,
    matrix_to_rotation_6d,
    quaternion_to_matrix,
    rotation_6d_to_matrix,
)

FPS = 30  # reference utils.py:12
ROOT_TRANSFORM = True  # reference utils.py:13
V_AXIS = (0, 1)  # reference utils.py:14

# the standard SMPL 24-joint kinematic tree (kintree_table[0] of the body model)
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    np.int32,
)


def rotations_to_matrix(rotations: torch.Tensor) -> torch.Tensor:
    """rotmat [..., 3, 3], Euler XYZ [..., 3], quaternion [..., 4] or 6d [..., 6]
    → [..., 3, 3] (reference make_fast_rotation_matrices, fk.py:53-62)."""
    if rotations.shape[-2:] == (3, 3):
        return rotations
    if rotations.shape[-1] == 3:
        return euler_angles_to_matrix(rotations, convention="XYZ")
    if rotations.shape[-1] == 4:
        return quaternion_to_matrix(rotations)
    if rotations.shape[-1] == 6:
        return rotation_6d_to_matrix(rotations)
    raise NotImplementedError(
        f"unsupported rotation representation with trailing shape {tuple(rotations.shape[-1:])}"
    )


class ForwardKinematics:
    """SMPL-topology FK (reference ForwardKinematicsLayer, fk.py:15), built from
    (parents, parent-relative offsets); every method is batched over the leading
    dimension and runs on its inputs' device."""

    def __init__(self, parents: Optional[np.ndarray] = None, offsets: Optional[np.ndarray] = None):
        self.parents = np.asarray(SMPL_PARENTS if parents is None else parents, np.int32)
        if offsets is None:
            offsets = _default_offsets(len(self.parents))
        offsets = np.asarray(offsets, np.float32).copy()
        offsets[0] = 0.0  # reference fk.py:40
        self.offsets = torch.from_numpy(offsets)  # [J, 3], on the host

    def __call__(self, rotations: torch.Tensor, positions: Optional[torch.Tensor] = None):
        """rotations [B, J, D] (any supported representation) → (joints [B, J, 3],
        transforms [B, J, 4, 4]) (reference fk.py:137-152)."""
        rot = rotations_to_matrix(rotations)  # [B, J, 3, 3]
        B, J = rot.shape[:2]
        if positions is None:
            positions = self.offsets.to(device=rot.device, dtype=rot.dtype)[None].expand(B, J, 3)
        loc_t = positions[..., None]  # [B, J, 3, 1]
        glob_rot, glob_t = [rot[:, 0]], [loc_t[:, 0]]
        for i in range(1, J):
            p = int(self.parents[i])
            glob_rot.append(glob_rot[p] @ rot[:, i])
            glob_t.append(glob_rot[p] @ loc_t[:, i] + glob_t[p])
        R = torch.stack(glob_rot, dim=1)  # [B, J, 3, 3]
        t = torch.stack(glob_t, dim=1)  # [B, J, 3, 1]
        bottom = rot.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, J, 1, 4)
        transforms = torch.cat([torch.cat([R, t], dim=-1), bottom], dim=-2)  # [B, J, 4, 4]
        return t[..., 0], transforms

    forward = __call__

    def global_to_local(self, global_xform: torch.Tensor) -> torch.Tensor:
        """[B, J, 3, 3] global → local rotations (reference fk.py:120-135): one
        gather and one batched product."""
        gather = np.where(self.parents < 0, 0, self.parents)
        parent_xform = global_xform[:, torch.as_tensor(gather, device=global_xform.device)]
        local = torch.linalg.inv(parent_xform) @ global_xform
        return torch.cat([global_xform[:, :1], local[:, 1:]], dim=1)

    def canonical_to_local(self, canonical_xform: torch.Tensor,
                           global_orient: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(reference fk.py:98-118)"""
        if global_orient is not None:
            canonical_xform = global_orient[:, None] @ canonical_xform
        return self.global_to_local(canonical_xform)

    def get_tpose_joints(self, offsets: torch.Tensor, parents: np.ndarray) -> torch.Tensor:
        """Parent-relative offsets [B, J, 3] accumulated → T-pose joints (reference
        fk.py:90-96)."""
        joints = [offsets[:, 0]]
        for j in range(1, len(parents)):
            joints.append(joints[int(parents[j])] + offsets[:, j])
        return torch.stack(joints, dim=1)


def _default_offsets(J: int) -> np.ndarray:
    """Rest-pose parent-relative joint offsets: from the SMPL body-model files where
    present (reference fk.py:28-33), else the JAX package's synthetic skeleton
    (default_rng(0) directions of length 1/4)."""
    try:
        from condmdi_tpu_torch.models.smpl import SMPLModel

        model = SMPLModel.from_files(device="cpu")
        joints = (model.J_regressor @ model.v_template).numpy()  # [J, 3]
        off = joints.copy()
        off[1:] -= joints[SMPL_PARENTS[1:]]
        return off[:J]
    except Exception:
        rng = np.random.default_rng(0)
        off = rng.standard_normal((J, 3)).astype(np.float32)
        off /= np.linalg.norm(off, axis=-1, keepdims=True) * 4.0
        return off


# ---- velocity estimators (helper_functions.py) ------------------------------ #
def estimate_linear_velocity(data_seq: torch.Tensor, dt: float) -> torch.Tensor:
    """Forward / central / backward differences over axis 1 (helper_functions.py:5)."""
    init_vel = (data_seq[:, 1:2] - data_seq[:, :1]) / dt
    middle_vel = (data_seq[:, 2:] - data_seq[:, :-2]) / (2 * dt)
    final_vel = (data_seq[:, -1:] - data_seq[:, -2:-1]) / dt
    return torch.cat([init_vel, middle_vel, final_vel], dim=1)


def estimate_angular_velocity(rot_seq: torch.Tensor, dt: float) -> torch.Tensor:
    """Angular velocity of a rotation-matrix sequence [B, T, ..., 3, 3]
    (helper_functions.py:24): w_mat = dR/dt @ R^T, its skew entries averaged."""
    dRdt = estimate_linear_velocity(rot_seq, dt)
    w_mat = dRdt @ rot_seq.transpose(-1, -2)
    w_x = (-w_mat[..., 1, 2] + w_mat[..., 2, 1]) / 2.0
    w_y = (w_mat[..., 0, 2] - w_mat[..., 2, 0]) / 2.0
    w_z = (-w_mat[..., 0, 1] + w_mat[..., 1, 0]) / 2.0
    return torch.stack([w_x, w_y, w_z], dim=-1)


# ---- 764-d field builders (utils.py) ---------------------------------------- #
def fields_from_poses(poses: torch.Tensor, trans: torch.Tensor,
                      fk: Optional[ForwardKinematics] = None) -> dict:
    """SMPL axis-angle poses [N, T, 24, 3] and root translations [N, T, 3] → the
    NeMF field dict (reference load_data, utils.py:163-215 / prep_to_load,
    utils.py:221-258), on the inputs' device."""
    if fk is None:
        fk = ForwardKinematics()
    N, T = poses.shape[:2]
    root_rotation = axis_angle_to_matrix(poses[:, :, 0])  # [N, T, 3, 3]
    poses = torch.cat([torch.zeros_like(poses[:, :, :1]), poses[:, :, 1:]], dim=2)

    rotmat = axis_angle_to_matrix(poses)  # [N, T, 24, 3, 3]
    angular = estimate_angular_velocity(rotmat, dt=1.0 / FPS)
    pos, global_xform = fk(rotmat.reshape(-1, 24, 3, 3))
    pos = pos.reshape(N, T, 24, 3)
    global_xform = global_xform.reshape(N, T, 24, 4, 4)[..., :3, :3]
    velocity = estimate_linear_velocity(pos, dt=1.0 / FPS)
    root_vel = estimate_linear_velocity(trans, dt=1.0 / FPS)
    global_pos = (root_rotation[:, :, None] @ pos[..., None])[..., 0] + trans[:, :, None]
    return {
        "pos": pos,
        "velocity": velocity,
        "global_xform": matrix_to_rotation_6d(global_xform),
        "angular": angular,
        "root_orient": matrix_to_rotation_6d(root_rotation),
        "root_vel": root_vel,
        "global_pos": global_pos,
        "rotmat": rotmat,
        "trans": trans,
    }


def load_amass_files(files, max_samples: int = 400, fk: Optional[ForwardKinematics] = None,
                     device: str | torch.device = "cuda") -> dict:
    """.npz files read on the host, then fields_from_poses on `device` (reference
    load_data, utils.py:163). Takes SMPL-H 'poses' or 'root_orient' + 'pose_body'."""
    from condmdi_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    poses, trans = [], []
    assert len(files) != 0, "files not found"
    for f in files[: min(max_samples, len(files))]:
        bdata = np.load(f)
        if "poses" in bdata.keys():
            poses.append(bdata["poses"][:, :72])
        elif "root_orient" in bdata.keys() and "pose_body" in bdata.keys():
            poses.append(np.concatenate((bdata["root_orient"], bdata["pose_body"]), axis=-1))
        else:
            raise RuntimeError(f"missing pose parameters in the file: {f}")
        trans.append(bdata["trans"])
    trans = torch.from_numpy(np.asarray(trans, np.float32)).to(dev)
    N, T = trans.shape[:2]
    poses = torch.from_numpy(np.asarray(poses, np.float32)).to(dev).reshape(N, T, 24, 3)
    return fields_from_poses(poses, trans, fk)


def prep_to_save(data: dict, fk: Optional[ForwardKinematics] = None) -> dict:
    """Field dict → the SMPL save format {poses [B, T, 165] axis-angle, trans,
    betas, gender, mocap_framerate} as numpy (reference prep_to_save,
    utils.py:125; save_data, utils.py:81, without the file)."""
    if fk is None:
        fk = ForwardKinematics()
    rotmat = torch.as_tensor(data["rotmat"])  # [B, T, J, 3, 3]
    B, T, J = rotmat.shape[:3]
    local_rotmat = fk.global_to_local(rotmat.reshape(-1, J, 3, 3)).reshape(B, T, J, 3, 3)
    if ROOT_TRANSFORM:
        root_orient = rotation_6d_to_matrix(torch.as_tensor(data["root_orient"]))
        local_rotmat = torch.cat([root_orient[:, :, None], local_rotmat[:, :, 1:]], dim=2)
    poses = matrix_to_axis_angle(local_rotmat).reshape(B, T, -1)  # [B, T, 72]
    poses = torch.nn.functional.pad(poses, (0, 93))  # [B, T, 165]
    return {
        "poses": poses.detach().cpu().numpy(),
        "trans": np.asarray(torch.as_tensor(data["trans"]).detach().cpu()),
        "betas": np.zeros((B, 10), np.float32),
        "gender": "male",
        "mocap_framerate": FPS,
    }


# the 764-d block layout (reference batch_to_dict, utils.py:263-283); data/amass.py's
# FIELD_SLICES shares the boundaries but names 291:363 'velocity' and 398:470
# 'global_vel', where the reference's decoder says 'angular' and 'velocity'
LAYOUT_764 = {
    "trans": (0, 3),
    "rotmat": (3, 219),
    "pos": (219, 291),
    "angular": (291, 363),
    "contacts": (363, 371),
    "height": (371, 395),
    "root_vel": (395, 398),
    "velocity": (398, 470),
    "global_xform": (470, 614),
    "root_orient": (614, 620),
    "rot6d": (620, 764),
}


def dict_to_batch(data_dict: dict) -> torch.Tensor:
    """Field dict → [B, 1, T, 764] (reference dict_to_batch, utils.py:16); each
    field placed at its LAYOUT_764 slice, absent ones zero."""
    pos = torch.as_tensor(data_dict["pos"])
    b, t = pos.shape[:2]
    pieces = []
    for key, (lo, hi) in LAYOUT_764.items():
        val = data_dict.get(key)
        pieces.append(torch.zeros((b, t, hi - lo), dtype=pos.dtype, device=pos.device)
                      if val is None else torch.as_tensor(val).reshape(b, t, hi - lo))
    return torch.cat(pieces, dim=-1)[:, None]


def batch_to_dict(batch: torch.Tensor) -> dict:
    """[B, 1, T, 764] (or [B, T, 764]) → field dict (reference batch_to_dict,
    utils.py:263-283)."""
    batch = torch.as_tensor(batch)
    if batch.ndim == 4:
        batch = batch[:, 0]
    B, T = batch.shape[:2]
    return {
        "trans": batch[..., 0:3],
        "rotmat": batch[..., 3: 3 + 216].reshape(B, T, 24, 3, 3),
        "pos": batch[..., 219: 219 + 72].reshape(B, T, 24, 3),
        "angular": batch[..., 291: 291 + 72].reshape(B, T, 24, 3),
        "contacts": batch[..., 363:371],
        "height": batch[..., 371:395],
        "root_vel": batch[..., 395:398],
        "velocity": batch[..., 398: 398 + 72].reshape(B, T, 24, 3),
        "global_xform": batch[..., 470: 470 + 144].reshape(B, T, 24, 6),
        "root_orient": batch[..., 614:620],
        "rot6d": batch[..., 620:].reshape(B, T, 24, 6),
    }


def dict_to_xyz(data_dict: dict) -> torch.Tensor:
    """Field dict → global joint positions [B, T, 24, 3] (reference dict_to_xyz,
    utils.py:286-308): the local joints rotated by the root orientation, the root's
    translation added, the root set to trans and every joint's y to its height."""
    root_quat = matrix_to_quaternion(rotation_6d_to_matrix(torch.as_tensor(data_dict["root_orient"])))
    r_pos = torch.as_tensor(data_dict["trans"])
    positions = torch.as_tensor(data_dict["pos"])
    q = qinv(root_quat)[..., None, :].expand(positions.shape[:-1] + (4,))
    positions = qrot(q, positions) + r_pos[..., None, :]
    positions = torch.cat([r_pos[..., None, :], positions[..., 1:, :]], dim=-2)
    height = torch.as_tensor(data_dict["height"])
    return torch.stack([positions[..., 0], height, positions[..., 2]], dim=-1)


def dict_to_posrot(data_dict: dict, fk: Optional[ForwardKinematics] = None):
    """Field dict → (positions [B, T, 3], local joint quaternions [B, T, J, 4])
    (reference dict_to_posrot, utils.py:318-330), the bvh-export view."""
    if fk is None:
        fk = ForwardKinematics()
    rotmat = torch.as_tensor(data_dict["rotmat"])
    B, T, J = rotmat.shape[:3]
    local_rotmat = fk.global_to_local(rotmat.reshape(-1, J, 3, 3)).reshape(B, T, J, 3, 3)
    root_orient = rotation_6d_to_matrix(torch.as_tensor(data_dict["root_orient"]))
    local_rotmat = torch.cat([root_orient[:, :, None], local_rotmat[:, :, 1:]], dim=2)
    return torch.as_tensor(data_dict["trans"]), matrix_to_quaternion(local_rotmat)
