"""Chain-based skeleton forward/inverse kinematics on tensors.

Counterpart of condmdi_tpu/geometry/skeleton.py: the HumanML3D and KIT
skeletons, quaternion and 6D-rotation FK (`Skeleton.forward_kinematics`,
`Skeleton.forward_kinematics_cont6d`), the IK (`Skeleton.inverse_kinematics`),
offsets from a reference pose and `_gaussian_filter1d`. As there, rotation
accumulation restarts at the root quaternion for every kinematic chain (the
arm chain [9, 14, 17, 19, 21] composes q_root * q_14, not the torso), the
convention the HumanML3D IK produces its local quaternions under.

The IK takes any leading batch dimensions in front of (T, J, 3), so the
synthetic dataset runs FK and the codec over a whole chunk of items in one
call on the device it is given.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from condmdi_tpu_torch.geometry.quaternion import cont6d_to_matrix, qbetween, qinv, qmul, qrot

# HumanML3D (Text2Motion) 22-joint skeleton: unit offset directions and
# kinematic chains (reference data_loaders/humanml/utils/paramUtil.py:32,55).
T2M_RAW_OFFSETS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, -1, 0],
        [0, 1, 0], [0, -1, 0], [0, -1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1],
        [0, 1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, -1, 0], [0, -1, 0],
        [0, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, 0],
    ],
    dtype=np.float32,
)
T2M_KINEMATIC_CHAIN = [
    [0, 2, 5, 8, 11],
    [0, 1, 4, 7, 10],
    [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21],
    [9, 13, 16, 18, 20],
]

# KIT 21-joint skeleton (reference paramUtil.py:4,6).
KIT_RAW_OFFSETS = np.array(
    [
        [0, 0, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [1, 0, 0],
        [0, -1, 0], [0, -1, 0], [-1, 0, 0], [0, -1, 0], [0, -1, 0], [1, 0, 0],
        [0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
        [0, -1, 0], [0, 0, 1], [0, 0, 1],
    ],
    dtype=np.float32,
)
KIT_KINEMATIC_CHAIN = [
    [0, 11, 12, 13, 14, 15],
    [0, 16, 17, 18, 19, 20],
    [0, 1, 2, 3, 4],
    [3, 5, 6, 7],
    [3, 8, 9, 10],
]

# Face-direction joints (r_hip, l_hip, sdr_r, sdr_l) for HumanML3D IK
# (reference motion_process.py:18).
T2M_FACE_JOINT_INDX = (2, 1, 17, 16)


def _parents_from_chains(n_joints: int, chains) -> list[int]:
    parents = [0] * n_joints
    parents[0] = -1
    for chain in chains:
        for j in range(1, len(chain)):
            parents[chain[j]] = chain[j - 1]
    return parents


def _identity_quat(like: torch.Tensor) -> torch.Tensor:
    q = torch.zeros_like(like)
    q[..., 0] = 1.0
    return q


def _unit(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=eps)


class Skeleton:
    """Static skeleton description + functional FK/IK (no device state)."""

    def __init__(self, raw_offsets: np.ndarray, kinematic_chain):
        self.raw_offsets = np.asarray(raw_offsets, dtype=np.float32)
        self.chains = [list(c) for c in kinematic_chain]
        self.n_joints = self.raw_offsets.shape[0]
        self.parents = _parents_from_chains(self.n_joints, self.chains)

    def offsets_from_reference_pose(self, joints: np.ndarray) -> np.ndarray:
        """The unit offset directions scaled by the bone lengths of a reference
        pose, joints (n_joints, 3); numpy in and out, as in JAX."""
        offsets = self.raw_offsets.copy()
        for i in range(1, self.n_joints):
            offsets[i] = np.linalg.norm(joints[i] - joints[self.parents[i]]) * offsets[i]
        return offsets

    def forward_kinematics(
        self,
        quat_params: torch.Tensor,
        root_pos: torch.Tensor,
        offsets: torch.Tensor,
    ) -> torch.Tensor:
        """Quaternion FK. quat_params (..., J, 4), root_pos (..., 3), offsets
        (J, 3) or broadcastable (..., J, 3). Returns (..., J, 3)."""
        offsets = torch.as_tensor(offsets, dtype=quat_params.dtype, device=quat_params.device)
        offsets = offsets.expand(quat_params.shape[:-2] + offsets.shape[-2:])
        pos: dict[int, torch.Tensor] = {0: root_pos}
        for chain in self.chains:
            rot = quat_params[..., 0, :]
            for i in range(1, len(chain)):
                j = chain[i]
                rot = qmul(rot, quat_params[..., j, :])
                pos[j] = qrot(rot, offsets[..., j, :]) + pos[chain[i - 1]]
        return torch.stack([pos[j] for j in range(self.n_joints)], dim=-2)

    def forward_kinematics_cont6d(
        self,
        cont6d_params: torch.Tensor,
        root_pos: torch.Tensor,
        offsets: torch.Tensor,
        do_root_rot: bool = True,
    ) -> torch.Tensor:
        """6D-rotation FK (column convention). cont6d_params (..., J, 6), root_pos
        (..., 3), offsets (J, 3) or (..., J, 3). Returns (..., J, 3). The 3 x 3
        products are float32 matmuls (JAX asks for Precision.HIGHEST; on the card
        they are full float32 unless TF32 matmuls are switched on)."""
        offsets = torch.as_tensor(offsets, dtype=cont6d_params.dtype,
                                  device=cont6d_params.device)
        offsets = offsets.expand(cont6d_params.shape[:-2] + offsets.shape[-2:])
        mats = cont6d_to_matrix(cont6d_params)  # (..., J, 3, 3)
        pos: dict[int, torch.Tensor] = {0: root_pos}
        for chain in self.chains:
            if do_root_rot:
                rot = mats[..., 0, :, :]
            else:
                rot = torch.eye(3, dtype=mats.dtype, device=mats.device).expand_as(
                    mats[..., 0, :, :])
            for i in range(1, len(chain)):
                j = chain[i]
                rot = rot @ mats[..., j, :, :]
                pos[j] = (rot @ offsets[..., j, :, None])[..., 0] + pos[chain[i - 1]]
        return torch.stack([pos[j] for j in range(self.n_joints)], dim=-2)

    def inverse_kinematics(self, joints: torch.Tensor, smooth_forward: bool = False) -> torch.Tensor:
        """Global joint positions (..., T, J, 3) → chain-local quaternions
        (..., T, J, 4). The root rotation aligns the body's forward direction
        (up × the hip + shoulder axis) onto +Z; frame 0's root quaternion is
        the identity."""
        # the reference unpacks [2, 1, 17, 16] as (l_hip, r_hip, sdr_r, sdr_l),
        # so the hip "across" vector is joints[1] - joints[2]; kept as it is
        l_hip, r_hip, sdr_r, sdr_l = T2M_FACE_JOINT_INDX
        across = (joints[..., r_hip, :] - joints[..., l_hip, :]) + (
            joints[..., sdr_r, :] - joints[..., sdr_l, :]
        )
        # eps-guarded normalisations: generated poses can collapse joints onto
        # each other, and their features must stay finite
        across = _unit(across)
        up = across.new_tensor([0.0, 1.0, 0.0]).expand_as(across)
        forward = torch.linalg.cross(up, across, dim=-1)
        if smooth_forward:
            forward = _gaussian_filter1d(forward, sigma=20.0, axis=-2)
        forward = _unit(forward)

        target = forward.new_tensor([0.0, 0.0, 1.0]).expand_as(forward)
        root_quat = qbetween(forward, target)
        root_quat = torch.cat([_identity_quat(root_quat[..., :1, :]), root_quat[..., 1:, :]],
                              dim=-2)

        quats: dict[int, torch.Tensor] = {0: root_quat}
        offsets = torch.as_tensor(self.raw_offsets, dtype=joints.dtype, device=joints.device)
        for chain in self.chains:
            rot = root_quat
            for i in range(len(chain) - 1):
                j_child, j_par = chain[i + 1], chain[i]
                u = offsets[j_child].expand_as(joints[..., 0, :])
                v = _unit(joints[..., j_child, :] - joints[..., j_par, :])
                local = qmul(qinv(rot), qbetween(u, v))
                quats[j_child] = local
                rot = qmul(rot, local)
        return torch.stack([quats[j] for j in range(self.n_joints)], dim=-2)


def _gaussian_filter1d(x: torch.Tensor, sigma: float, axis: int = 0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter1d equivalent (mode='nearest', truncate=4)."""
    radius = int(4.0 * sigma + 0.5)
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (t / sigma) ** 2)
    w = torch.as_tensor((w / w.sum()).astype(np.float32), dtype=x.dtype, device=x.device)
    xm = torch.movedim(x, axis, -1)
    flat = xm.reshape(-1, 1, xm.shape[-1])
    flat = F.pad(flat, (radius, radius), mode="replicate")
    out = F.conv1d(flat, w.reshape(1, 1, -1))  # correlation; the kernel is symmetric
    return torch.movedim(out.reshape(xm.shape), -1, axis)


t2m_skeleton = Skeleton(T2M_RAW_OFFSETS, T2M_KINEMATIC_CHAIN)
kit_skeleton = Skeleton(KIT_RAW_OFFSETS, KIT_KINEMATIC_CHAIN)
