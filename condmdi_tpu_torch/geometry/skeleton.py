"""Chain-based skeleton forward/inverse kinematics on tensors.

Counterpart of condmdi_tpu/geometry/skeleton.py for the HumanML3D skeleton's
quaternion FK (`Skeleton.forward_kinematics`), its IK
(`Skeleton.inverse_kinematics`) and `_gaussian_filter1d`. As there, rotation
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

from condmdi_tpu_torch.geometry.quaternion import qbetween, qinv, qmul, qrot

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

# Face-direction joints (r_hip, l_hip, sdr_r, sdr_l) for HumanML3D IK
# (reference motion_process.py:18).
T2M_FACE_JOINT_INDX = (2, 1, 17, 16)


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
