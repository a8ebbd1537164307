"""HumanML3D 263-dim motion feature codec on tensors.

Counterpart of condmdi_tpu/data/humanml_repr.py for `recover_root_rot_pos`,
`recover_from_ric`, `detect_foot_contacts` and `extract_features`. Features
are LAST: data is (..., T, 263). `extract_features` takes any leading batch
dimensions in front of (T, J, 3), where the JAX version takes one item and is
vmapped by its caller; each item's result is the same.
"""

from __future__ import annotations

import math

import torch

from condmdi_tpu_torch.geometry.quaternion import (
    qfix,
    qinv,
    qmul,
    qrot,
    quaternion_to_cont6d,
)
from condmdi_tpu_torch.geometry.skeleton import t2m_skeleton

# Reference motion_process.py:13-21 constants.
FID_L = (7, 10)
FID_R = (8, 11)


def recover_root_rot_pos(data: torch.Tensor, abs_3d: bool = False,
                         return_rot_ang: bool = False):
    """Root y-rotation quaternion and root position from feature channels 0:4.

    data: (..., T, C>=4). Returns (r_rot_quat (..., T, 4), r_pos (..., T, 3)),
    and the yaw angle (..., T) third when `return_rot_ang`.
    Relative mode integrates the per-frame rotation velocity (channel 0) and
    the local xz velocities (1:3), shifted by one frame, as the reference does;
    absolute mode reads the angle and xz as they are.
    """
    if abs_3d:
        r_rot_ang = data[..., 0]
        r_pos = torch.stack([data[..., 1], data[..., 3], data[..., 2]], dim=-1)
    else:
        rot_vel = data[..., 0]
        shifted = torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], dim=-1)
        r_rot_ang = torch.cumsum(shifted, dim=-1)

    zeros = torch.zeros_like(data[..., 0])
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros, torch.sin(r_rot_ang), zeros], dim=-1)

    if not abs_3d:
        vel_xz = torch.cat([torch.zeros_like(data[..., :1, 1:3]), data[..., :-1, 1:3]], dim=-2)
        v3 = torch.stack([vel_xz[..., 0], torch.zeros_like(vel_xz[..., 0]), vel_xz[..., 1]],
                         dim=-1)
        r_pos = torch.cumsum(qrot(qinv(r_rot_quat), v3), dim=-2)
        r_pos = torch.stack([r_pos[..., 0], data[..., 3], r_pos[..., 2]], dim=-1)

    if return_rot_ang:
        return r_rot_quat, r_pos, r_rot_ang
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int = 22,
                     abs_3d: bool = False) -> torch.Tensor:
    """Features (..., T, 263) → global joint positions (..., T, J, 3)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data, abs_3d=abs_3d)
    positions = data[..., 4: (joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    # rotate the local joints into the world yaw frame, then add the root's xz
    positions = qrot(qinv(r_rot_quat)[..., None, :], positions)
    root_xz = torch.stack([r_pos[..., 0], torch.zeros_like(r_pos[..., 0]), r_pos[..., 2]],
                          dim=-1)
    positions = positions + root_xz[..., None, :]
    return torch.cat([r_pos[..., None, :], positions], dim=-2)


def detect_foot_contacts(positions: torch.Tensor, thres: float):
    """Squared-displacement foot contacts. positions (..., T, J, 3) → (feet_l,
    feet_r), each (..., T-1, 2) in positions' dtype."""
    def _feet(ids):
        d = positions[..., 1:, ids, :] - positions[..., :-1, ids, :]
        return ((d * d).sum(-1) < thres).to(positions.dtype)

    return _feet(list(FID_L)), _feet(list(FID_R))


def extract_features(positions: torch.Tensor, feet_thre: float = 0.002,
                     abs_3d: bool = False) -> torch.Tensor:
    """Global joint positions (..., T, J, 3) → features (..., T-1, 263).

    cont6d params from smoothed-forward IK, RIFKE local pose, root angular and
    linear velocity, local joint velocities, foot contacts (reference
    motion_process.py:50) on the HumanML3D skeleton. With abs_3d=True the
    root channels carry the absolute yaw angle and xz position instead of
    velocities.
    """
    feet_l, feet_r = detect_foot_contacts(positions, feet_thre)

    quat_params = qfix(t2m_skeleton.inverse_kinematics(positions, smooth_forward=True))
    cont_6d_params = quaternion_to_cont6d(quat_params)
    r_rot = quat_params[..., 0, :]  # (..., T, 4)

    root = positions[..., 0, :]  # (..., T, 3)
    velocity = qrot(r_rot[..., 1:, :], root[..., 1:, :] - root[..., :-1, :])
    r_velocity_q = qmul(r_rot[..., 1:, :], qinv(r_rot[..., :-1, :]))

    # RIFKE: root-centred xz, world rotated into the root's yaw frame
    root_xz = torch.stack([root[..., 0], torch.zeros_like(root[..., 0]), root[..., 2]], dim=-1)
    local = qrot(r_rot[..., None, :], positions - root_xz[..., None, :])
    root_y = local[..., 0, 1:2]  # (..., T, 1)

    if abs_3d:
        # the absolute yaw angle of q = (cos a, 0, sin a, 0), unwrapped
        r_ang = torch.atan2(r_rot[..., 2], r_rot[..., 0])
        d = torch.diff(r_ang, dim=-1)
        d = torch.where(d > math.pi, d - 2 * math.pi, torch.where(d < -math.pi, d + 2 * math.pi, d))
        r_ang = torch.cat([r_ang[..., :1], r_ang[..., :1] + torch.cumsum(d, dim=-1)], dim=-1)
        root_data = torch.cat(
            [r_ang[..., :-1, None], root[..., :-1, 0:1], root[..., :-1, 2:3], root_y[..., :-1, :]],
            dim=-1,
        )
    else:
        # clamped: |z| can exceed 1 by rounding, and arcsin must stay finite
        r_velocity = torch.asin(r_velocity_q[..., 2:3].clamp(-1.0, 1.0))
        root_data = torch.cat([r_velocity, velocity[..., [0, 2]], root_y[..., :-1, :]], dim=-1)

    lead = positions.shape[:-2]  # (..., T)
    rot_data = cont_6d_params[..., 1:, :].reshape(lead + (-1,))
    ric_data = local[..., 1:, :].reshape(lead + (-1,))
    local_vel = qrot(r_rot[..., :-1, None, :], positions[..., 1:, :, :] - positions[..., :-1, :, :])
    local_vel = local_vel.reshape(local_vel.shape[:-2] + (-1,))
    return torch.cat(
        [root_data, ric_data[..., :-1, :], rot_data[..., :-1, :], local_vel, feet_l, feet_r],
        dim=-1,
    )
