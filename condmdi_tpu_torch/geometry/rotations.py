"""Rotation representation conversions on tensors.

Counterpart of condmdi_tpu/geometry/rotations.py (pytorch3d lineage): the
quaternion algebra, matrix ↔ quaternion (branch-free: all four candidates from
the diagonal, the best-conditioned one selected), Euler angles in every
convention, axis-angle ↔ quaternion (Taylor-guarded near zero), and Zhou et
al.'s 6D representation, which keeps the first two ROWS of the matrix (unlike
the HumanML3D codec's column-convention cont6d in geometry/quaternion.py).
`random_quaternions`/`random_rotations` draw from a `torch.Generator` where the
JAX functions take a key. Everything broadcasts over leading axes and is
differentiable.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from condmdi_tpu_torch.geometry.quaternion import qmul, qrot
from condmdi_tpu_torch.geometry.quaternion import quaternion_to_matrix as _quaternion_to_matrix


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x))."""
    return torch.sqrt(x.clamp(min=0.0))


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip the sign so that the real part is non-negative."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return qmul(a, b)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    return qrot(q, point)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    return _quaternion_to_matrix(q)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(*, 3, 3) → (*, 4) wxyz, standardized and normalised."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = torch.stack([
        _sqrt_positive_part(1.0 + m00 + m11 + m22),
        _sqrt_positive_part(1.0 + m00 - m11 - m22),
        _sqrt_positive_part(1.0 - m00 + m11 - m22),
        _sqrt_positive_part(1.0 - m00 - m11 + m22),
    ], dim=-1)
    candidates = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    # the denominator 2 q_abs[i], guarded for the near-zero entries that are not chosen
    floor = 0.1 * torch.finfo(matrix.dtype).eps
    candidates = candidates / (2.0 * q_abs[..., None].clamp(min=floor))
    onehot = F.one_hot(q_abs.argmax(dim=-1), 4).to(matrix.dtype)[..., None]
    q = (candidates * onehot).sum(dim=-2)
    return standardize_quaternion(q / torch.linalg.norm(q, dim=-1, keepdim=True))


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(f"letter must be X/Y/Z, got {axis}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(c not in "XYZ" for c in convention):
        raise ValueError(f"invalid convention {convention}")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    _check_convention(convention)
    ms = [_axis_angle_rotation(c, euler_angles[..., i]) for i, c in enumerate(convention)]
    return ms[0] @ ms[1] @ ms[2]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ["XY", "YZ", "ZX"]
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    _check_convention(convention)
    i0, i2 = "XYZ".index(convention[0]), "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in [-1, 2] else 1.0
        central = torch.asin((matrix[..., i0, i2] * sign).clamp(-1.0, 1.0))
    else:
        central = torch.acos(matrix[..., i0, i0].clamp(-1.0, 1.0))
    return torch.stack([
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    ], dim=-1)


def _sin_half_over(angles: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """sin(x/2)/x, with the series 0.5 - x²/48 for |x| < 1e-6."""
    small = angles.abs() < 1e-6
    return torch.where(small, 0.5 - angles * angles / 48.0,
                       torch.sin(half) / torch.where(small, torch.ones_like(angles), angles))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(*, 3) exponential map → (*, 4) wxyz; the norm is sqrt(x² + 1e-24), so the
    gradient at the zero rotation is finite."""
    angles = torch.sqrt((axis_angle * axis_angle).sum(dim=-1, keepdim=True) + 1e-24)
    half = angles * 0.5
    return torch.cat([torch.cos(half), axis_angle * _sin_half_over(angles, half)], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norms, q[..., :1])
    return q[..., 1:] / _sin_half_over(2.0 * half, half)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rotation_6d_to_matrix(d6: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Zhou et al. 6D (the first two ROWS of R) → (*, 3, 3) by Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=eps)
    a2 = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = a2 / torch.linalg.norm(a2, dim=-1, keepdim=True).clamp(min=eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def random_quaternions(n: int, generator: Optional[torch.Generator] = None,
                       dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """n unit quaternions, uniform on the sphere (normalised normal draws)."""
    q = torch.randn((n, 4), generator=generator, dtype=dtype, device=device)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def random_rotations(n: int, generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return quaternion_to_matrix(random_quaternions(n, generator, dtype, device))
