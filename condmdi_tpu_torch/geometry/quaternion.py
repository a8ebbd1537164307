"""Quaternion algebra on tensors (wxyz convention, real part first).

Counterpart of condmdi_tpu/geometry/quaternion.py: the algebra the skeleton's
FK/IK and the HumanML3D codec call, the continuous 6D rotation, and the
spherical and linear interpolations. Every function broadcasts over leading
dimensions and works on any device.
"""

from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternion(s): negate the vector part. (*, 4)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qnormalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm. (*, 4)."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=eps)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*r for (*, 4) tensors (broadcasting leading dims)."""
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    return torch.stack(
        [
            qw * rw - qx * rx - qy * ry - qz * rz,
            qw * rx + qx * rw + qy * rz - qz * ry,
            qw * ry - qx * rz + qy * rw + qz * rx,
            qw * rz + qx * ry - qy * rx + qz * rw,
        ],
        dim=-1,
    )


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (*, 3) by unit quaternion(s) q (*, 4):
    v' = v + 2*(w*(u x v) + u x (u x v))."""
    qvec = q[..., 1:]
    uv = _cross(qvec, v)
    uuv = _cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qfix(q: torch.Tensor) -> torch.Tensor:
    """Sign continuity along the time axis of (..., L, J, 4): q or -q per frame
    so that consecutive frames have a non-negative dot product."""
    dots = (q[..., 1:, :, :] * q[..., :-1, :, :]).sum(dim=-1)
    flip = torch.cumsum((dots < 0).to(torch.int64), dim=-2) % 2 == 1
    sign = torch.where(flip, -1.0, 1.0).to(q.dtype)[..., None]
    return torch.cat([q[..., :1, :, :], q[..., 1:, :, :] * sign], dim=-3)


def qbetween(v0: torch.Tensor, v1: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Quaternion rotating v0 into v1. Both (*, 3); returns (*, 4). A zero input
    direction gives the identity quaternion (finite features downstream)."""
    v = _cross(v0, v1)
    n0n1 = torch.sqrt((v0 * v0).sum(-1, keepdim=True) * (v1 * v1).sum(-1, keepdim=True))
    w = n0n1 + (v0 * v1).sum(-1, keepdim=True)
    q = qnormalize(torch.cat([w, v], dim=-1), eps=eps)
    identity = torch.zeros_like(q)
    identity[..., 0] = 1.0
    return torch.where(n0n1 > eps, q, identity)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(*, 4) quaternion (not necessarily unit) → (*, 3, 3) rotation matrix;
    the zero quaternion maps to a finite matrix."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1).clamp(min=1e-12)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def quaternion_to_cont6d(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → continuous 6D rotation: the first two matrix *columns*."""
    m = quaternion_to_matrix(q)
    return torch.cat([m[..., 0], m[..., 1]], dim=-1)


def cont6d_to_matrix(c: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Continuous 6D (column convention) → (*, 3, 3) via Gram-Schmidt."""
    x_raw, y_raw = c[..., 0:3], c[..., 3:6]
    x = x_raw / torch.linalg.norm(x_raw, dim=-1, keepdim=True).clamp(min=eps)
    z = _cross(x, y_raw)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True).clamp(min=eps)
    y = _cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def qslerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation between unit quaternions, elementwise in t (t
    broadcasts against the leading dims of q0/q1).

    The shorter arc: q1 is flipped where the dot product is negative. Where
    sin θ < 1e-6 (in float32: where the dot product rounds to 1) it is the
    normalised lerp, and the `where`s keep that branch's gradient finite: the
    slerp weights divide by 1 instead of sin θ there, and θ is taken of 0
    instead of a dot product of 1, where arccos has no derivative. The values
    are JAX's; so are the gradients wherever JAX's are finite (at a dot
    product of exactly 1, JAX's arccos gives NaN).
    """
    q0, q1 = qnormalize(q0), qnormalize(q1)
    d = (q0 * q1).sum(dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = d.abs()
    edge = d >= 1
    theta = torch.where(edge, 0.0, torch.arccos(torch.where(edge, 0.0, d)))
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    t = t[..., None] if t.ndim < q0.ndim else t
    small = sin_theta < 1e-6
    safe = torch.where(small, 1.0, sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe)
    return qnormalize(w0 * q0 + w1 * q1)


def lerp(p0: torch.Tensor, p1: torch.Tensor, t) -> torch.Tensor:
    return p0 + t * (p1 - p0)
