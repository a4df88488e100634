"""Quaternion and rotation math on torch tensors.

Port of ``thormang_isaacgym_tpu/core/quat.py``. Quaternions are stored
**(w, x, y, z)**, unit-norm, and rotate a body frame into the world frame:
``rotate(q, v_body) -> v_world``. Every function broadcasts over leading
batch dimensions and keeps the dtype and device of its inputs.
"""
from __future__ import annotations

import math

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Normalize along the last axis."""
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)


def identity(shape=(), device=None, dtype=torch.float32) -> torch.Tensor:
    """Identity quaternion(s) with the given batch shape."""
    q = torch.zeros(tuple(shape) + (4,), device=device, dtype=dtype)
    q[..., 0] = 1.0
    return q


def from_xyzw(q: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) layout -> (w, x, y, z)."""
    return torch.cat([q[..., 3:4], q[..., 0:3]], dim=-1)


def to_xyzw(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) layout -> (x, y, z, w)."""
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


inverse = conj


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (body -> world): v + w t + q_v x t with t = 2 q_v x v."""
    w = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q (world -> body)."""
    return rotate(conj(q), v)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternion for a rotation of `angle` radians about unit `axis`."""
    half = 0.5 * angle
    w = torch.cos(half)
    xyz = axis * torch.sin(half)[..., None]
    w, xyz = w[..., None], xyz
    w = w.expand(xyz.shape[:-1] + (1,))
    return torch.cat([w, xyz], dim=-1)


def from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic XYZ Euler angles (URDF rpy) to quaternion."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([w, x, y, z], dim=-1)


def to_euler_xyz(q: torch.Tensor):
    """Quaternion to (roll, pitch, yaw), each wrapped to (-pi, pi]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return roll, pitch, yaw


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion to 3x3 rotation matrix (body -> world)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix to quaternion, branch-free (Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def piv(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 0.5

    qw0 = piv(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = piv(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = piv(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = piv(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return normalize(q)


def integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """First-order exponential-map update by a world angular velocity,
    renormalized."""
    dq = torch.cat([torch.zeros_like(omega_world[..., :1]), omega_world], dim=-1)
    return normalize(q + 0.5 * dt * mul(dq, q))


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation between unit quaternions (nlerp when nearly
    parallel)."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() < q0.dim():
        t = t[..., None]
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0 - 1e-7))
    sin_theta = torch.sin(theta)
    w0 = torch.sin((1.0 - t) * theta) / sin_theta
    w1 = torch.sin(t * theta) / sin_theta
    close = dot > 1.0 - 1e-6
    w0 = torch.where(close, 1.0 - t, w0)
    w1 = torch.where(close, t, w1)
    return normalize(w0 * q0 + w1 * q1)


def _axis(q: torch.Tensor, k: int) -> torch.Tensor:
    e = torch.zeros(3, dtype=q.dtype, device=q.device)
    e[k] = 1.0
    return e.expand(q.shape[:-1] + (3,))


def to_tan_norm(q: torch.Tensor) -> torch.Tensor:
    """World images of the body x (tangent) and z (normal) axes."""
    return torch.cat([rotate(q, _axis(q, 0)), rotate(q, _axis(q, 2))], dim=-1)


def heading(q: torch.Tensor) -> torch.Tensor:
    """Yaw of the body x-axis projected onto the ground plane."""
    d = rotate(q, _axis(q, 0))
    return torch.atan2(d[..., 1], d[..., 0])


def heading_quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Pure-z rotation that removes the heading."""
    return from_axis_angle(_axis(q, 2), -heading(q))


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi)."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def shortest_angle_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed shortest angular distance from a to b."""
    return torch.remainder(b - a + math.pi, 2.0 * math.pi) - math.pi
