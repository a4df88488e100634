"""Spatial (6-D) vector algebra for articulated rigid-body dynamics.

Port of ``thormang_isaacgym_tpu/core/spatial.py``. Featherstone convention:
motion vectors m = (omega, v), force vectors f = (n, F), angular part first.
Transforms are (R, p) pairs: R maps child (B) coordinates into parent (A)
coordinates, p is the origin of B in A. All functions broadcast over leading
batch dimensions.
"""
from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> 3x3 skew-symmetric matrix (v x)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def cross_motion(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spatial cross product a x b for motion vectors."""
    aw, av = a[..., :3], a[..., 3:]
    bw, bv = b[..., :3], b[..., 3:]
    return torch.cat([_cross(aw, bw), _cross(aw, bv) + _cross(av, bw)], dim=-1)


def cross_force(a: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial cross product a x* f (motion x force)."""
    aw, av = a[..., :3], a[..., 3:]
    n, F = f[..., :3], f[..., 3:]
    return torch.cat([_cross(aw, n) + _cross(av, F), _cross(aw, F)], dim=-1)


def motion_to_parent(R, p, m):
    """Motion vector in child frame B -> parent frame A."""
    w = _mv(R, m[..., :3])
    v = _mv(R, m[..., 3:]) + _cross(p, w)
    return torch.cat([w, v], dim=-1)


def motion_to_child(R, p, m):
    """Motion vector in parent frame A -> child frame B."""
    w = m[..., :3]
    v = m[..., 3:] - _cross(p, w)
    Rt = R.transpose(-1, -2)
    return torch.cat([_mv(Rt, w), _mv(Rt, v)], dim=-1)


def force_to_parent(R, p, f):
    """Force vector in child frame B -> parent frame A."""
    F = _mv(R, f[..., 3:])
    n = _mv(R, f[..., :3]) + _cross(p, F)
    return torch.cat([n, F], dim=-1)


def force_to_child(R, p, f):
    """Force vector in parent frame A -> child frame B."""
    Rt = R.transpose(-1, -2)
    F = f[..., 3:]
    n = f[..., :3] - _cross(p, F)
    return torch.cat([_mv(Rt, n), _mv(Rt, F)], dim=-1)


def motion_xform(R, p):
    """6x6 motion transform child -> parent: [[R, 0], [p~ R, R]]."""
    Z = torch.zeros_like(R)
    top = torch.cat([R, Z], dim=-1)
    bot = torch.cat([skew(p) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inertia_matrix(mass, com, I_com):
    """Full 6x6 spatial inertia about the link-frame origin:
    [[I_com + m c~ c~^T, m c~], [m c~^T, m 1]]."""
    c = skew(com)
    ct = c.transpose(-1, -2)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=I_com.dtype, device=I_com.device).expand(I_com.shape)
    top = torch.cat([I_com + m * (c @ ct), m * c], dim=-1)
    bot = torch.cat([m * ct, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inertia_mul(mass, com, I_com, m_vec):
    """I @ v without forming the 6x6 matrix."""
    w, v = m_vec[..., :3], m_vec[..., 3:]
    F = mass[..., None] * (v + _cross(w, com))
    n = _mv(I_com, w) + _cross(com, F)
    return torch.cat([n, F], dim=-1)


def force_xform(R, p):
    """6x6 force transform child -> parent: [[R, p~ R], [0, R]]."""
    Z = torch.zeros_like(R)
    top = torch.cat([R, skew(p) @ R], dim=-1)
    bot = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def transform_inertia_to_parent(R, p, IA):
    """Articulated inertia child -> parent coordinates: Y IA Y^T."""
    Y = force_xform(R, p)
    return Y @ IA @ Y.transpose(-1, -2)
