"""Analytic primitive-vs-ground contact: penalty normal force and regularized
Coulomb friction, batched over envs.

Port of ``thormang_isaacgym_tpu/ops/contact.py``. Every geom emits a static
number of candidate points: sphere 1 (centre, radius r), capsule 2 (cap
centres, r), cylinder 2 (lowest rim point of each face), box 8 (corners).
All candidates are evaluated and masked by penetration. The ground is a flat
plane at a constant height, or a sloped surface (a heightfield) whose local
plane under each candidate gives the contact normal.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.models.robot import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE, ModelParams, RobotModel,
)
from thormang_isaacgym_tpu_torch.ops.kinematics import BodyFrames


@lru_cache(maxsize=64)
def candidates(model: RobotModel) -> dict:
    """Static candidate table over the M candidate points (numpy): geom, body,
    geom pose in the body, offset in the geom, radius, rim flag."""
    geom, offs, radii, rim = [], [], [], []
    for gi, g in enumerate(model.geoms):
        if not getattr(g, "ground", True):
            continue
        if g.gtype == GEOM_SPHERE:
            geom.append(gi); offs.append((0, 0, 0)); radii.append(g.size[0]); rim.append(0)
        elif g.gtype == GEOM_CAPSULE:
            r, hl = g.size
            for s in (-1, 1):
                geom.append(gi); offs.append((0, 0, s * hl)); radii.append(r); rim.append(0)
        elif g.gtype == GEOM_CYLINDER:
            r, hw = g.size
            for s in (-1, 1):
                geom.append(gi); offs.append((0, 0, s * hw)); radii.append(r); rim.append(1)
        elif g.gtype == GEOM_BOX:
            hx, hy, hz = g.size
            for sx in (-1, 1):
                for sy in (-1, 1):
                    for sz in (-1, 1):
                        geom.append(gi); offs.append((sx * hx, sy * hy, sz * hz))
                        radii.append(0.0); rim.append(0)
    geom = np.array(geom, np.int64)
    return dict(
        geom=geom,
        body=np.array([model.geoms[i].body for i in geom], np.int64),
        gpos=np.array([model.geoms[i].pos for i in geom], np.float32).reshape(-1, 3),
        gquat=np.array([model.geoms[i].quat for i in geom], np.float32).reshape(-1, 4),
        off=np.array(offs, np.float32).reshape(-1, 3),
        r=np.array(radii, np.float32),
        rim=np.array(rim, np.float32),
    )


@lru_cache(maxsize=64)
def _candidate_tensors(model: RobotModel, device: str) -> dict:
    out = {k: torch.as_tensor(v, device=device) for k, v in candidates(model).items()}
    out["zhat"] = torch.tensor([0.0, 0.0, 1.0], device=device)
    return out


def candidate_points(model: RobotModel, frames: BodyFrames):
    """World points of the contact candidates before a cylinder's rim shift
    (sphere and capsule-cap centres, box corners, cylinder face centres),
    (B, C, 3), and their geoms' world quaternions (B, C, 4)."""
    c = _candidate_tensors(model, str(frames.pos.device))
    body_quat = frames.quat[:, c["body"]]
    geo_pos = frames.pos[:, c["body"]] + Q.rotate(body_quat, c["gpos"])
    geo_quat = Q.mul(body_quat, c["gquat"])
    return geo_pos + Q.rotate(geo_quat, c["off"]), geo_quat


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def ground_contact_forces(model: RobotModel, params: ModelParams,
                          frames: BodyFrames, *, stiffness: float,
                          damping: float, dt: float, friction_vel: float = 0.05,
                          plane_friction: float = 1.0, ground_z: float = 0.0,
                          max_depenetration_velocity: float = 2.0,
                          ground_grad_fn=None, planes=None):
    """Per-body ground contact: (f_ext_world (B, nb, 6) [torque about the body
    origin, force], net force (B, nb, 3)).

    The ground is the plane z = ground_z, unless it is sloped:
    ``ground_grad_fn(x, y) -> (z, dz/dx, dz/dy)`` samples the surface at each
    candidate's contact point (the op path, every substep), or ``planes``
    (B, C, 3) holds a local plane z = c + gx x + gy y per candidate, frozen
    across the substeps of a control step (the fused kernel's form,
    ``ops/fused.py`` ``ground_plane_sampler``). A sloped contact has depth
    along the unit surface normal n, its point moved by -n r, and its
    velocity split into the normal part and a 3-D tangent part.

    Spring and damper coefficients are clamped per contact to the explicit
    stability bound of the contact's effective mass (split over the body's
    active contacts); the normal force is capped so a deeply embedded contact
    exits at <= max_depenetration_velocity; friction is capped at the force
    that stops the slip in one substep."""
    B, nb = frames.pos.shape[0], model.nb
    if len(candidates(model)["geom"]) == 0:
        z = frames.pos.new_zeros(B, nb, 6)
        return z, z[..., 3:6]
    c = _candidate_tensors(model, str(frames.pos.device))
    gbody = c["body"]
    body_pos = frames.pos[:, gbody]
    omega = frames.omega[:, gbody]
    vel = frames.vel[:, gbody]

    p, geo_quat = candidate_points(model, frames)
    # cylinder rim: lowest point of the rim circle normal to the local z axis
    zhat = c["zhat"]
    a = Q.rotate(geo_quat, zhat)
    perp = zhat - a * a[..., 2:3]
    u = -perp / torch.clamp(torch.linalg.norm(perp, dim=-1, keepdim=True), min=1e-6)
    r_col, rim = c["r"], c["rim"]
    p = torch.where(rim[:, None] > 0, p + r_col[:, None] * u, p)
    eff_r = r_col * (1.0 - rim)

    sloped = planes is not None or ground_grad_fn is not None
    if sloped:
        if planes is not None:
            gx, gy = planes[..., 1], planes[..., 2]
            gz = planes[..., 0] + (gx * p[..., 0] + gy * p[..., 1])
        else:
            gz, gx, gy = ground_grad_fn(p[..., 0], p[..., 1])
        inv_nn = 1.0 / torch.sqrt(1.0 + (gx * gx + gy * gy))
        n_g = torch.stack([-gx * inv_nn, -gy * inv_nn, inv_nn], dim=-1)
        depth = (gz - p[..., 2]) * inv_nn + eff_r
        contact_p = p - n_g * eff_r[:, None]
    else:
        depth = ground_z - (p[..., 2] - eff_r)
        contact_p = torch.cat([p[..., 0:2], (p[..., 2] - eff_r)[..., None]], dim=-1)
    active = depth > 0.0

    r_arm = contact_p - body_pos
    v_p = vel + _cross(omega, r_arm)
    if sloped:
        vn = v_p[..., 0] * n_g[..., 0] + v_p[..., 1] * n_g[..., 1] + v_p[..., 2] * n_g[..., 2]
        vt = v_p - n_g * vn[..., None]
        vt_norm = torch.sqrt(vt[..., 0] * vt[..., 0] + vt[..., 1] * vt[..., 1]
                             + vt[..., 2] * vt[..., 2] + 1e-18)
    else:
        vn = v_p[..., 2]
        vt = torch.cat([v_p[..., 0:2], torch.zeros_like(vn)[..., None]], dim=-1)
        vt_norm = torch.sqrt(v_p[..., 0] * v_p[..., 0] + v_p[..., 1] * v_p[..., 1] + 1e-18)

    mu = params.geom_friction[:, c["geom"]] * plane_friction
    m_lin = params.body_mass[:, gbody]
    I_min = torch.diagonal(params.body_inertia[:, gbody], dim1=-2, dim2=-1).amin(-1)
    r_perp2 = r_arm[..., 0] ** 2 + r_arm[..., 1] ** 2
    m_rot = I_min / (r_perp2 + 1e-6)
    m_eff = torch.minimum(m_lin, torch.where(r_perp2 < 1e-6, m_lin, m_rot))
    n_active = frames.pos.new_zeros(B, nb).index_add(1, gbody, active.to(p.dtype))
    m_eff = m_eff / torch.clamp(n_active[:, gbody], min=1.0)
    kn = torch.clamp(0.25 * m_eff / dt ** 2, max=stiffness)
    kd = torch.clamp(0.5 * m_eff / dt, max=damping)
    fn = kn * depth - kd * vn
    fn = torch.where(active, torch.clamp(fn, min=0.0), torch.zeros_like(fn))
    cap = torch.where(vn > 0.0,
                      m_eff * torch.clamp(max_depenetration_velocity - vn, min=0.0) / dt,
                      torch.full_like(fn, float("inf")))
    fn = torch.clamp(torch.minimum(fn, cap), min=0.0)
    ft_mag = mu * fn * torch.tanh(vt_norm / friction_vel)
    ft_mag = torch.minimum(ft_mag, m_lin * vt_norm / dt)
    ft = -(ft_mag / torch.clamp(vt_norm, min=1e-6))[..., None] * vt
    if sloped:
        f = n_g * fn[..., None] + ft
    else:
        f = torch.cat([ft[..., 0:2], fn[..., None]], dim=-1)
    torque = _cross(r_arm, f)
    f_ext = frames.pos.new_zeros(B, nb, 6).index_add(1, gbody, torch.cat([torque, f], -1))
    return f_ext, f_ext[..., 3:6]
