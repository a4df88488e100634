"""Shared task math: heading/up projections, local-frame rotations,
unscaling, spawn-height solving. Port of ``thormang_isaacgym_tpu/tasks/common.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.models.robot import (
    GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE, RobotModel,
)


def compute_heading_and_up(torso_quat, inv_start_quat, to_target, vec0, vec1):
    """(torso_quat_rel, up_proj, heading_proj, up_vec, heading_vec), up = z."""
    tq = Q.mul(torso_quat, inv_start_quat)
    up_vec = Q.rotate(tq, vec1)
    heading_vec = Q.rotate(tq, vec0)
    up_proj = up_vec[..., 2]
    tt = to_target / (torch.linalg.norm(to_target, dim=-1, keepdim=True) + 1e-8)
    heading_proj = torch.sum(heading_vec * tt, dim=-1)
    return tq, up_proj, heading_proj, up_vec, heading_vec


def compute_rot(torso_quat, velocity, ang_velocity, targets, torso_pos):
    """(vel_loc, angvel_loc, roll, pitch, yaw, angle_to_target)."""
    vel_loc = Q.rotate_inv(torso_quat, velocity)
    angvel_loc = Q.rotate_inv(torso_quat, ang_velocity)
    roll, pitch, yaw = Q.to_euler_xyz(torso_quat)
    d = targets - torso_pos
    angle_to_target = torch.atan2(d[..., 1], d[..., 0]) - yaw
    return vel_loc, angvel_loc, roll, pitch, yaw, angle_to_target


def unscale(x, lower, upper):
    """Map [lower, upper] -> [-1, 1]."""
    return (2.0 * x - upper - lower) / (upper - lower + 1e-8)


def normalize_angle(x):
    return Q.wrap_to_pi(x)


def initial_dof_pos(lower: np.ndarray, upper: np.ndarray) -> np.ndarray:
    """Clamp 0 into each joint's limit interval."""
    pos = np.zeros_like(lower)
    pos = np.where(lower > 0, lower, pos)
    pos = np.where(upper < 0, upper, pos)
    return pos.astype(np.float32)


def solve_spawn_height(model: RobotModel, joint_q: np.ndarray,
                       clearance: float = 0.01) -> float:
    """Root z so the lowest collision-geom point touches the ground at the
    given joint pose (host side, at construction)."""
    from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics

    q = np.zeros(model.nq, np.float32)
    if model.floating:
        q[3] = 1.0
        q[7:] = joint_q
    else:
        q[:] = joint_q
    frames = forward_kinematics(model, torch.as_tensor(q)[None], torch.zeros(1, model.nv))
    pos, quat = frames.pos[0], frames.quat[0]
    zaxis = torch.tensor([0.0, 0.0, 1.0])
    zmin = 0.0
    for g in model.geoms:
        bp, bq = pos[g.body], quat[g.body]
        gp = (bp + Q.rotate(bq, torch.tensor(g.pos, dtype=torch.float32))).numpy()
        gq = Q.mul(bq, torch.tensor(g.quat, dtype=torch.float32))
        if g.gtype == GEOM_SPHERE:
            z = gp[2] - g.size[0]
        elif g.gtype == GEOM_CAPSULE:
            axis = Q.rotate(gq, zaxis).numpy()
            z = min(gp[2] + s * g.size[1] * axis[2] for s in (-1, 1)) - g.size[0]
        elif g.gtype == GEOM_CYLINDER:
            axis = Q.rotate(gq, zaxis).numpy()
            drop = g.size[0] * np.sqrt(max(1e-9, 1 - axis[2] ** 2))
            z = min(gp[2] + s * g.size[1] * axis[2] for s in (-1, 1)) - drop
        else:  # box corners
            R = Q.to_matrix(gq).numpy()
            hx, hy, hz = g.size
            z = min((gp + R @ np.array([sx * hx, sy * hy, sz * hz]))[2]
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1))
        zmin = min(zmin, float(z))
    return -zmin + clearance
