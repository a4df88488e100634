"""Forward kinematics: generalized state -> world body poses and velocities.

Port of ``thormang_isaacgym_tpu/ops/kinematics.py`` on batched (B, ...)
tensors, one depth level per op (ops/levels.py).

State layout (floating roots first, then the 1-DOF joints):
  q  = [pos_w (3), quat_wxyz (4)] per floating root + joint_q (nj)
  qd = [omega_body (3), v_world (3)] per floating root + joint_qd (nj)
Root angular velocity is in the BODY frame, root linear velocity in the
WORLD frame (MuJoCo free-joint convention).
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.models.robot import RobotModel
from thormang_isaacgym_tpu_torch.ops.levels import level_structure, static_arrays


class BodyFrames(NamedTuple):
    """World-frame pose and velocity of every body, (B, nb, ...)."""
    pos: torch.Tensor    # (B, nb, 3) body-frame origin in world
    quat: torch.Tensor   # (B, nb, 4) wxyz body -> world
    omega: torch.Tensor  # (B, nb, 3) angular velocity, world frame
    vel: torch.Tensor    # (B, nb, 3) linear velocity of the body origin, world


@lru_cache(maxsize=64)
def model_consts(model: RobotModel, device: str) -> dict:
    """Static per-model tensors on one device (cached)."""
    _, axis, is_rev, S = static_arrays(model)
    nr = model.n_roots
    base = np.array(model.root_base_pose if model.root_base_pose is not None
                    else [(0, 0, 0, 1, 0, 0, 0)] * nr, np.float32)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return dict(
        axis=t(axis), is_rev=t(is_rev[:, 0]), S=t(S),
        j_pos=t(np.array(model.joint_pos, np.float32).reshape(-1, 3)),
        j_quat=t(np.array(model.joint_quat, np.float32).reshape(-1, 4)),
        base=t(base),
        float_mask=t(np.array(model.roots_floating, np.float32)),
        levels=[dict(lv, parent_local=t(lv["parent_local"], torch.long))
                for lv in level_structure(model)],
    )


def consts(model: RobotModel, device) -> dict:
    return model_consts(model, str(torch.device(device)))


def split_q(model: RobotModel, q: torch.Tensor):
    """(root_pos (B,nr,3), root_quat (B,nr,4), joint_q (B,nj)); fixed roots
    take the model's static base pose."""
    B = q.shape[0]
    nr, nf = model.n_roots, model.n_floating
    flags = model.roots_floating
    root_block = q[:, :7 * nf].reshape(B, nf, 7)
    joint_q = q[:, 7 * nf:]
    if nr == 1 and flags[0]:
        return root_block[:, :, 0:3], root_block[:, :, 3:7], joint_q
    base = consts(model, q.device)["base"]
    pos_rows, quat_rows, fi = [], [], 0
    for r in range(nr):
        if flags[r]:
            pos_rows.append(root_block[:, fi, 0:3])
            quat_rows.append(root_block[:, fi, 3:7])
            fi += 1
        else:
            pos_rows.append(base[r, 0:3].expand(B, 3))
            quat_rows.append(base[r, 3:7].expand(B, 4))
    return torch.stack(pos_rows, 1), torch.stack(quat_rows, 1), joint_q


def split_qd(model: RobotModel, qd: torch.Tensor):
    """(root_omega_body (B,nr,3), root_v_world (B,nr,3), joint_qd (B,nj));
    fixed roots are 0."""
    B = qd.shape[0]
    nr, nf = model.n_roots, model.n_floating
    flags = model.roots_floating
    root_block = qd[:, :6 * nf].reshape(B, nf, 6)
    joint_qd = qd[:, 6 * nf:]
    if nr == 1 and flags[0]:
        return root_block[:, :, 0:3], root_block[:, :, 3:6], joint_qd
    zero = qd.new_zeros(B, 3)
    om_rows, v_rows, fi = [], [], 0
    for r in range(nr):
        if flags[r]:
            om_rows.append(root_block[:, fi, 0:3])
            v_rows.append(root_block[:, fi, 3:6])
            fi += 1
        else:
            om_rows.append(zero)
            v_rows.append(zero)
    return torch.stack(om_rows, 1), torch.stack(v_rows, 1), joint_qd


def joint_local_pose(model: RobotModel, joint_q: torch.Tensor):
    """Pose of each non-root body in its parent frame: (B,nj,3), (B,nj,4)."""
    c = consts(model, joint_q.device)
    axis, is_rev = c["axis"], c["is_rev"]
    q_rot = Q.from_axis_angle(axis, joint_q * is_rev)
    quat_local = Q.mul(c["j_quat"], q_rot)
    trans = axis * (joint_q * (1.0 - is_rev))[..., None]
    pos_local = c["j_pos"] + Q.rotate(c["j_quat"], trans)
    return pos_local, quat_local


def forward_kinematics(model: RobotModel, q: torch.Tensor, qd: torch.Tensor,
                       local=None) -> BodyFrames:
    """World pose + velocity of all bodies. `local` optionally supplies the
    (pos_local, quat_local) of :func:`joint_local_pose`."""
    root_pos, root_quat, joint_q = split_q(model, q)
    root_omega_b, root_v_w, joint_qd = split_qd(model, qd)
    pos_local, quat_local = local if local is not None else joint_local_pose(model, joint_q)
    c = consts(model, q.device)
    axis, is_rev = c["axis"], c["is_rev"]
    nr = model.n_roots
    pos_c, quat_c = [root_pos], [root_quat]
    om_c = [Q.rotate(root_quat, root_omega_b)]
    vel_c = [root_v_w]
    for lv in c["levels"]:
        j = slice(lv["start"] - nr, lv["end"] - nr)
        p = lv["parent_local"]
        pp, pq = pos_c[-1][:, p], quat_c[-1][:, p]
        pom, pvl = om_c[-1][:, p], vel_c[-1][:, p]
        pw = pp + Q.rotate(pq, pos_local[:, j])
        qw = Q.mul(pq, quat_local[:, j])
        axis_w = Q.rotate(qw, axis[j])
        qdj = joint_qd[:, j, None]
        rev = is_rev[j, None]
        om = pom + axis_w * (qdj * rev)
        vl = pvl + torch.linalg.cross(pom, pw - pp, dim=-1) + axis_w * (qdj * (1.0 - rev))
        pos_c.append(pw)
        quat_c.append(qw)
        om_c.append(om)
        vel_c.append(vl)
    return BodyFrames(pos=torch.cat(pos_c, 1), quat=torch.cat(quat_c, 1),
                      omega=torch.cat(om_c, 1), vel=torch.cat(vel_c, 1))


def geom_world_poses(model: RobotModel, frames: BodyFrames):
    """World pose of every collision geom: (B, ng, 3) pos, (B, ng, 4) quat,
    and the (B, ng, 3) angular and linear velocity of the geom origin."""
    dev = frames.pos.device
    gbody = torch.as_tensor([g.body for g in model.geoms], dtype=torch.long, device=dev)
    gpos = torch.as_tensor(np.array([g.pos for g in model.geoms], np.float32).reshape(-1, 3),
                           device=dev)
    gquat = torch.as_tensor(np.array([g.quat for g in model.geoms], np.float32).reshape(-1, 4),
                            device=dev)
    bpos, bquat = frames.pos[:, gbody], frames.quat[:, gbody]
    pos_w = bpos + Q.rotate(bquat, gpos.expand_as(bpos))
    quat_w = Q.mul(bquat, gquat.expand_as(bquat))
    omega_w = frames.omega[:, gbody]
    vel_w = frames.vel[:, gbody] + torch.linalg.cross(omega_w, pos_w - bpos, dim=-1)
    return pos_w, quat_w, omega_w, vel_w
