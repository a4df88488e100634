"""Jacobians, joint-space mass matrix, and inverse dynamics (RNEA).

Port of ``thormang_isaacgym_tpu/ops/inertia.py`` on batched (B, ...)
tensors: the reference's jacobian / mass-matrix tensor API
(``acquire_jacobian_tensor`` + ``acquire_mass_matrix_tensor``, used by the
reference's ``franka_cube_stack.py:390-396`` and
``factory/factory_base.py:163-260``) as functions of (q,) or (q, qd).

Conventions (every function batched over a leading env axis):
- Jacobians are WORLD-frame, angular part first, about the body-frame origin
  (which for this model is the child-joint anchor, as in IsaacGym).
- Generalized-velocity columns: [per floating root (body order):
  (omega_world 3, v_world 3)] then the nj 1-DOF joints. The root angular
  columns are world-frame here (the dynamics state carries the root omega
  in the BODY frame; rotate with the root quat to convert). For fixed-base
  robots (Franka / Factory) the layouts coincide (joints only).
- The mass matrix is H = sum_b J_b^T I_b J_b in those coordinates; its
  joint-joint block is the joint-space inertia used by OSC and task-space
  impedance control.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.core import spatial as sp
from thormang_isaacgym_tpu_torch.models.robot import ModelParams, RobotModel
from thormang_isaacgym_tpu_torch.ops.kinematics import (
    BodyFrames, consts, forward_kinematics, joint_local_pose, split_q, split_qd,
)


@lru_cache(maxsize=64)
def _ancestor_mask(model: RobotModel) -> np.ndarray:
    """(nb, nj) float mask: M[b, j] = 1 iff joint j (child body j + n_roots)
    lies on the path from b's root to b."""
    nb, nr = model.nb, model.n_roots
    parent = np.array(model.parent, np.int32)
    mask = np.zeros((nb, nb - nr), np.float32)
    for b in range(nb):
        a = b
        while a >= nr:
            mask[b, a - nr] = 1.0
            a = parent[a]
    return mask


@lru_cache(maxsize=64)
def _root_mask(model: RobotModel) -> np.ndarray:
    """(nb, n_floating) mask: body b belongs to floating root f."""
    parent = np.array(model.parent, np.int32)
    float_roots = [r for r in range(model.n_roots) if model.roots_floating[r]]
    mask = np.zeros((model.nb, len(float_roots)), np.float32)
    for b in range(model.nb):
        r = b
        while parent[r] >= 0:
            r = parent[r]
        if r in float_roots:
            mask[b, float_roots.index(r)] = 1.0
    return mask


@lru_cache(maxsize=64)
def _tables(model: RobotModel, device: str) -> dict:
    """The masks and floating-root indices on one device (cached)."""
    return dict(amask=torch.as_tensor(_ancestor_mask(model), device=device),
                rmask=torch.as_tensor(_root_mask(model), device=device),
                float_roots=torch.as_tensor([r for r in range(model.n_roots)
                                             if model.roots_floating[r]],
                                            dtype=torch.long, device=device))


def num_cols(model: RobotModel) -> int:
    return 6 * model.n_floating + model.nj


def _frames(model: RobotModel, q: torch.Tensor, frames):
    return frames if frames is not None else \
        forward_kinematics(model, q, q.new_zeros(q.shape[0], model.nv))


def body_jacobians(model: RobotModel, q: torch.Tensor,
                   frames: BodyFrames | None = None) -> torch.Tensor:
    """World-frame spatial jacobian of every body: (B, nb, 6, ncols).

    Row layout per body: [omega_w (3); v_w of the body origin (3)]; the
    column layout is the module docstring's."""
    frames = _frames(model, q, frames)
    nr, nb = model.n_roots, model.nb
    c = consts(model, q.device)
    t = _tables(model, str(q.device))
    B = q.shape[0]
    # joint world axis and anchor (the child body's origin sits on the axis)
    axis_w = Q.rotate(frames.quat[:, nr:], c["axis"])               # (B, nj, 3)
    anchor = frames.pos[:, nr:]
    r = frames.pos[:, :, None, :] - anchor[:, None, :, :]           # (B, nb, nj, 3)
    axis_b = axis_w[:, None].expand(r.shape)
    # revolute: Jang = axis_w, Jlin = axis_w x (p_b - anchor); prismatic: 0, axis_w
    rev = c["is_rev"][None, None, :, None] > 0
    Jlin = torch.where(rev, torch.linalg.cross(axis_b, r, dim=-1), axis_b)
    Jang = torch.where(rev, axis_b, torch.zeros_like(axis_b))
    Jj = torch.cat([Jang, Jlin], -1) * t["amask"][None, :, :, None]  # (B, nb, nj, 6)
    Jj = Jj.transpose(2, 3)                                          # (B, nb, 6, nj)
    nf = model.n_floating
    if nf == 0:
        return Jj
    # floating-root columns: unit world twists about the root origin;
    # angular col k: [e_k; e_k x d] with e_k x d the k-th column of -skew(d)
    d = frames.pos[:, :, None, :] - frames.pos[:, t["float_roots"]][:, None]  # (B, nb, nf, 3)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(B, nb, nf, 3, 3)
    Jr_ang = torch.cat([eye, -sp.skew(d)], -2)                       # (B, nb, nf, 6, 3)
    Jr_lin = torch.cat([torch.zeros_like(eye), eye], -2)
    Jr = torch.cat([Jr_ang, Jr_lin], -1) * t["rmask"][None, :, :, None, None]
    Jr = Jr.transpose(2, 3).reshape(B, nb, 6, 6 * nf)
    return torch.cat([Jr, Jj], -1)


def point_jacobian(model: RobotModel, q: torch.Tensor, body: int,
                   offset=(0.0, 0.0, 0.0),
                   frames: BodyFrames | None = None) -> torch.Tensor:
    """(B, 6, ncols) world jacobian of a point rigidly attached to `body` at
    `offset` (body frame; a 3-tuple, or a tensor on q's device, which spares
    the host copy): the gym jacobian tensor sliced at a fingertip or hand
    link (the reference's ``franka_cube_stack.py:392``)."""
    frames = _frames(model, q, frames)
    J = body_jacobians(model, q, frames)[:, body]
    off = offset if torch.is_tensor(offset) else q.new_tensor(offset)
    r = Q.rotate(frames.quat[:, body], off.expand(q.shape[0], 3))
    # v_point = v_origin + omega x r  ->  Jlin_point = Jlin - skew(r) Jang
    Jang, Jlin = J[:, :3], J[:, 3:]
    return torch.cat([Jang, Jlin - sp.skew(r) @ Jang], 1)


def world_spatial_inertia(model: RobotModel, params: ModelParams,
                          frames: BodyFrames) -> torch.Tensor:
    """(B, nb, 6, 6) spatial inertia of each body about its own origin, in
    world coordinates."""
    R = Q.to_matrix(frames.quat)                                     # (B, nb, 3, 3)
    com_w = (R @ params.body_com[..., None])[..., 0]
    I_w = R @ params.body_inertia @ R.transpose(-1, -2)
    return sp.inertia_matrix(params.body_mass, com_w, I_w)


def mass_matrix(model: RobotModel, params: ModelParams, q: torch.Tensor,
                frames: BodyFrames | None = None) -> torch.Tensor:
    """(B, ncols, ncols) generalized mass matrix H(q) = sum_b J_b^T I_b J_b,
    plus armature on the joint diagonal: for a fixed-base arm, the joint
    block equals PhysX's ``acquire_mass_matrix_tensor``
    (the reference's ``factory_base.py:228``)."""
    frames = _frames(model, q, frames)
    J = body_jacobians(model, q, frames)                             # (B, nb, 6, nc)
    I = world_spatial_inertia(model, params, frames)                 # (B, nb, 6, 6)
    H = torch.einsum("nbic,nbij,nbjd->ncd", J, I, J)
    arm = torch.cat([params.dof_armature.new_zeros(q.shape[0], 6 * model.n_floating),
                     params.dof_armature], -1)
    return H + torch.diag_embed(arm)


def inverse_dynamics(model: RobotModel, params: ModelParams,
                     q: torch.Tensor, qd: torch.Tensor,
                     joint_qdd: torch.Tensor | None = None,
                     root_qdd: torch.Tensor | None = None,
                     gravity: torch.Tensor | None = None) -> torch.Tensor:
    """Recursive Newton-Euler: generalized forces (B, nj) that realize the
    given joint accelerations at state (q, qd) under gravity.

    ``inverse_dynamics(m, p, q, qd)`` is C(q, qd) qd + g(q), the inertial
    compensation term of the factory controllers. `root_qdd` (B, 6)
    optionally prescribes the floating roots' acceleration in the body frame;
    default 0 (root held). One batched op per depth level, as the ABA."""
    c = consts(model, q.device)
    S_all = c["S"]
    nr, B = model.n_roots, q.shape[0]
    if gravity is None:
        gravity = params.gravity
    if joint_qdd is None:
        joint_qdd = q.new_zeros(B, model.nj)
    _, root_quat, joint_q = split_q(model, q)
    root_omega_b, root_v_w, joint_qd = split_qd(model, qd)
    root_v_b = Q.rotate_inv(root_quat, root_v_w)
    pos_local, quat_local = joint_local_pose(model, joint_q)
    R_loc = Q.to_matrix(quat_local)

    # outward: velocities and accelerations (gravity as the root accelerating
    # upward at -g, in each root's link frame)
    v_c = [torch.cat([root_omega_b, root_v_b], -1)]
    g_root = Q.rotate_inv(root_quat, gravity[:, None, :].expand(B, nr, 3))
    a0 = torch.cat([torch.zeros_like(g_root), -g_root], -1)
    if root_qdd is not None:
        a0 = a0 + root_qdd[:, None, :]
    a_c = [a0]
    levels = c["levels"]
    for lv in levels:
        j = slice(lv["start"] - nr, lv["end"] - nr)
        p = lv["parent_local"]
        Sj = S_all[j]
        vj = Sj * joint_qd[:, j, None]
        vi = sp.motion_to_child(R_loc[:, j], pos_local[:, j], v_c[-1][:, p]) + vj
        ai = sp.motion_to_child(R_loc[:, j], pos_local[:, j], a_c[-1][:, p]) \
            + Sj * joint_qdd[:, j, None] + sp.cross_motion(vi, vj)
        v_c.append(vi)
        a_c.append(ai)

    # inward: f_i = I a_i + v x* (I v); tau_i = S^T f_i; accumulate to the parent
    mass, com, I_com = params.body_mass, params.body_com, params.body_inertia
    f_c = []
    for k in range(len(levels) + 1):
        lo = 0 if k == 0 else levels[k - 1]["start"]
        hi = nr if k == 0 else levels[k - 1]["end"]
        m_, c_, I_ = mass[:, lo:hi], com[:, lo:hi], I_com[:, lo:hi]
        f_c.append(sp.inertia_mul(m_, c_, I_, a_c[k])
                   + sp.cross_force(v_c[k], sp.inertia_mul(m_, c_, I_, v_c[k])))
    tau_c = [None] * len(levels)
    for k in range(len(levels) - 1, -1, -1):
        lv = levels[k]
        j = slice(lv["start"] - nr, lv["end"] - nr)
        tau_c[k] = torch.sum(S_all[j] * f_c[k + 1], -1)
        f_t = sp.force_to_parent(R_loc[:, j], pos_local[:, j], f_c[k + 1])
        f_c[k] = f_c[k].index_add(1, lv["parent_local"], f_t)
    tau = torch.cat(tau_c, -1) if tau_c else q.new_zeros(B, 0)
    return tau + params.dof_armature * joint_qdd


def gravity_compensation(model: RobotModel, params: ModelParams,
                         q: torch.Tensor) -> torch.Tensor:
    """g(q): the joint torques (B, nj) that cancel gravity (root held)."""
    return inverse_dynamics(model, params, q, q.new_zeros(q.shape[0], model.nv))
