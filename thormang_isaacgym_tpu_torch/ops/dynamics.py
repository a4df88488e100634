"""Articulated-body forward dynamics (Featherstone ABA), batched over envs.

Port of ``thormang_isaacgym_tpu/ops/dynamics.py`` (``aba``,
``joint_reflected_inertia``, ``articulated_joint_inertia``,
``passive_forces``, ``drive_forces``) on (B, ...) tensors, one tree depth
level per op:

- gravity enters as an explicit per-body force, so a floating base is a
  plain 6x6 solve: a_root = -IA^{-1} pA;
- locked joints inflate the joint-space inertia D (``_LOCK_BIG``);
- implicit (backward-Euler) joint drives and passive impedances add to the
  joint-space diagonal through ``extra_diag``.

All quantities are link-local; motion vectors are (omega, v).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.core import spatial as sp
from thormang_isaacgym_tpu_torch.models.robot import ModelParams, RobotModel
from thormang_isaacgym_tpu_torch.ops.kinematics import (
    consts, joint_local_pose, split_q, split_qd,
)

_LOCK_BIG = 1e12


def aba(model: RobotModel, params: ModelParams, q: torch.Tensor,
        qd: torch.Tensor, tau: torch.Tensor, f_ext: torch.Tensor,
        gravity: torch.Tensor, precomputed=None,
        extra_diag: torch.Tensor | None = None,
        extra_body_inertia: torch.Tensor | None = None) -> torch.Tensor:
    """qdd (B, nv) = [root accelerations, joint qdd].

    tau (B, nj) joint forces; f_ext (B, nb, 6) link-frame spatial forces about
    the link origin; gravity (B, 3); params batched (B, ...);
    precomputed = (pos_local, quat_local, quat_w) shares work with FK;
    extra_diag (B, nj) joins the joint-space diagonal D;
    extra_body_inertia (B, nb, 6, 6) link frame joins each body's spatial
    inertia before the inward sweep (the implicit pair-contact reaction,
    ops/collide.py).
    """
    c = consts(model, q.device)
    S_all = c["S"]
    B, nb, nr = q.shape[0], model.nb, model.n_roots
    _, root_quat, joint_q = split_q(model, q)
    root_omega_b, root_v_w, joint_qd = split_qd(model, qd)
    root_v_b = Q.rotate_inv(root_quat, root_v_w)
    if precomputed is not None:
        pos_local, quat_local, quat_w = precomputed
    else:
        pos_local, quat_local = joint_local_pose(model, joint_q)
        quat_w = None
    R_loc = Q.to_matrix(quat_local)                     # (B, nj, 3, 3)

    # ---- pass 1: velocities + bias terms (outward) ----
    v_c = [torch.cat([root_omega_b, root_v_b], dim=-1)]
    c_c = [q.new_zeros(B, nr, 6)]
    qw_c = [root_quat] if quat_w is None else None
    for lv in c["levels"]:
        j = slice(lv["start"] - nr, lv["end"] - nr)
        p = lv["parent_local"]
        vj = S_all[j] * joint_qd[:, j, None]
        vi = sp.motion_to_child(R_loc[:, j], pos_local[:, j], v_c[-1][:, p]) + vj
        v_c.append(vi)
        c_c.append(sp.cross_motion(vi, vj))
        if qw_c is not None:
            qw_c.append(Q.mul(qw_c[-1][:, p], quat_local[:, j]))
    v = torch.cat(v_c, 1)
    if quat_w is None:
        quat_w = torch.cat(qw_c, 1)

    # ---- body spatial inertias + bias forces ----
    mass, com, I_com = params.body_mass, params.body_com, params.body_inertia
    IA_full = sp.inertia_matrix(mass, com, I_com)       # (B, nb, 6, 6)
    if extra_body_inertia is not None:
        IA_full = IA_full + extra_body_inertia
    Iv = sp.inertia_mul(mass, com, I_com, v)
    g_local = Q.rotate_inv(quat_w, gravity[:, None, :].expand(B, nb, 3))
    g_local = g_local * params.body_gravity_scale[..., None]
    mg = mass[..., None] * g_local
    f_grav = torch.cat([torch.linalg.cross(com, mg, dim=-1), mg], dim=-1)
    pA_full = sp.cross_force(v, Iv) - f_ext - f_grav

    levels = c["levels"]
    IA_c = [IA_full[:, 0:nr]] + [IA_full[:, lv["start"]:lv["end"]] for lv in levels]
    pA_c = [pA_full[:, 0:nr]] + [pA_full[:, lv["start"]:lv["end"]] for lv in levels]

    # ---- pass 2: articulated inertia (inward) ----
    U_c, D_c, u_c = [None] * len(levels), [None] * len(levels), [None] * len(levels)
    for k in range(len(levels) - 1, -1, -1):
        lv = levels[k]
        j = slice(lv["start"] - nr, lv["end"] - nr)
        Sj = S_all[j]
        IA_L = IA_c[k + 1]
        Ui = (IA_L @ Sj[:, :, None])[..., 0]
        Di = (torch.sum(Sj * Ui, dim=-1) + params.dof_armature[:, j]
              + params.dof_locked[:, j] * _LOCK_BIG)
        if extra_diag is not None:
            Di = Di + extra_diag[:, j]
        ui = tau[:, j] - torch.sum(Sj * pA_c[k + 1], dim=-1)
        U_c[k], D_c[k], u_c[k] = Ui, Di, ui
        Ia = IA_L - Ui[..., :, None] * (Ui[..., None, :] / Di[..., None, None])
        pa = pA_c[k + 1] + (Ia @ c_c[k + 1][..., None])[..., 0] + Ui * (ui / Di)[..., None]
        IA_t = sp.transform_inertia_to_parent(R_loc[:, j], pos_local[:, j], Ia)
        pa_t = sp.force_to_parent(R_loc[:, j], pos_local[:, j], pa)
        p = lv["parent_local"]
        IA_c[k] = IA_c[k].index_add(1, p, IA_t)
        pA_c[k] = pA_c[k].index_add(1, p, pa_t)

    # ---- pass 3: accelerations (outward) ----
    if model.n_floating > 0:
        eye = torch.eye(6, dtype=q.dtype, device=q.device)
        a_solve = -torch.linalg.solve(IA_c[0] + 1e-9 * eye, pA_c[0][..., None])[..., 0]
        a_root = a_solve * c["float_mask"][:, None]
    else:
        a_root = q.new_zeros(B, nr, 6)
    a_c, qdd_c = [a_root], []
    for k, lv in enumerate(levels):
        j = slice(lv["start"] - nr, lv["end"] - nr)
        p = lv["parent_local"]
        a_p = sp.motion_to_child(R_loc[:, j], pos_local[:, j], a_c[-1][:, p]) + c_c[k + 1]
        qdd_i = (u_c[k] - torch.sum(U_c[k] * a_p, dim=-1)) / D_c[k]
        a_c.append(a_p + S_all[j] * qdd_i[..., None])
        qdd_c.append(qdd_i)
    qdd_j = torch.cat(qdd_c, 1) if qdd_c else q.new_zeros(B, 0)
    qdd_j = qdd_j * (1.0 - params.dof_locked)
    if model.n_floating == 0:
        return qdd_j
    # floating roots: the spatial linear acceleration is the derivative of
    # the body-frame velocity; the integrator wants dv_w/dt = R (a + w x v_b)
    a_ang = a_root[..., 0:3]
    a_lin_w = Q.rotate(root_quat, a_root[..., 3:6]
                       + torch.linalg.cross(root_omega_b, root_v_b, dim=-1))
    a_pack = torch.cat([a_ang, a_lin_w], dim=-1)
    rows = [a_pack[:, r] for r in range(nr) if model.roots_floating[r]]
    return torch.cat(rows + [qdd_j], dim=-1)


def joint_reflected_inertia(model: RobotModel, params: ModelParams) -> torch.Tensor:
    """(B, nj) lower bound of each joint's reflected inertia: S^T I_child S +
    armature (the child body's spatial inertia about its own origin along
    the joint axis)."""
    S = consts(model, params.body_mass.device)["S"]                  # (nj, 6)
    nr = model.n_roots
    Ic = sp.inertia_matrix(params.body_mass[:, nr:], params.body_com[:, nr:],
                           params.body_inertia[:, nr:])                # (B, nj, 6, 6)
    return torch.sum(S * (Ic @ S[:, :, None])[..., 0], dim=-1) + params.dof_armature


def articulated_joint_inertia(model: RobotModel, params: ModelParams,
                              joint_q: torch.Tensor, precomputed=None) -> torch.Tensor:
    """(B, nj) each joint's apparent inertia at `joint_q` (B, nj): D_i =
    S_i^T IA_i S_i + armature from the articulated-body recursion (the ABA's
    pass 2 without the bias terms); a locked downstream joint passes its
    whole subtree's inertia on. `precomputed` = (pos_local, quat_local)."""
    c = consts(model, joint_q.device)
    S_all, nr = c["S"], model.n_roots
    pos_local, quat_local = precomputed if precomputed is not None else \
        joint_local_pose(model, joint_q)
    R_loc = Q.to_matrix(quat_local)
    IA_full = sp.inertia_matrix(params.body_mass, params.body_com, params.body_inertia)
    levels = c["levels"]
    IA_c = [IA_full[:, 0:nr]] + [IA_full[:, lv["start"]:lv["end"]] for lv in levels]
    D_c = [None] * len(levels)
    for k in range(len(levels) - 1, -1, -1):
        lv = levels[k]
        j = slice(lv["start"] - nr, lv["end"] - nr)
        Sj = S_all[j]
        IA_L = IA_c[k + 1]
        Ui = (IA_L @ Sj[:, :, None])[..., 0]
        Di = torch.sum(Sj * Ui, dim=-1) + params.dof_armature[:, j]
        D_c[k] = Di
        D_proj = Di + params.dof_locked[:, j] * _LOCK_BIG
        Ia = IA_L - Ui[..., :, None] * (Ui[..., None, :] / D_proj[..., None, None])
        IA_t = sp.transform_inertia_to_parent(R_loc[:, j], pos_local[:, j], Ia)
        IA_c[k] = IA_c[k].index_add(1, lv["parent_local"], IA_t)
    return torch.cat(D_c, 1) if D_c else joint_q.new_zeros(joint_q.shape[0], 0)


def passive_forces(params: ModelParams, joint_q: torch.Tensor,
                   joint_qd: torch.Tensor, h: float,
                   limit_stiffness: float = 2000.0,
                   limit_damping: float = 50.0,
                   friction_vel_scale: float = 0.05,
                   tendons=()):
    """Passive joint forces in implicit form: (tau_explicit, diag).

    damping -c qd (diag h c); bounded tanh dry friction (explicit); limit
    spring-damper active in violation, spring at the predicted position
    q + h qd (diag h^2 k + h d). Fixed tendons (``RobotModel.tendons``,
    (coef (nj,), lo, hi, name)): the length L = C q is held to [lo, hi] by a
    backward-Euler limit spring (params.tendon_stiffness / tendon_damping,
    (B, nt)); its torque C^T f joins tau and the diagonal of the rank-1
    coupling, (C o C)^T (in_vio h^2 k + h d), joins diag."""
    c = params.dof_damping
    tau = -c * joint_qd
    diag = h * c
    tau = tau - params.dof_friction * torch.tanh(joint_qd / friction_vel_scale)
    zero = torch.zeros_like(joint_q)
    below = torch.clamp(joint_q - params.dof_lower, max=0.0)
    above = torch.clamp(joint_q - params.dof_upper, min=0.0)
    below = torch.where(torch.isfinite(params.dof_lower), below, zero)
    above = torch.where(torch.isfinite(params.dof_upper), above, zero)
    violation = below + above
    in_violation = ((below < 0) | (above > 0)).to(joint_q.dtype)
    tau = tau + in_violation * (-limit_stiffness * (violation + h * joint_qd)
                                - limit_damping * joint_qd)
    diag = diag + in_violation * (h * h * limit_stiffness + h * limit_damping)
    if tendons:
        C, lo, hi = tendon_tables(tuple(tendons), joint_q.device)
        L = joint_q @ C.t()
        Ld = joint_qd @ C.t()
        below_t = torch.clamp(L - lo, max=0.0)
        above_t = torch.clamp(L - hi, min=0.0)
        viol = below_t + above_t
        in_vio = ((below_t < 0) | (above_t > 0)).to(joint_q.dtype)
        k_t, d_t = params.tendon_stiffness, params.tendon_damping
        f_t = in_vio * (-k_t * (viol + h * Ld)) - d_t * Ld        # per-tendon force
        tau = tau + f_t @ C
        diag_t = in_vio * (h * h * k_t) + h * d_t
        diag = diag + diag_t @ (C * C)
    return tau, diag


@lru_cache(maxsize=16)
def tendon_tables(tendons: tuple, device) -> tuple:
    """(C (nt, nj), lo (nt,), hi (nt,)) float32 on `device`, built once: a
    constant made per call would be a host copy."""
    return tuple(torch.as_tensor(np.array([t[k] for t in tendons], np.float32), device=device)
                 for k in (0, 1, 2))


def tendon_sums(tendons: tuple, x: torch.Tensor) -> torch.Tensor:
    """(B, nt) C x for joint values x (B, nj), each tendon's terms added one
    at a time from 0 in ascending joint order, as the kernel adds them: what
    counts the env-tendons lying exactly on a bound as the kernel sees them
    (a matmul, as ``passive_forces`` uses, may fuse or reorder the terms)."""
    out = x.new_zeros(x.shape[0], len(tendons))
    for k, t in enumerate(tendons):
        coef = np.asarray(t[0], np.float32)
        for j in np.flatnonzero(coef):
            out[:, k] = out[:, k] + float(coef[j]) * x[:, j]
    return out


def drive_forces(params: ModelParams, joint_q: torch.Tensor,
                 joint_qd: torch.Tensor, target_pos: torch.Tensor,
                 target_vel: torch.Tensor, effort: torch.Tensor, h: float):
    """Implicit actuator model, DOF_MODE_POS / VEL / EFFORT, clamped to
    +/- drive_effort_limit: (tau, diag)."""
    kp, kd, mode = params.drive_stiffness, params.drive_damping, params.drive_mode
    dt = joint_q.dtype
    pos_m, vel_m, eff_m = (mode == 1).to(dt), (mode == 2).to(dt), (mode == 3).to(dt)
    pd = kp * (target_pos - joint_q - h * joint_qd) - kd * joint_qd
    vel = kd * (target_vel - joint_qd)
    tau = pos_m * pd + vel_m * vel + eff_m * effort
    lim = params.drive_effort_limit
    tau = torch.minimum(torch.maximum(tau, -lim), lim)
    diag = pos_m * (h * h * kp + h * kd) + vel_m * (h * kd)
    return tau, diag
