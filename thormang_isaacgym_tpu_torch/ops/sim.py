"""The physics step: drives + contact + ABA + semi-implicit Euler, x substeps.

Port of ``thormang_isaacgym_tpu/ops/sim.py``. :func:`build_plain_step_fn` is
the batched op path (``_substep`` in a Python loop): the plain PyTorch
version of the fused CUDA kernel, which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against on the card.
:func:`build_step_fn` returns the fused kernel's wrapper
(``ops/fused.py``): it launches the kernel for CUDA tensors and runs the
plain version for CPU tensors.

The ground is a constant height or an ``engine.terrain.Heightfield``. Over a
heightfield the op path samples the surface (height and gradient) at every
substep, as the JAX op path does; the fused kernel and its plain twin
freeze a local plane per contact candidate for the whole control step.

Multi-actor scenes (``models/scene.py``) collide between actors through
``ops/collide.py`` (sphere vs sphere / capsule / cylinder / box, capsule vs
capsule, capsule vs box, box vs box), whose implicit reaction joins the
articulated inertia; world-point attractors pull body points toward fixed
targets. Fixed tendons hold each coupled length L = C q to [lo, hi] with a
backward-Euler limit spring (``dynamics.passive_forces``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.terrain import Heightfield
from thormang_isaacgym_tpu_torch.models.robot import ModelParams, RobotModel
from thormang_isaacgym_tpu_torch.ops import collide as collide_mod
from thormang_isaacgym_tpu_torch.ops import contact as contact_mod
from thormang_isaacgym_tpu_torch.ops import dynamics as dyn
from thormang_isaacgym_tpu_torch.ops.kinematics import (
    forward_kinematics, joint_local_pose, split_q, split_qd,
)


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static simulation parameters (the reference's sim config block)."""
    dt: float = 1.0 / 60.0
    substeps: int = 2
    gravity: tuple = (0.0, 0.0, -9.81)
    contact_stiffness: float = 1.0e5
    contact_damping: float = 3.0e3
    contact_beta: float = 0.5
    friction_vel: float = 0.05
    plane_friction: float = 1.0
    joint_limit_stiffness: float = 2000.0
    joint_limit_damping: float = 50.0
    root_linear_damping: float = 0.0
    root_angular_damping: float = 0.0
    max_velocity: float = 1e3
    max_depenetration_velocity: float = 2.0


class Controls(NamedTuple):
    """Per-step actuation targets, each (B, nj)."""
    target_pos: torch.Tensor
    target_vel: torch.Tensor
    effort: torch.Tensor


def zero_controls(model: RobotModel, batch: int, device="cpu") -> Controls:
    z = torch.zeros(batch, model.nj, device=device)
    return Controls(z, z, z)


def check_supported(model: RobotModel, ground=0.0, attractors=None):
    """Raise for what the port does not cover yet (a callable ground) and
    for malformed attractors or tendons; return the ground: a constant
    height (float) or a Heightfield."""
    for a in attractors or ():
        if len(a) != 5 or not 0 <= int(a[0]) < model.nb:
            raise ValueError(f"attractor {a!r}: expected (body, local_p, target, kp, kd)")
    for t in model.tendons:
        if len(t) != 4 or len(t[0]) != model.nj:
            raise ValueError(f"tendon {t!r}: expected (coef ({model.nj},), lo, hi, name)")
    if isinstance(ground, Heightfield):
        return ground
    if ground is not None and not isinstance(ground, (int, float)):
        raise NotImplementedError("callable grounds are not ported; pass a Heightfield")
    return float(ground or 0.0)


def _substep(model: RobotModel, sp_: SimParams, params: ModelParams,
             q: torch.Tensor, qd: torch.Tensor, ctrl: Controls,
             body_wrench_w: torch.Tensor, ground_z: float = 0.0,
             ground_grad_fn=None, planes=None, attractors=None):
    """One physics substep for a batch of envs: (q', qd', net (B, nb, 6)).
    The ground: plane z = ground_z, or sloped (``ground_grad_fn`` sampled
    here, or frozen per-candidate ``planes``; see ground_contact_forces).
    net = [force | torque]: ground and actor-pair contact; the torque about
    each body origin, without the wrench and the attractors."""
    h = sp_.dt / sp_.substeps
    B = q.shape[0]
    _, _, joint_q = split_q(model, q)
    _, _, joint_qd = split_qd(model, qd)
    local = joint_local_pose(model, joint_q)
    frames = forward_kinematics(model, q, qd, local=local)
    f_ext_w, net = contact_mod.ground_contact_forces(
        model, params, frames,
        stiffness=sp_.contact_stiffness, damping=sp_.contact_damping,
        friction_vel=sp_.friction_vel, plane_friction=sp_.plane_friction,
        ground_z=ground_z, dt=h,
        max_depenetration_velocity=sp_.max_depenetration_velocity,
        ground_grad_fn=ground_grad_fn, planes=planes)
    net_tq = f_ext_w[..., 0:3]
    f_ext_w = f_ext_w + body_wrench_w

    # actor-vs-actor contact: explicit spring + friction join the wrench,
    # the implicit velocity reaction joins the articulated inertia (dIA)
    dIA = None
    if collide_mod.has_pairs(model):
        f_pair, dIA, net_pair = collide_mod.pairwise_contact_forces(
            model, params, frames,
            stiffness=sp_.contact_stiffness, damping=sp_.contact_damping,
            friction_vel=sp_.friction_vel, dt=h,
            max_depenetration_velocity=sp_.max_depenetration_velocity)
        f_ext_w = f_ext_w + f_pair
        net = net + net_pair
        net_tq = net_tq + f_pair[..., 0:3]
    # world-point attractors: enter neither net nor net_tq
    if attractors:
        f_ext_w = f_ext_w + collide_mod.attractor_forces(model, params, frames, attractors, h)

    # world wrench -> link-frame spatial force
    f_ext = torch.cat([Q.rotate_inv(frames.quat, f_ext_w[..., 0:3]),
                       Q.rotate_inv(frames.quat, f_ext_w[..., 3:6])], dim=-1)
    tau_d, diag_d = dyn.drive_forces(params, joint_q, joint_qd, ctrl.target_pos,
                                     ctrl.target_vel, ctrl.effort, h)
    tau_p, diag_p = dyn.passive_forces(params, joint_q, joint_qd, h,
                                       limit_stiffness=sp_.joint_limit_stiffness,
                                       limit_damping=sp_.joint_limit_damping,
                                       tendons=model.tendons)
    qdd = dyn.aba(model, params, q, qd, tau_d + tau_p, f_ext, params.gravity,
                  precomputed=(local[0], local[1], frames.quat),
                  extra_diag=diag_d + diag_p, extra_body_inertia=dIA)

    # ---- semi-implicit Euler ----
    nf = model.n_floating
    qd_new = qd + h * qdd
    if nf > 0:
        # root damping: angular then linear 3-block of each floating root
        root = qd_new[:, :6 * nf].reshape(B, nf, 2, 3)
        root = torch.stack([root[:, :, 0] * (1.0 - sp_.root_angular_damping * h),
                            root[:, :, 1] * (1.0 - sp_.root_linear_damping * h)], dim=2)
        qd_new = torch.cat([root.reshape(B, 6 * nf), qd_new[:, 6 * nf:]], dim=-1)
    qd_new = torch.clamp(qd_new, -sp_.max_velocity, sp_.max_velocity)

    jqd = qd_new[:, 6 * nf:]
    vlim = params.dof_velocity_limit
    jqd = torch.minimum(torch.maximum(jqd, -vlim), vlim)
    jqd = jqd * (1.0 - params.dof_locked)
    jq_new = q[:, 7 * nf:] + h * jqd
    jq_new = torch.where(params.dof_locked > 0, params.dof_locked_pos, jq_new)
    if nf == 0:
        return jq_new, jqd, torch.cat([net, net_tq], dim=-1)
    root_q = q[:, :7 * nf].reshape(B, nf, 7)
    root_qd = qd_new[:, :6 * nf].reshape(B, nf, 6)
    root_pos, root_quat = root_q[..., 0:3], root_q[..., 3:7]
    omega_w = Q.rotate(root_quat, root_qd[..., 0:3])
    new_quat = Q.integrate(root_quat, omega_w, h)
    new_pos = root_pos + h * root_qd[..., 3:6]
    q_new = torch.cat([torch.cat([new_pos, new_quat], -1).reshape(B, -1), jq_new], -1)
    qd_out = torch.cat([root_qd.reshape(B, -1), jqd], -1)
    return q_new, qd_out, torch.cat([net, net_tq], dim=-1)


def build_plain_step_fn(model: RobotModel, sim_params: SimParams,
                        ground=0.0, attractors=None) -> Callable:
    """The op path: step(params, q, qd, ctrl, wrench, planes=None) -> (q',
    qd', net (B, nb, 6) [force | torque] of the last substep). params batched
    (B, ...); q (B, nq); qd (B, nv); ctrl leaves (B, nj); wrench (B, nb, 6)
    world. Over a Heightfield the surface is sampled at every substep, unless
    ``planes`` (B, C, 3) gives each contact candidate a local plane to hold
    for the whole step (the fused kernel's semantics). ``attractors``:
    (body, local_p, target, kp, kd) tuples."""
    ground = check_supported(model, ground, attractors)
    attractors = tuple(attractors or ())
    hf = ground if isinstance(ground, Heightfield) else None
    ground_z = 0.0 if hf is not None else ground
    grad_fn = hf.height_and_grad_fn() if hf is not None else None

    def step(params, q, qd, ctrl, wrench, planes=None):
        if planes is not None and hf is None:
            raise ValueError("ground planes given for a flat ground")
        net = None
        for _ in range(sim_params.substeps):
            q, qd, net = _substep(model, sim_params, params, q, qd, ctrl, wrench, ground_z,
                                  ground_grad_fn=grad_fn if planes is None else None,
                                  planes=planes, attractors=attractors)
        return q, qd, net

    return step


def build_step_fn(model: RobotModel, sim_params: SimParams,
                  ground_height_fn=None, attractors=None,
                  need_torque=True) -> Callable:
    """step(params, q, qd, ctrl, wrench) -> (q', qd', net (B, nb, 6)).

    Returns the fused kernel's wrapper: CUDA tensors launch the kernel (or
    raise for a model it does not cover), CPU tensors take its plain twin.
    `ground_height_fn` is None (plane z = 0), a constant height or a
    Heightfield; `attractors` (body, local_p, target, kp, kd) tuples. Torque
    columns of `net` are zero outside `need_torque`'s bodies."""
    from thormang_isaacgym_tpu_torch.ops import fused
    ground = check_supported(model, ground_height_fn, attractors)
    return fused.build_fused_step_fn(model, sim_params, ground=ground,
                                     attractors=attractors, need_torque=need_torque)
