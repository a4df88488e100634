"""Controller zoo: the Factory 8-mode controller spec.

Port of ``thormang_isaacgym_tpu/ops/control.py`` (the reference's
``tasks/factory/factory_control.py:40-292`` control math and
``factory_base.py:273-417`` ``parse_controller_spec``: gym_default /
joint_space_ik / joint_space_id / task_space_impedance /
operational_space_motion / open_loop_force / closed_loop_force /
hybrid_force_motion) on batched (B, ...) tensors over ``ops.inertia``'s
outputs (mass matrix, point jacobian).

All jacobians here use the [lin; ang] row convention of the reference (the
gym world-space geometric jacobian); rotation errors are axis-angle
(``get_pose_error``). The small dense solves (pinv, dls, svd, the inverses
of the task-space mass matrix) are ``torch.linalg`` calls, as the JAX
package's are ``jnp.linalg`` calls outside any kernel; the ``_ex`` forms
skip the error checks that would wait for the device.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from thormang_isaacgym_tpu_torch.core import quat as Q


@lru_cache(maxsize=256)
def _const(values: tuple, device: str) -> torch.Tensor:
    """A gain tuple of the controller spec as a tensor on `device`, built
    once (a tensor made from a list in every step is a host copy)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _gain(cfg: dict, key: str, like: torch.Tensor) -> torch.Tensor:
    return _const(tuple(cfg[key]), str(like.device))


# --------------------------------------------------------------------------
# pose / wrench errors
# --------------------------------------------------------------------------


def axis_angle_from_quat(q: torch.Tensor, eps: float = 1.0e-6) -> torch.Tensor:
    """Quat (w, x, y, z) -> rotation vector (axis * angle), with the
    reference's sin(x)/x Taylor branch near zero angle."""
    mag = torch.linalg.norm(q[..., 1:4], dim=-1)
    half_angle = torch.atan2(mag, q[..., 0])
    angle = 2.0 * half_angle
    big = torch.abs(angle) > eps
    sin_half_over_angle = torch.where(
        big, torch.sin(half_angle) / torch.where(big, angle, torch.ones_like(angle)),
        0.5 - angle * angle / 48.0)
    return q[..., 1:4] / torch.clamp(sin_half_over_angle, min=1e-9)[..., None]


def get_pose_error(pos, quat, target_pos, target_quat,
                   jacobian_type: str = "geometric",
                   rot_error_type: str = "axis_angle"):
    """Task-space pose error (the reference's factory_control.py:179-216).

    geometric: quat difference -> axis-angle; analytic: difference of
    rotation vectors."""
    pos_error = target_pos - pos
    quat_error = None
    if jacobian_type == "geometric":
        quat_norm = torch.sum(quat * quat, -1, keepdim=True)       # |q|^2 (unit in practice)
        quat_inv = Q.conj(quat) / torch.clamp(quat_norm, min=1e-9)
        quat_error = Q.mul(target_quat, quat_inv)
        axis_angle_error = axis_angle_from_quat(quat_error)
    else:  # analytic
        axis_angle_error = axis_angle_from_quat(target_quat) - axis_angle_from_quat(quat)
    if rot_error_type == "quat":
        return pos_error, quat_error
    return pos_error, axis_angle_error


def get_wrench_error(finger_force_sum, target_wrench):
    """The reference's factory_control.py:219-233: the measured fingertip
    wrench is the net contact force on the fingers (torque channels zero)."""
    measured = torch.cat([finger_force_sum, torch.zeros_like(finger_force_sum)], -1)
    return target_wrench - (-measured)


# --------------------------------------------------------------------------
# IK variants (factory_control.py:236-271)
# --------------------------------------------------------------------------


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def ik_delta(delta_pose, jacobian, method: str = "pinv"):
    """delta task pose (B, 6) -> delta joint pos (B, n), per ik_method."""
    J = jacobian
    Jt = J.transpose(-1, -2)
    if method == "pinv":
        return _mv(torch.linalg.pinv(J), delta_pose)
    if method == "trans":
        return _mv(Jt, delta_pose)
    if method == "dls":
        lam = 0.1
        eye = torch.eye(J.shape[-2], dtype=J.dtype, device=J.device)
        JJt = J @ Jt + (lam ** 2) * eye
        return _mv(Jt, torch.linalg.solve_ex(JJt, delta_pose)[0])
    if method == "svd":
        U, S, Vh = torch.linalg.svd(J, full_matrices=False)
        S_inv = torch.where(S > 1.0e-5, 1.0 / torch.clamp(S, min=1e-12), torch.zeros_like(S))
        return _mv(Vh.transpose(-1, -2), S_inv * _mv(U.transpose(-1, -2), delta_pose))
    raise ValueError(f"unknown ik_method {method!r}")


def apply_task_space_gains(delta_pose, linvel, angvel, kp, kd):
    """The reference's factory_control.py:274-292: PD in task space ->
    wrench [force; torque]."""
    return torch.cat([
        kp[0:3] * delta_pose[..., 0:3] + kd[0:3] * (0.0 - linvel),
        kp[3:6] * delta_pose[..., 3:6] + kd[3:6] * (0.0 - angvel)], -1)


# --------------------------------------------------------------------------
# controller spec (factory_base.py:273-417)
# --------------------------------------------------------------------------

_CTRL_DEFAULTS = dict(
    jacobian_type="geometric",
    gripper_prop_gains=(200.0, 200.0),
    gripper_deriv_gains=(1.0, 1.0),
    motor_ctrl_mode="manual",
    gain_space="task",
    ik_method="dls",
    joint_prop_gains=(1.0,) * 7,
    joint_deriv_gains=(0.1,) * 7,
    do_motion_ctrl=True,
    task_prop_gains=(100.0,) * 6,
    task_deriv_gains=(20.0,) * 6,
    do_inertial_comp=False,
    motion_ctrl_axes=(1.0,) * 6,
    do_force_ctrl=False,
    force_ctrl_method="open",
    wrench_prop_gains=(0.1,) * 6,
    force_ctrl_axes=(1.0,) * 6,
)

# per ctrl_type: the flags it sets and the keys its YAML subdict may set
_CTRL_MODES = {
    "gym_default": (dict(motor_ctrl_mode="gym", gain_space="joint"),
                    ("ik_method", "joint_prop_gains", "joint_deriv_gains",
                     "gripper_prop_gains", "gripper_deriv_gains")),
    "joint_space_ik": (dict(motor_ctrl_mode="manual", gain_space="joint", do_inertial_comp=False),
                       ("ik_method", "joint_prop_gains", "joint_deriv_gains")),
    "joint_space_id": (dict(motor_ctrl_mode="manual", gain_space="joint", do_inertial_comp=True),
                       ("ik_method", "joint_prop_gains", "joint_deriv_gains")),
    "task_space_impedance": (dict(motor_ctrl_mode="manual", gain_space="task", do_motion_ctrl=True,
                                  do_inertial_comp=False, do_force_ctrl=False),
                             ("task_prop_gains", "task_deriv_gains", "motion_ctrl_axes")),
    "operational_space_motion": (dict(motor_ctrl_mode="manual", gain_space="task",
                                      do_motion_ctrl=True, do_inertial_comp=True,
                                      do_force_ctrl=False),
                                 ("task_prop_gains", "task_deriv_gains", "motion_ctrl_axes")),
    "open_loop_force": (dict(motor_ctrl_mode="manual", gain_space="task", do_motion_ctrl=False,
                             do_force_ctrl=True, force_ctrl_method="open"),
                        ("force_ctrl_axes",)),
    "closed_loop_force": (dict(motor_ctrl_mode="manual", gain_space="task", do_motion_ctrl=False,
                               do_force_ctrl=True, force_ctrl_method="closed"),
                          ("wrench_prop_gains", "force_ctrl_axes")),
    "hybrid_force_motion": (dict(motor_ctrl_mode="manual", gain_space="task", do_motion_ctrl=True,
                                 do_inertial_comp=True, do_force_ctrl=True,
                                 force_ctrl_method="closed"),
                            ("task_prop_gains", "task_deriv_gains", "motion_ctrl_axes",
                             "wrench_prop_gains", "force_ctrl_axes")),
}


def parse_controller_spec(ctrl_cfg: dict) -> dict:
    """The reference's ``parse_controller_spec`` (factory_base.py:273-417):
    the YAML ``ctrl`` block (ctrl_type + per-type subdict,
    FactoryTask*.yaml) to the flat controller config that
    ``compute_dof_torque`` / ``compute_dof_pos_target`` read. Plain python
    values and float tuples."""
    ctrl_type = ctrl_cfg.get("ctrl_type", "joint_space_id")
    if ctrl_type not in _CTRL_MODES:
        raise ValueError(f"unknown ctrl_type {ctrl_type!r}")
    cfg = dict(_CTRL_DEFAULTS)
    allc = ctrl_cfg.get("all", {})
    for k in ("jacobian_type", "gripper_prop_gains", "gripper_deriv_gains"):
        if k in allc:
            cfg[k] = allc[k]
    flags, keys = _CTRL_MODES[ctrl_type]
    cfg.update(flags)
    sub = ctrl_cfg.get(ctrl_type, {})
    cfg.update({k: sub[k] for k in keys if k in sub})
    cfg["ctrl_type"] = ctrl_type
    for k, v in cfg.items():
        if isinstance(v, (list, tuple)):
            cfg[k] = tuple(float(x) for x in v)
    return cfg


# --------------------------------------------------------------------------
# controller outputs (factory_control.py:40-176)
# --------------------------------------------------------------------------


def _pose_delta(cfg, eef_pos, eef_quat, target_pos, target_quat):
    pos_err, rot_err = get_pose_error(eef_pos, eef_quat, target_pos, target_quat,
                                      cfg["jacobian_type"], "axis_angle")
    return torch.cat([pos_err, rot_err], -1)


def compute_dof_pos_target(cfg: dict, arm_dof_pos, eef_pos, eef_quat,
                           jacobian, target_pos, target_quat, gripper_target):
    """gym_default mode: an IK step toward the target pose -> (B, 9) DOF
    position targets (the reference's factory_control.py:40-70)."""
    d_arm = ik_delta(_pose_delta(cfg, eef_pos, eef_quat, target_pos, target_quat),
                     jacobian, cfg["ik_method"])
    grip = gripper_target if torch.is_tensor(gripper_target) \
        else arm_dof_pos.new_full((), gripper_target)
    return torch.cat([arm_dof_pos + d_arm,
                      grip.reshape(-1, 1).expand(arm_dof_pos.shape[0], 2)], -1)


def compute_dof_torque(cfg: dict, dof_pos, dof_vel, eef_pos, eef_quat,
                       eef_linvel, eef_angvel, finger_force_sum,
                       jacobian, arm_mass_matrix, gripper_target,
                       target_pos, target_quat, target_wrench):
    """Manual-mode torque controller (the reference's
    factory_control.py:73-176): joint- or task-gain-space motion control
    with optional inertial compensation, open / closed-loop force control,
    the hybrid force-motion split. Returns (B, 9) torques (7 arm + 2
    gripper), clipped to +-100."""
    if cfg["gain_space"] == "joint":
        d_arm = ik_delta(_pose_delta(cfg, eef_pos, eef_quat, target_pos, target_quat),
                         jacobian, cfg["ik_method"])
        tau_arm = _gain(cfg, "joint_prop_gains", d_arm) * d_arm \
            + _gain(cfg, "joint_deriv_gains", d_arm) * (0.0 - dof_vel[:, 0:7])
        if cfg["do_inertial_comp"]:
            tau_arm = _mv(arm_mass_matrix, tau_arm)
    else:  # task gain space
        wrench = eef_pos.new_zeros(eef_pos.shape[0], 6)
        if cfg["do_motion_ctrl"]:
            delta = _pose_delta(cfg, eef_pos, eef_quat, target_pos, target_quat)
            w_motion = apply_task_space_gains(delta, eef_linvel, eef_angvel,
                                              _gain(cfg, "task_prop_gains", delta),
                                              _gain(cfg, "task_deriv_gains", delta))
            if cfg["do_inertial_comp"]:
                # task-space mass matrix Lambda = (J M^-1 J^T)^-1 (ETH 3.86)
                eye7 = torch.eye(7, dtype=delta.dtype, device=delta.device)
                eye6 = torch.eye(6, dtype=delta.dtype, device=delta.device)
                mm_inv = torch.linalg.inv_ex(arm_mass_matrix + 1e-6 * eye7)[0]
                lam = torch.linalg.inv_ex(
                    jacobian @ mm_inv @ jacobian.transpose(-1, -2) + 1e-6 * eye6)[0]
                w_motion = _mv(lam, w_motion)
            wrench = wrench + _gain(cfg, "motion_ctrl_axes", delta) * w_motion
        if cfg["do_force_ctrl"]:
            w_force = target_wrench
            if cfg["force_ctrl_method"] == "closed":
                w_force = w_force + _gain(cfg, "wrench_prop_gains", target_wrench) \
                    * get_wrench_error(finger_force_sum, target_wrench)
            wrench = wrench + _gain(cfg, "force_ctrl_axes", target_wrench) * w_force
        tau_arm = _mv(jacobian.transpose(-1, -2), wrench)
    tau_grip = _gain(cfg, "gripper_prop_gains", dof_pos) * (gripper_target - dof_pos[:, 7:9]) \
        + _gain(cfg, "gripper_deriv_gains", dof_pos) * (0.0 - dof_vel[:, 7:9])
    return torch.clamp(torch.cat([tau_arm, tau_grip], -1), -100.0, 100.0)
