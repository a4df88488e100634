"""Port parity for ops/control.py: the Factory controller zoo.

Each function of ``thormang_isaacgym_tpu_torch.ops.control`` (batched over
envs) against its JAX counterpart (single env, under ``jax.vmap``) on the
same inputs, made by numpy from a seed at B = 4: ``parse_controller_spec``
for all eight reference modes (equal dicts), the pose and wrench errors,
``ik_delta``'s four methods (held through the joint step they give, not
through SVD factors, whose signs are free), ``apply_task_space_gains``,
``compute_dof_pos_target`` and ``compute_dof_torque`` in every mode. Inputs:
random 6 x 7 jacobians of entries ~0.5 and 7 x 7 SPD mass matrices of
eigenvalues 0.5-3. Float32 tolerances: the errors and gains atol 1e-5; the
joint steps and torques atol 2e-4 / rtol 1e-4 (solves of condition up to
~1e2 on entries up to ~10), in the modes with inertial compensation in task
space rtol 1e-3 (the task-space mass matrix is two nested float32
inverses, of J M^-1 J^T and of M)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.ops import control as JC
from thormang_isaacgym_tpu_torch.ops import control as C

B = 4
MODES = ("gym_default", "joint_space_ik", "joint_space_id", "task_space_impedance",
         "operational_space_motion", "open_loop_force", "closed_loop_force",
         "hybrid_force_motion")
# a YAML ctrl block whose every sub-dict sets its keys to values other than
# the defaults, so each mode's own keys are seen to reach its config
CTRL = {
    "all": {"jacobian_type": "geometric", "gripper_prop_gains": [50, 50],
            "gripper_deriv_gains": [2, 2]},
    "gym_default": {"ik_method": "pinv", "joint_prop_gains": [30] * 7,
                    "joint_deriv_gains": [3] * 7, "gripper_prop_gains": [60, 60],
                    "gripper_deriv_gains": [5, 5]},
    "joint_space_ik": {"ik_method": "svd", "joint_prop_gains": [5] * 7,
                       "joint_deriv_gains": [0.5] * 7},
    "joint_space_id": {"ik_method": "dls", "joint_prop_gains": [40] * 7,
                       "joint_deriv_gains": [8] * 7},
    "task_space_impedance": {"motion_ctrl_axes": [1, 1, 1, 0, 1, 1],
                             "task_prop_gains": [40] * 6, "task_deriv_gains": [8] * 6},
    "operational_space_motion": {"motion_ctrl_axes": [1] * 6, "task_prop_gains": [60] * 6,
                                 "task_deriv_gains": [10] * 6},
    "open_loop_force": {"force_ctrl_axes": [0, 0, 1, 0, 0, 0]},
    "closed_loop_force": {"wrench_prop_gains": [0.2] * 6, "force_ctrl_axes": [0, 1, 1, 0, 0, 0]},
    "hybrid_force_motion": {"motion_ctrl_axes": [1, 1, 0, 1, 1, 1], "task_prop_gains": [50] * 6,
                            "task_deriv_gains": [9] * 6, "wrench_prop_gains": [0.3] * 6,
                            "force_ctrl_axes": [0, 0, 1, 0, 0, 0]},
}


def _unit(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _inputs(seed=0):
    """Controller inputs (float32 numpy, batch first)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, 7, 7)) * 0.4
    mm = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(7)
    x = dict(dof_pos=rng.normal(size=(B, 9)) * 0.5, dof_vel=rng.normal(size=(B, 9)) * 0.5,
             eef_pos=rng.normal(size=(B, 3)) * 0.3, eef_quat=_unit(rng, B),
             eef_linvel=rng.normal(size=(B, 3)) * 0.2, eef_angvel=rng.normal(size=(B, 3)) * 0.2,
             finger_force_sum=rng.normal(size=(B, 3)) * 3.0,
             jacobian=rng.normal(size=(B, 6, 7)) * 0.5, arm_mass_matrix=mm,
             target_pos=rng.normal(size=(B, 3)) * 0.3, target_quat=_unit(rng, B),
             target_wrench=rng.normal(size=(B, 6)))
    return {k: v.astype(np.float32) for k, v in x.items()}


def _t(x):
    return {k: torch.as_tensor(v) for k, v in x.items()}


def _j(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


@pytest.mark.parametrize("mode", MODES)
def test_parse_controller_spec_matches_jax(mode):
    cfg = C.parse_controller_spec({"ctrl_type": mode, **CTRL})
    assert cfg == JC.parse_controller_spec({"ctrl_type": mode, **CTRL})
    assert cfg["ctrl_type"] == mode
    with pytest.raises(ValueError):
        C.parse_controller_spec({"ctrl_type": "nope"})


def test_errors_and_gains_match_jax():
    x = _inputs(1)
    t, j = _t(x), _j(x)
    np.testing.assert_allclose(C.axis_angle_from_quat(t["eef_quat"]).numpy(),
                               np.asarray(jax.vmap(JC.axis_angle_from_quat)(j["eef_quat"])), atol=1e-5)
    # the Taylor branch near zero angle
    small = np.array([[1.0, 1e-8, -2e-8, 0.0]], np.float32)
    np.testing.assert_allclose(C.axis_angle_from_quat(torch.as_tensor(small)).numpy(),
                               np.asarray(JC.axis_angle_from_quat(jnp.asarray(small[0])))[None],
                               atol=1e-12)
    for jt in ("geometric", "analytic"):
        for rt in ("axis_angle", "quat") if jt == "geometric" else ("axis_angle",):
            got = C.get_pose_error(t["eef_pos"], t["eef_quat"], t["target_pos"], t["target_quat"], jt, rt)
            want = jax.vmap(lambda a, b, c, d: JC.get_pose_error(a, b, c, d, jt, rt))(
                j["eef_pos"], j["eef_quat"], j["target_pos"], j["target_quat"])
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=f"{jt} {rt}")
    np.testing.assert_allclose(
        C.get_wrench_error(t["finger_force_sum"], t["target_wrench"]).numpy(),
        np.asarray(jax.vmap(JC.get_wrench_error)(j["finger_force_sum"], j["target_wrench"])), atol=1e-6)
    kp, kd = np.linspace(10, 60, 6).astype(np.float32), np.linspace(1, 6, 6).astype(np.float32)
    delta = np.concatenate([x["target_pos"], x["eef_pos"]], -1)
    got = C.apply_task_space_gains(torch.as_tensor(delta), t["eef_linvel"], t["eef_angvel"],
                                   torch.as_tensor(kp), torch.as_tensor(kd))
    want = jax.vmap(lambda d, v, w: JC.apply_task_space_gains(d, v, w, jnp.asarray(kp), jnp.asarray(kd)))(
        jnp.asarray(delta), j["eef_linvel"], j["eef_angvel"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("method", ["pinv", "trans", "dls", "svd"])
def test_ik_delta_matches_jax(method):
    x = _inputs(2)
    delta = np.concatenate([x["target_pos"], x["eef_angvel"]], -1)
    got = C.ik_delta(torch.as_tensor(delta), torch.as_tensor(x["jacobian"]), method)
    want = jax.vmap(lambda d, J: JC.ik_delta(d, J, method))(jnp.asarray(delta), jnp.asarray(x["jacobian"]))
    assert tuple(got.shape) == (B, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    with pytest.raises(ValueError):
        C.ik_delta(torch.as_tensor(delta), torch.as_tensor(x["jacobian"]), "nope")


def test_controller_outputs_match_jax():
    """compute_dof_torque in all eight modes and compute_dof_pos_target
    (gym_default), the gripper target 0.04."""
    x = _inputs(3)
    t, j = _t(x), _j(x)
    keys = ("dof_pos", "dof_vel", "eef_pos", "eef_quat", "eef_linvel", "eef_angvel",
            "finger_force_sum", "jacobian", "arm_mass_matrix")
    tail = ("target_pos", "target_quat", "target_wrench")
    for mode in MODES:
        cfg = C.parse_controller_spec({"ctrl_type": mode, **CTRL})
        got = C.compute_dof_torque(cfg, *(t[k] for k in keys), 0.04, *(t[k] for k in tail))
        want = jax.jit(jax.vmap(lambda *a: JC.compute_dof_torque(cfg, *a[:9], 0.04, *a[9:])))(
            *(j[k] for k in keys + tail))
        assert tuple(got.shape) == (B, 9)
        rtol = 1e-3 if cfg["gain_space"] == "task" and cfg["do_inertial_comp"] else 1e-4
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=rtol, err_msg=mode)
    cfg = C.parse_controller_spec({"ctrl_type": "gym_default", **CTRL})
    got = C.compute_dof_pos_target(cfg, t["dof_pos"][:, :7], t["eef_pos"], t["eef_quat"], t["jacobian"],
                                   t["target_pos"], t["target_quat"], 0.04)
    want = jax.vmap(lambda p, a, b, J, c, d: JC.compute_dof_pos_target(cfg, p, a, b, J, c, d, 0.04))(
        j["dof_pos"][:, :7], j["eef_pos"], j["eef_quat"], j["jacobian"], j["target_pos"],
        j["target_quat"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
