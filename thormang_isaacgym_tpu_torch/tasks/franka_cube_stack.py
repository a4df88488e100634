"""FrankaCubeStack: a Panda stacks cube A on cube B, with operational-space
or joint-torque control. Port of
``thormang_isaacgym_tpu/tasks/franka_cube_stack.py`` (the reference's
``tasks/franka_cube_stack.py`` and ``cfg/task/FrankaCubeStack.yaml``). The
operational-space controller is the reference's ``_compute_osc_torques``
(:602-628, Khatib 1987) on the port's batched dynamics: the mass matrix and
the end-effector jacobian come from ``ops.inertia``.

- scene: the table surface z = 1.025 as the ground height (the kernel's
  flat ground at that height), the Franka's base at (-0.45, 0, 1.125), cube
  A (5 cm) and cube B (7 cm) free; the finger pads and the cubes touch
  through the box-box narrowphase (the kernel's box instance)
- obs (19, osc): [cube A quat (4), cube A pos (3), A to B (3), eef pos (3),
  eef quat (4), gripper q (2)]; joint_tor: 26, the arm's q (7) inserted
  before the gripper's
- actions (7, osc): a 6-DOF task-space delta pose x cmd_limit [0.1 m, 0.5
  rad] -> OSC torques with null-space posture control (kp 150, kp_null 10,
  critically damped), +1 binary gripper; joint_tor (8): 7 torques x the
  effort limits, +1 gripper
- reward: dist = 1 - tanh(10 (d + d_lf + d_rf) / 3), lift at height > size
  + 0.04, align (1 - tanh(10 d_ab)) x lifted, stack bonus 16 when aligned
  within 2 cm, on height and released; scales 0.1 / 1.5 / 2.0 / 16
- reset: Franka DOFs noised (fingers open), cube B in the centre region
  with xy noise, cube A at a polar offset of 0.13-0.22 m from it, both with
  yaw noise; done when stacked, or at the timeout of 300

Random draws are the port's per-env murmur3 streams (``EnvRandom``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom, Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.franka import (
    FRANKA_CUBE_DOF_POS, franka_dof_ids, load_franka,
)
from thormang_isaacgym_tpu_torch.models.robot import DRIVE_EFFORT
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.ops import inertia as di
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams

TABLE_Z = 1.025            # table surface height (:278)
FRANKA_POS = (-0.45, 0.0, 1.125)
CUBE_A = 0.050
CUBE_B = 0.070


def _cube_urdf(name, size, mass=0.1):
    """A free cube: one box geom."""
    i = mass * size * size / 6
    return f"""
<robot name="{name}">
  <link name="{name}">
    <inertial><mass value="{mass}"/>
      <inertia ixx="{i:.6f}" iyy="{i:.6f}" izz="{i:.6f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision name="{name}_box"><geometry><box size="{size} {size} {size}"/></geometry></collision>
  </link>
</robot>"""


def grasp_frame(task, q, qd):
    """(pos, quat, [lin vel, ang vel]) of the grasp site, world frame."""
    frames = forward_kinematics(task.model, q, qd)
    B = q.shape[0]
    bq = frames.quat[:, task.grasp_body]
    gq = Q.mul(bq, task.grasp_quat_l.expand(B, 4))
    r = Q.rotate(bq, task.grasp_pos_l.expand(B, 3))
    gp = frames.pos[:, task.grasp_body] + r
    w = frames.omega[:, task.grasp_body]
    v = frames.vel[:, task.grasp_body] + torch.linalg.cross(w, r, dim=-1)
    return gp, gq, torch.cat([v, w], -1)


def arm_dynamics(task, params, q):
    """(mass matrix of the arm's 7 joints (B, 7, 7), grasp-site jacobian
    (B, 6, 7) in the reference's [lin; ang] rows) at q."""
    m = task.model
    frames = forward_kinematics(m, q, q.new_zeros(q.shape[0], m.nv))
    H = di.mass_matrix(m, params, q, frames)
    cols = task._arm_cols
    mm = H[:, cols][:, :, cols]
    J6 = di.point_jacobian(m, q, task.grasp_body, task.grasp_pos_l, frames)
    return mm, torch.cat([J6[:, 3:], J6[:, :3]], 1)[:, :, cols]


@dataclasses.dataclass(frozen=True)
class CubeStackTaskState:
    actions: torch.Tensor        # (B, na) last raw actions
    finger_target: torch.Tensor  # (B,) current gripper target (0 or 0.04)


class FrankaCubeStack(Task):
    max_episode_length = 300
    clip_obs = 5.0
    action_scale = 1.0
    start_position_noise = 0.25
    start_rotation_noise = 0.785
    franka_dof_noise = 0.25
    r_dist_scale = 0.1
    r_lift_scale = 1.5
    r_align_scale = 2.0
    r_stack_scale = 16.0

    def __init__(self, num_envs: int = 8192, seed: int = 42, device=None,
                 control_type: str = "osc", **_):
        super().__init__(num_envs, seed, device)
        if control_type not in ("osc", "joint_tor"):
            raise ValueError(f"control_type {control_type!r}: osc or joint_tor")
        dev = self.device
        self.control_type = control_type
        self.num_obs = 19 if control_type == "osc" else 26
        self.num_actions = 7 if control_type == "osc" else 8

        franka = load_franka()
        cubeA = load_urdf(_cube_urdf("cubeA", CUBE_A))
        cubeB = load_urdf(_cube_urdf("cubeB", CUBE_B))
        scene = compose([
            (franka, FRANKA_POS + (1.0, 0.0, 0.0, 0.0), "franka/"),
            (cubeA, (0.0, 0.0, TABLE_Z + CUBE_A / 2, 1.0, 0.0, 0.0, 0.0), "A/"),
            (cubeB, (0.0, 0.15, TABLE_Z + CUBE_B / 2, 1.0, 0.0, 0.0, 0.0), "B/"),
        ], name="franka_cube_stack")
        self.model = scene
        self.fr_ids = np.array(franka_dof_ids(scene, "franka/"))
        self._fr = torch.as_tensor(self.fr_ids, device=dev)
        d = scene._defaults
        # arm joints torque-controlled (OSC and joint_tor both write efforts,
        # :640-657); fingers position-driven
        mode = np.array(d["drive_mode"])
        mode[self.fr_ids[:7]] = DRIVE_EFFORT
        d["drive_mode"] = mode
        self.fr_lower = torch.as_tensor(np.array(d["dof_lower"])[self.fr_ids], device=dev)
        self.fr_upper = torch.as_tensor(np.array(d["dof_upper"])[self.fr_ids], device=dev)
        self.effort_limit = torch.as_tensor(np.array(d["drive_effort_limit"])[self.fr_ids],
                                            device=dev)
        self.default_dof = torch.as_tensor(FRANKA_CUBE_DOF_POS, device=dev)

        gb, gp, gq = scene.sites["franka/panda_grasp"]
        self.grasp_body = gb
        self.grasp_pos_l = torch.tensor(np.asarray(gp, np.float32), device=dev)
        self.grasp_quat_l = torch.tensor(np.asarray(gq, np.float32), device=dev)
        self.lfinger_body = scene.body_id("franka/panda_leftfinger")
        self.rfinger_body = scene.body_id("franka/panda_rightfinger")
        self.cubeA_body = scene.body_id("A/cubeA")
        self.cubeB_body = scene.body_id("B/cubeB")
        # floating-root q offsets: roots in actor order (the Franka fixed)
        self.qA = 0
        self.qB = 7
        self._arm_cols = torch.as_tensor(6 * scene.n_floating + self.fr_ids[:7], device=dev)

        # OSC gains (:153-157)
        self.kp = torch.full((6,), 150.0, device=dev)
        self.kd = 2.0 * torch.sqrt(self.kp)
        self.kp_null = torch.full((7,), 10.0, device=dev)
        self.kd_null = 2.0 * torch.sqrt(self.kp_null)
        self.cmd_limit = torch.tensor([0.1] * 3 + [0.5] * 3, device=dev) \
            if control_type == "osc" else self.effort_limit[:7]
        self._eye7 = torch.eye(7, device=dev)
        self._eye6 = torch.eye(6, device=dev)
        self._stack_offset = torch.tensor([0.0, 0.0, (CUBE_A + CUBE_B) / 2], device=dev)
        self._b_centre = torch.tensor([0.0, 0.1], device=dev)
        self._ez = torch.tensor([0.0, 0.0, 1.0], device=dev)

        self.sim_params = SimParams(
            dt=1.0 / 60.0, substeps=6, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=1.0e5, contact_damping=1.0e3,
            friction_vel=0.004, plane_friction=0.8,
            max_depenetration_velocity=0.5)
        self.dt = self.sim_params.dt

    def ground_height_fn(self):
        """The table: a flat plane at the tabletop height (the reference's
        create_box table actor, :207-213). A constant, so the kernel's flat
        ground takes it."""
        return TABLE_Z

    # ------------------------------------------------------------------
    def default_task_state(self) -> CubeStackTaskState:
        B = self.num_envs
        return CubeStackTaskState(torch.zeros(B, self.num_actions, device=self.device),
                                  torch.full((B,), 0.04, device=self.device))

    def reset_fn(self, rng: EnvRandom, params, task):
        # Franka DOFs: default + noise, fingers open (:521-528)
        pos = self.default_dof + self.franka_dof_noise * 0.5 * (rng.uniform(9) * 2.0 - 1.0)
        pos = torch.minimum(torch.maximum(pos, self.fr_lower), self.fr_upper)
        pos[:, 7:] = 0.04
        B, dev = pos.shape[0], pos.device
        jq = pos.new_zeros(B, self.model.nj)
        jq[:, self._fr] = pos
        # cube B: centre region + xy noise; cube A: a polar offset from B
        # (the reference rejection-samples a min distance of 0.1, :560-600)
        bxy = self.start_position_noise * 0.4 * (rng.uniform(2) * 2.0 - 1.0) + self._b_centre
        ang = rng.uniform(1, -math.pi, math.pi)[:, 0]
        rad = rng.uniform(1, 0.13, 0.22)[:, 0]
        axy = bxy + rad[:, None] * torch.stack([torch.cos(ang), torch.sin(ang)], -1)
        yaw = self.start_rotation_noise * (rng.uniform(2) * 2 - 1)
        qa = torch.cat([axy, pos.new_full((B, 1), TABLE_Z + CUBE_A / 2),
                        Q.from_axis_angle(self._ez, yaw[:, 0])], -1)
        qb = torch.cat([bxy, pos.new_full((B, 1), TABLE_Z + CUBE_B / 2),
                        Q.from_axis_angle(self._ez, yaw[:, 1])], -1)
        q = torch.cat([qa, qb, jq], -1)
        return q, torch.zeros(B, self.model.nv, device=dev), params, CubeStackTaskState(
            torch.zeros(B, self.num_actions, device=dev), torch.full((B,), 0.04, device=dev))

    # ------------------------------------------------------------------
    def _osc_torques(self, q, qd, dpose, params):
        """The reference's ``_compute_osc_torques`` (:602-628)."""
        nf = self.model.n_floating
        arm = self._fr[:7]
        jq, jqd = q[:, 7 * nf:], qd[:, 6 * nf:]
        mm, j_eef = arm_dynamics(self, params, q)
        _, _, eef_vel = grasp_frame(self, q, qd)
        j_t = j_eef.transpose(-1, -2)
        mm_inv = torch.linalg.inv_ex(mm + 1e-6 * self._eye7)[0]
        m_eef = torch.linalg.inv_ex(j_eef @ mm_inv @ j_t + 1e-6 * self._eye6)[0]
        u = j_t @ (m_eef @ (self.kp * dpose - self.kd * eef_vel)[..., None])
        # null-space posture control
        j_eef_inv = m_eef @ j_eef @ mm_inv
        qe = torch.remainder(self.default_dof[:7] - jq[:, arm] + math.pi, 2 * math.pi) - math.pi
        u_null = self.kd_null * (-jqd[:, arm]) + self.kp_null * qe
        u_null = mm @ u_null[..., None]
        u = (u + (self._eye7 - j_t @ j_eef_inv) @ u_null)[..., 0]
        lim = self.effort_limit[:7]
        return torch.minimum(torch.maximum(u, -lim), lim)

    def pre_physics(self, state, actions):
        B, nj = actions.shape[0], self.model.nj
        u_arm_raw, u_grip = actions[:, :-1], actions[:, -1]
        lim = self.effort_limit[:7]
        if self.control_type == "osc":
            dpose = u_arm_raw[:, :6] * self.cmd_limit / self.action_scale
            u_arm = self._osc_torques(state.q, state.qd, dpose, state.params)
        else:
            u_arm = u_arm_raw[:, :7] * self.cmd_limit / self.action_scale
            u_arm = torch.minimum(torch.maximum(u_arm, -lim), lim)
        finger_target = torch.where(u_grip >= 0, torch.full_like(u_grip, 0.04),
                                    torch.zeros_like(u_grip))
        effort = actions.new_zeros(B, nj)
        effort[:, self._fr[:7]] = u_arm
        tpos = actions.new_zeros(B, nj)
        tpos[:, self._fr[7:]] = finger_target[:, None].expand(B, 2)
        wrench = actions.new_zeros(B, self.model.nb, 6)
        return Controls(tpos, torch.zeros_like(tpos), effort), wrench, \
            CubeStackTaskState(actions, finger_target)

    def post_physics(self, state, prev_task):
        gp, gq, _ = grasp_frame(self, state.q, state.qd)
        frames = forward_kinematics(self.model, state.q, state.qd)
        lf = frames.pos[:, self.lfinger_body]
        rf = frames.pos[:, self.rfinger_body]
        posA = state.q[:, self.qA:self.qA + 3]
        quatA = state.q[:, self.qA + 3:self.qA + 7]
        posB = state.q[:, self.qB:self.qB + 3]
        a_to_b = posB - posA
        jq = state.q[:, 7 * self.model.n_floating:]
        obs = [quatA, posA, a_to_b, gp, gq, jq[:, self._fr[7:]]]
        if self.control_type != "osc":
            obs.insert(5, jq[:, self._fr[:7]])
        obs = torch.cat(obs, -1)

        # reward (compute_franka_reward, :699-748)
        d = torch.linalg.norm(posA - gp, dim=-1)
        d_lf = torch.linalg.norm(posA - lf, dim=-1)
        d_rf = torch.linalg.norm(posA - rf, dim=-1)
        dist_reward = 1 - torch.tanh(10.0 * (d + d_lf + d_rf) / 3)
        heightA = posA[:, 2] - TABLE_Z
        lifted = ((heightA - CUBE_A) > 0.04).to(d.dtype)
        d_ab = torch.linalg.norm(a_to_b + self._stack_offset, dim=-1)
        align_reward = (1 - torch.tanh(10.0 * d_ab)) * lifted
        dist_reward = torch.maximum(dist_reward, align_reward)
        target_h = CUBE_B + CUBE_A / 2
        aligned = torch.linalg.norm(a_to_b[:, :2], dim=-1) < 0.02
        on_top = torch.abs(heightA - target_h) < 0.02
        released = d > 0.04
        stack = aligned & on_top & released
        reward = torch.where(
            stack, torch.full_like(d, self.r_stack_scale),
            self.r_dist_scale * dist_reward + self.r_lift_scale * lifted
            + self.r_align_scale * align_reward)
        done = stack.to(d.dtype)
        metrics = dict(state.metrics)
        metrics["cubeA_height"] = heightA
        metrics["stack_rate"] = done
        metrics["grasp_dist"] = d
        return obs, reward, done, prev_task, metrics
