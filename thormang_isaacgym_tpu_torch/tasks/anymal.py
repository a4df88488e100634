"""Anymal quadruped velocity-command tracking. Port of
``thormang_isaacgym_tpu/tasks/anymal.py`` (the reference's ``tasks/anymal.py``
and ``cfg/task/Anymal.yaml``).

The ANYmal-C-like morphology is generated as URDF (``make_anymal_urdf``, the
same string as the JAX package's): base box 0.53 x 0.3 x 0.24 m, 16.8 kg;
HAA / HFE / KFE legs, thigh 0.25 m, shank 0.33 m, 80 Nm joints.

- obs (61): [base_lin_vel(3), base_ang_vel(3), torques(12),
  projected_gravity(3), per-body |contact|(13), dof_pos_scaled(12),
  dof_vel*0.05(12), commands(3)]
- actions: PD position targets = action * 0.5 + default angles, Kp 85 Kd 2,
  effort clip 80 Nm
- reward (x dt): exp(-|cmd_xy - v_xy|^2/0.25) * 1.0 + exp(-(cmd_yaw -
  w_z)^2/0.25) * 0.5 - 2.5e-5 |tau|^2, clipped >= 0
- reset: base or knee contact force > 1 N, or timeout (50 s)
- commands: vx U(-2, 2), vy U(-1, 1), yaw rate U(-1, 1); reset state
  dof_pos = default * U(0.5, 1.5), dof_vel U(-0.1, 0.1), drawn from the
  env's EnvRandom stream
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.robot import DRIVE_POS
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams

# (name, sign_x, sign_y): LF, LH, RF, RH
_LEGS = [("LF", 1, 1), ("LH", -1, 1), ("RF", 1, -1), ("RH", -1, -1)]

DEFAULT_ANGLES = {  # Anymal.yaml defaultJointAngles
    "LF_HAA": 0.03, "LH_HAA": 0.03, "RF_HAA": -0.03, "RH_HAA": -0.03,
    "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
    "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8,
}


def make_anymal_urdf() -> str:
    base_m = 16.8
    hx, hy, hz = 0.265, 0.15, 0.12
    bi = (base_m / 3.0 * (hy**2 + hz**2), base_m / 3.0 * (hx**2 + hz**2),
          base_m / 3.0 * (hx**2 + hy**2))
    thigh_l, shank_l = 0.25, 0.33
    parts = [f"""
  <link name="base">
    <inertial><mass value="{base_m}"/>
      <inertia ixx="{bi[0]:.4f}" iyy="{bi[1]:.4f}" izz="{bi[2]:.4f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><box size="{2*hx} {2*hy} {2*hz}"/></geometry></collision>
  </link>"""]
    for name, sx, sy in _LEGS:
        hip_x, hip_y = sx * 0.3, sy * 0.104
        parts.append(f"""
  <joint name="{name}_HAA" type="revolute">
    <parent link="base"/><child link="{name}_HIP"/>
    <origin xyz="{hip_x} {hip_y} 0"/><axis xyz="1 0 0"/>
    <limit lower="-0.72" upper="0.72" effort="80" velocity="15"/>
  </joint>
  <link name="{name}_HIP">
    <inertial><mass value="1.4"/>
      <inertia ixx="0.003" iyy="0.003" izz="0.003" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <joint name="{name}_HFE" type="revolute">
    <parent link="{name}_HIP"/><child link="{name}_THIGH"/>
    <origin xyz="0 {sy*0.1} 0"/><axis xyz="0 1 0"/>
    <limit lower="-3.14" upper="3.14" effort="80" velocity="15"/>
  </joint>
  <link name="{name}_THIGH">
    <inertial><origin xyz="0 0 {-thigh_l/2}"/><mass value="1.6"/>
      <inertia ixx="{1.6*thigh_l**2/12:.5f}" iyy="{1.6*thigh_l**2/12:.5f}" izz="0.002" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 {-thigh_l/2}"/>
      <geometry><capsule radius="0.045" length="{thigh_l-0.09}"/></geometry></collision>
  </link>
  <joint name="{name}_KFE" type="revolute">
    <parent link="{name}_THIGH"/><child link="{name}_SHANK"/>
    <origin xyz="0 0 {-thigh_l}"/><axis xyz="0 1 0"/>
    <limit lower="-3.14" upper="3.14" effort="80" velocity="15"/>
  </joint>
  <link name="{name}_SHANK">
    <inertial><origin xyz="0 0 {-shank_l/2}"/><mass value="0.5"/>
      <inertia ixx="{0.5*shank_l**2/12:.5f}" iyy="{0.5*shank_l**2/12:.5f}" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision name="{name}_FOOT"><origin xyz="0 0 {-shank_l}"/>
      <geometry><sphere radius="0.03"/></geometry></collision>
  </link>""")
    return f'<robot name="anymal">{"".join(parts)}\n</robot>'


@dataclasses.dataclass(frozen=True)
class AnymalTaskState:
    commands: torch.Tensor   # (B, 3) vx, vy, yaw_rate
    actions: torch.Tensor    # (B, 12)


class Anymal(Task):
    num_actions = 12
    num_obs = 61
    clip_obs = 5.0

    # control (Anymal.yaml)
    Kp = 85.0
    Kd = 2.0
    action_scale = 0.5
    effort_limit = 80.0
    # reward scales, multiplied by dt in post_physics
    rew_lin_vel_xy = 1.0
    rew_ang_vel_z = 0.5
    rew_torque = -0.000025
    # normalization
    lin_vel_scale = 2.0
    ang_vel_scale = 0.25
    dof_pos_scale = 1.0
    dof_vel_scale = 0.05
    command_x_range = (-2.0, 2.0)
    command_y_range = (-1.0, 1.0)
    command_yaw_range = (-1.0, 1.0)
    episode_length_s = 50.0
    base_init_z = 0.62

    def __init__(self, num_envs: int = 4096, seed: int = 42, device=None, **_):
        super().__init__(num_envs, seed, device)
        dev = self.device
        model = load_urdf(make_anymal_urdf(), name="anymal")
        d = model._defaults
        d["drive_mode"] = np.full(model.nj, DRIVE_POS, np.int32)
        d["drive_stiffness"] = np.full(model.nj, self.Kp, np.float32)
        d["drive_damping"] = np.full(model.nj, self.Kd, np.float32)
        d["drive_effort_limit"] = np.full(model.nj, self.effort_limit, np.float32)
        self.model = model
        self.sim_params = SimParams(
            dt=1.0 / 60.0, substeps=4, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=3.0e4, contact_damping=800.0,
            friction_vel=0.05, plane_friction=1.0)
        self.default_dof_pos = torch.tensor(
            [DEFAULT_ANGLES[n] for n in model.joint_names], dtype=torch.float32, device=dev)
        self.knees = [model.body_id(f"{n}_THIGH") for n, _, _ in _LEGS]
        self.base_index = 0
        # device tensors built once (a constant made inside step_fn would be
        # a synchronous host copy)
        self._knees_idx = torch.tensor(self.knees, device=dev)
        self._root0 = torch.tensor([0.0, 0.0, self.base_init_z, 1.0, 0.0, 0.0, 0.0], device=dev)
        self._down = torch.tensor([0.0, 0.0, -1.0], device=dev)
        self.set_dt(self.sim_params.dt)

    def set_dt(self, dt: float) -> None:
        super().set_dt(dt)
        self.max_episode_length = int(self.episode_length_s / dt + 0.5)

    # ------------------------------------------------------------------
    def default_task_state(self):
        B = self.num_envs
        return AnymalTaskState(torch.zeros(B, 3, device=self.device),
                               torch.zeros(B, self.num_actions, device=self.device))

    def _uniform3(self, rng, ranges):
        return torch.cat([rng.uniform(1, lo, hi) for lo, hi in ranges], dim=-1)

    def _reset_joints(self, rng, B):
        nj = self.model.nj
        jq = self.default_dof_pos * rng.uniform(nj, 0.5, 1.5)
        jqd = rng.uniform(nj, -0.1, 0.1)
        qd = torch.cat([torch.zeros(B, 6, device=jq.device), jqd], dim=-1)
        return jq, qd

    def reset_fn(self, rng, params, task):
        B = task.actions.shape[0]
        jq, qd = self._reset_joints(rng, B)
        q = torch.cat([self._root0.expand(B, 7), jq], dim=-1)
        cmd = self._uniform3(rng, (self.command_x_range, self.command_y_range,
                                   self.command_yaw_range))
        return q, qd, params, AnymalTaskState(cmd, torch.zeros_like(task.actions))

    def pre_physics(self, state, actions):
        B = actions.shape[0]
        targets = self.action_scale * actions + self.default_dof_pos
        z = torch.zeros_like(targets)
        wrench = torch.zeros(B, self.model.nb, 6, device=actions.device)
        return Controls(targets, z, z), wrench, dataclasses.replace(state.task, actions=actions)

    def _torques(self, state, t):
        """Estimated applied PD torque (obs and reward; the drive itself runs
        inside the physics step)."""
        jq = state.q[:, 7:]
        jqd = state.qd[:, 6:]
        targets = self.action_scale * t.actions + self.default_dof_pos
        tau = self.Kp * (targets - jq) - self.Kd * jqd
        return torch.clamp(tau, -self.effort_limit, self.effort_limit)

    def _base_frame(self, state):
        """(base_lin_vel, base_ang_vel, projected_gravity), base frame."""
        quat = state.q[:, 3:7]
        base_lin_vel = Q.rotate_inv(quat, state.qd[:, 3:6])
        projected_gravity = Q.rotate_inv(quat, self._down.expand(quat.shape[0], 3))
        return base_lin_vel, state.qd[:, 0:3], projected_gravity

    def post_physics(self, state, prev_task):
        t = prev_task
        base_lin_vel, base_ang_vel, projected_gravity = self._base_frame(state)
        jq = state.q[:, 7:]
        jqd = state.qd[:, 6:]
        torques = self._torques(state, t)
        contact = torch.linalg.norm(state.net_contact, dim=-1)        # (B, nb)
        obs = torch.cat([
            base_lin_vel, base_ang_vel, torques, projected_gravity, contact,
            (jq - self.default_dof_pos) * self.dof_pos_scale,
            jqd * self.dof_vel_scale, t.commands,
        ], dim=-1)

        lin_vel_err = torch.sum((t.commands[:, :2] - base_lin_vel[:, :2]) ** 2, dim=1)
        ang_vel_err = (t.commands[:, 2] - base_ang_vel[:, 2]) ** 2
        r_lin = torch.exp(-lin_vel_err / 0.25) * (self.rew_lin_vel_xy * self.dt)
        r_ang = torch.exp(-ang_vel_err / 0.25) * (self.rew_ang_vel_z * self.dt)
        r_tau = torch.sum(torques ** 2, dim=1) * (self.rew_torque * self.dt)
        reward = torch.clamp(r_lin + r_ang + r_tau, min=0.0)

        base_hit = torch.linalg.norm(state.net_contact[:, self.base_index], dim=-1) > 1.0
        knee_hit = torch.any(
            torch.linalg.norm(state.net_contact[:, self._knees_idx], dim=-1) > 1.0, dim=1)
        done = base_hit | knee_hit

        metrics = dict(state.metrics)
        metrics["rew_lin_vel"] = r_lin
        metrics["rew_ang_vel"] = r_ang
        metrics["base_height"] = state.q[:, 2]
        return obs, reward, done.to(torch.float32), t, metrics
