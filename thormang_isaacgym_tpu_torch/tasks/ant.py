"""Ant locomotion task. Port of ``thormang_isaacgym_tpu/tasks/ant.py``
(the reference's ``tasks/ant.py`` and ``cfg/task/Ant.yaml``).

The classic MuJoCo ant morphology is generated as URDF (``make_ant_urdf``,
the same string as the JAX package's): torso sphere r=0.25, four 2-segment
legs at 45-degree spokes, capsules r=0.08, density 5, hips +/-40 deg, ankles
30..100 deg, actuator gear 15.

- obs (60): [torso_z, vel_loc(3), angvel_loc(3), yaw, roll, angle_to_target,
  up_proj, heading_proj, dof_pos_scaled(8), dof_vel*0.2(8), feet
  force-torque(24)*0.1, actions(8)]
- actions: 8 joint efforts * gear 15 * power_scale
- reward: progress + alive 0.5 + up + heading - action, electricity and
  joints-at-limit costs; death_cost below termination_height
- reset: dof pos U(-0.2, 0.2) around the initial pose, vel U(-0.1, 0.1)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.robot import DRIVE_EFFORT
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams
from thormang_isaacgym_tpu_torch.tasks import common


def _capsule_inertial(mass, r, l):
    """Inertia of a capsule about its center, axis z (approx as cylinder)."""
    ixx = mass * (3 * r**2 + l**2) / 12.0
    izz = mass * r**2 / 2.0
    return ixx, ixx, izz


def make_ant_urdf() -> str:
    """Generate the ant URDF (see module docstring for provenance)."""
    density = 5.0
    r = 0.08
    torso_r = 0.25
    torso_m = density * 4.0 / 3.0 * np.pi * torso_r**3
    torso_i = 0.4 * torso_m * torso_r**2

    legs = [
        ("front_left", 45.0), ("front_right", -45.0),
        ("back_left", 135.0), ("back_right", -135.0),
    ]
    seg1 = 0.2 * np.sqrt(2)   # upper leg length
    seg2 = 0.4 * np.sqrt(2)   # foot length

    def cap_mass(length):
        return density * (np.pi * r**2 * length + 4.0 / 3.0 * np.pi * r**3)

    parts = [f"""
  <link name="torso">
    <inertial><mass value="{torso_m:.4f}"/>
      <inertia ixx="{torso_i:.5f}" iyy="{torso_i:.5f}" izz="{torso_i:.5f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><sphere radius="{torso_r}"/></geometry></collision>
  </link>"""]

    for name, ang in legs:
        a = np.radians(ang)
        c, s = np.cos(a), np.sin(a)
        hip_xy = (0.2 * np.sqrt(2)) * np.array([c, s])
        m1, m2 = cap_mass(seg1), cap_mass(seg2)
        i1 = _capsule_inertial(m1, r, seg1)
        i2 = _capsule_inertial(m2, r, seg2)
        # capsule local axis z; orient along leg direction d=(c,s,0):
        # rotate z onto d: pitch 90deg about y then yaw `a` about z
        rpy = f"0 1.5707963 {a:.7f}"
        # hip: rotation about world z at the torso attachment point
        parts.append(f"""
  <joint name="hip_{name}" type="revolute">
    <parent link="torso"/><child link="leg_{name}"/>
    <origin xyz="{hip_xy[0]:.4f} {hip_xy[1]:.4f} 0"/>
    <axis xyz="0 0 1"/>
    <limit lower="-0.6981" upper="0.6981" effort="15" velocity="100"/>
  </joint>
  <link name="leg_{name}">
    <inertial><origin xyz="{c*seg1/2:.4f} {s*seg1/2:.4f} 0" rpy="{rpy}"/>
      <mass value="{m1:.4f}"/>
      <inertia ixx="{i1[0]:.6f}" iyy="{i1[1]:.6f}" izz="{i1[2]:.6f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="{c*seg1/2:.4f} {s*seg1/2:.4f} 0" rpy="{rpy}"/>
      <geometry><capsule radius="{r}" length="{seg1:.4f}"/></geometry></collision>
  </link>
  <joint name="ankle_{name}" type="revolute">
    <parent link="leg_{name}"/><child link="foot_{name}"/>
    <origin xyz="{c*seg1:.4f} {s*seg1:.4f} 0"/>
    <axis xyz="{-s:.6f} {c:.6f} 0"/>
    <limit lower="0.5236" upper="1.7453" effort="15" velocity="100"/>
  </joint>
  <link name="foot_{name}">
    <inertial><origin xyz="{c*seg2/2:.4f} {s*seg2/2:.4f} 0" rpy="{rpy}"/>
      <mass value="{m2:.4f}"/>
      <inertia ixx="{i2[0]:.6f}" iyy="{i2[1]:.6f}" izz="{i2[2]:.6f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="{c*seg2/2:.4f} {s*seg2/2:.4f} 0" rpy="{rpy}"/>
      <geometry><capsule radius="{r}" length="{seg2:.4f}"/></geometry></collision>
  </link>""")

    return f'<robot name="ant">{"".join(parts)}\n</robot>'


@dataclasses.dataclass(frozen=True)
class AntTaskState:
    potentials: torch.Tensor        # (B,)
    prev_potentials: torch.Tensor   # (B,)
    actions: torch.Tensor           # (B, 8) last actions (obs + reward)


class Ant(Task):
    num_actions = 8
    num_obs = 60
    max_episode_length = 1000
    control_freq_inv = 1

    # Ant.yaml env block
    power_scale = 1.0
    heading_weight = 0.5
    up_weight = 0.1
    actions_cost_scale = 0.005
    energy_cost_scale = 0.05
    dof_vel_scale = 0.2
    contact_force_scale = 0.1
    joints_at_limit_cost_scale = 0.1
    death_cost = -2.0
    termination_height = 0.31

    def __init__(self, num_envs: int = 4096, seed: int = 42, device=None, **_):
        super().__init__(num_envs, seed, device)
        dev = self.device
        model = load_urdf(make_ant_urdf(), name="ant")
        d = model._defaults
        d["drive_mode"] = np.full(model.nj, DRIVE_EFFORT, np.int32)
        d["drive_effort_limit"] = np.full(model.nj, 1e6, np.float32)
        self.model = model
        self.sim_params = SimParams(
            dt=1.0 / 60.0, substeps=4, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=2.0e3, contact_damping=60.0,
            friction_vel=0.05, plane_friction=1.0)
        self.joint_gears = torch.full((model.nj,), 15.0, device=dev)
        self.dt = self.sim_params.dt
        dlower = np.array(d["dof_lower"], np.float32)
        dupper = np.array(d["dof_upper"], np.float32)
        self._init_jq = common.initial_dof_pos(dlower, dupper)
        self.init_jq = torch.as_tensor(self._init_jq, device=dev)
        self.dof_lower = torch.as_tensor(dlower, device=dev)
        self.dof_upper = torch.as_tensor(dupper, device=dev)
        self.spawn_z = common.solve_spawn_height(model, self._init_jq, clearance=0.01)
        self.feet = [model.body_id(f"foot_{n}") for n in
                     ("front_left", "front_right", "back_left", "back_right")]
        # device tensors built once: a Python list or constant turned into a
        # CUDA tensor inside step_fn would be a synchronous host copy
        self._feet_idx = torch.tensor(self.feet, device=dev)
        self._root0 = torch.tensor([0.0, 0.0, self.spawn_z, 1.0, 0.0, 0.0, 0.0], device=dev)
        self.targets = torch.tensor([1000.0, 0.0, 0.0], device=dev)
        self.basis_vec0 = torch.tensor([1.0, 0.0, 0.0], device=dev)
        self.basis_vec1 = torch.tensor([0.0, 0.0, 1.0], device=dev)

    def default_task_state(self):
        B = self.num_envs
        p = torch.full((B,), -1000.0 / self.dt, device=self.device)
        return AntTaskState(p, p, torch.zeros(B, self.num_actions, device=self.device))

    def reset_fn(self, rng, params, task):
        B, nj = task.actions.shape[0], self.model.nj
        jq = self.init_jq + rng.uniform(nj, -0.2, 0.2)
        jq = torch.minimum(torch.maximum(jq, self.dof_lower), self.dof_upper)
        jqd = rng.uniform(nj, -0.1, 0.1)
        q = torch.cat([self._root0.expand(B, 7), jq], dim=-1)
        qd = torch.cat([torch.zeros(B, 6, device=jq.device), jqd], dim=-1)
        to_target = self.targets - q[:, 0:3]
        pot = -torch.linalg.norm(to_target[:, 0:2], dim=-1) / self.dt
        return q, qd, params, AntTaskState(pot, pot, torch.zeros_like(task.actions))

    def pre_physics(self, state, actions):
        efforts = actions * self.joint_gears * self.power_scale
        z = torch.zeros_like(efforts)
        B = actions.shape[0]
        wrench = torch.zeros(B, self.model.nb, 6, device=actions.device)
        return Controls(z, z, efforts), wrench, dataclasses.replace(state.task, actions=actions)

    def post_physics(self, state, prev_task):
        t = prev_task
        B = state.q.shape[0]
        pos = state.q[:, 0:3]
        quat = state.q[:, 3:7]
        vel_w = state.qd[:, 3:6]
        angvel_w = Q.rotate(quat, state.qd[:, 0:3])
        jq = state.q[:, 7:]
        jqd = state.qd[:, 6:]

        to_target = self.targets - pos
        to_target = torch.cat([to_target[:, 0:2], torch.zeros_like(to_target[:, 2:3])], dim=-1)
        prev_pot = t.potentials
        potentials = -torch.linalg.norm(to_target, dim=-1) / self.dt

        _, up_proj, heading_proj, _, _ = common.compute_heading_and_up(
            quat, Q.identity((B,), device=quat.device), to_target,
            self.basis_vec0, self.basis_vec1)
        vel_loc, angvel_loc, roll, _, yaw, angle_to_target = common.compute_rot(
            quat, vel_w, angvel_w, self.targets, pos)
        dof_pos_scaled = common.unscale(jq, self.dof_lower, self.dof_upper)
        # force "sensors": per-foot net contact force + zero torque
        feet = state.net_contact[:, self._feet_idx, :]
        sensors = torch.cat([feet, torch.zeros_like(feet)], dim=-1).reshape(B, 24)
        obs = torch.cat([
            pos[:, 2:3], vel_loc, angvel_loc,
            yaw[:, None], roll[:, None], angle_to_target[:, None],
            up_proj[:, None], heading_proj[:, None],
            dof_pos_scaled, jqd * self.dof_vel_scale,
            sensors * self.contact_force_scale, t.actions,
        ], dim=-1)

        heading_reward = torch.where(heading_proj > 0.8,
                                     torch.full_like(heading_proj, self.heading_weight),
                                     self.heading_weight * heading_proj / 0.8)
        up_reward = torch.where(up_proj > 0.93, torch.full_like(up_proj, self.up_weight),
                                torch.zeros_like(up_proj))
        actions_cost = torch.sum(t.actions ** 2, dim=-1)
        electricity = torch.sum(torch.abs(t.actions * jqd * self.dof_vel_scale), dim=-1)
        at_limit = torch.sum((dof_pos_scaled > 0.99).to(torch.float32), dim=-1)
        reward = (potentials - prev_pot + 0.5 + up_reward + heading_reward
                  - self.actions_cost_scale * actions_cost
                  - self.energy_cost_scale * electricity
                  - self.joints_at_limit_cost_scale * at_limit)
        fallen = pos[:, 2] < self.termination_height
        reward = torch.where(fallen, torch.full_like(reward, self.death_cost), reward)

        task = dataclasses.replace(t, potentials=potentials, prev_potentials=prev_pot)
        metrics = dict(state.metrics)
        metrics["torso_height"] = pos[:, 2]
        metrics["heading_proj"] = heading_proj
        return obs, reward, fallen.to(torch.float32), task, metrics
