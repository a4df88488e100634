"""Quadcopter: four tilt-rotor arms hovering to (0, 0, 1). Port of
``thormang_isaacgym_tpu/tasks/quadcopter.py`` (the reference's
``tasks/quadcopter.py`` and ``cfg/task/Quadcopter.yaml``).

The copter is generated as URDF (``make_quadcopter_urdf``, the same string
as the JAX package's): a chassis cylinder r 0.1 m, t 0.03 m, density 50;
four arms at 45/135/225/315 degrees, each a pitch hinge (axis y, +/-30
degrees) to an arm sphere r 0.01 m, then a roll hinge (axis x, +/-30
degrees) to a rotor disk r 0.04 m, t 0.01 m, density 1000. 9 links, 8 DOFs
position-driven (kp 1000, kd 20), in the reference's interleaved order [p0,
r0, p1, r1, ...] on the task side.

- obs (24): [(target - pos) / 3, quat, linvel / 2, angvel (world), dof_pos
  (8, reference order), pos]
- actions (12): dof target rates, targets += dt 8 pi a, clamped to +/-30
  degrees; thrust rates, thrusts += dt 200 a, clamped to [0, 2], each a
  force along its rotor's z axis, through the kernel's per-body wrench
- reward: pos 1 / (1 + d^2) x (1 + up + spin), d to (0, 0, 1); done at d > 3
  or z < 0.3
- reset: root (+/-1.5, +/-1.5, 1 + U(-0.2, 1.5)); dof pos U(-0.2, 0.2), from
  the env's EnvRandom stream
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom, Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.robot import DRIVE_POS
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams

ROTOR_ANGLES = [0.25 * math.pi, 0.75 * math.pi, 1.25 * math.pi, 1.75 * math.pi]
DOF_LIMIT = math.radians(30.0)


def make_quadcopter_urdf() -> str:
    ch_r, ch_t = 0.1, 0.03
    m_ch = 50.0 * np.pi * ch_r ** 2 * ch_t
    i_ch = 0.25 * m_ch * ch_r ** 2
    arm_r = 0.01
    m_arm = 200.0 * 4 / 3 * np.pi * arm_r ** 3
    rot_r, rot_t = 0.04, 0.01
    m_rot = 1000.0 * np.pi * rot_r ** 2 * rot_t
    i_rz = 0.5 * m_rot * rot_r ** 2
    i_rx = m_rot * (3 * rot_r ** 2 + rot_t ** 2) / 12
    arm_off = ch_r + 0.25 * arm_r
    rot_off = rot_r + 0.25 * arm_r
    parts = [f"""
  <link name="chassis">
    <inertial><mass value="{m_ch:.4f}"/>
      <inertia ixx="{i_ch:.5f}" iyy="{i_ch:.5f}" izz="{2*i_ch:.5f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><cylinder radius="{ch_r}" length="{ch_t}"/></geometry></collision>
  </link>"""]
    for i, ang in enumerate(ROTOR_ANGLES):
        c, s = math.cos(ang), math.sin(ang)
        parts.append(f"""
  <joint name="rotor_pitch{i}" type="revolute">
    <parent link="chassis"/><child link="rotor_arm{i}"/>
    <origin xyz="{arm_off*c:.5f} {arm_off*s:.5f} 0" rpy="0 0 {ang:.6f}"/>
    <axis xyz="0 1 0"/>
    <limit lower="{-DOF_LIMIT:.5f}" upper="{DOF_LIMIT:.5f}" effort="50" velocity="50"/>
  </joint>
  <link name="rotor_arm{i}">
    <inertial><mass value="{m_arm:.6f}"/>
      <inertia ixx="1e-6" iyy="1e-6" izz="1e-6" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><sphere radius="{arm_r}"/></geometry></collision>
  </link>
  <joint name="rotor_roll{i}" type="revolute">
    <parent link="rotor_arm{i}"/><child link="rotor{i}"/>
    <origin xyz="{rot_off:.5f} 0 0"/>
    <axis xyz="1 0 0"/>
    <limit lower="{-DOF_LIMIT:.5f}" upper="{DOF_LIMIT:.5f}" effort="50" velocity="50"/>
  </joint>
  <link name="rotor{i}">
    <inertial><mass value="{m_rot:.5f}"/>
      <inertia ixx="{i_rx:.7f}" iyy="{i_rx:.7f}" izz="{i_rz:.7f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><cylinder radius="{rot_r}" length="{rot_t}"/></geometry></collision>
  </link>""")
    return "<robot name=\"quadcopter\">" + "".join(parts) + "\n</robot>"


@dataclasses.dataclass(frozen=True)
class QuadTaskState:
    dof_targets: torch.Tensor   # (B, 8) reference order
    thrusts: torch.Tensor       # (B, 4)


class Quadcopter(Task):
    num_obs = 24
    num_actions = 12
    max_episode_length = 500

    def __init__(self, num_envs: int = 8192, seed: int = 42, device=None, **_):
        super().__init__(num_envs, seed, device)
        dev = self.device
        m = load_urdf(make_quadcopter_urdf())
        d = m._defaults
        d["drive_mode"] = np.full(m.nj, DRIVE_POS, np.int32)
        d["drive_stiffness"] = np.full(m.nj, 1000.0, np.float32)
        d["drive_damping"] = np.full(m.nj, 20.0, np.float32)
        self.model = m
        # the reference's interleaved dof order [p0, r0, p1, r1, ...]
        self.ref_dof_order = np.array([m.dof_id(f"rotor_{k}{i}") for i in range(4)
                                       for k in ("pitch", "roll")])
        self.rotor_bodies = np.array([m.body_id(f"rotor{i}") for i in range(4)])
        self._ref = torch.as_tensor(self.ref_dof_order, device=dev)
        self._rotors = torch.as_tensor(self.rotor_bodies, device=dev)
        self._target = torch.tensor([0.0, 0.0, 1.0], device=dev)
        self.sim_params = SimParams(
            dt=0.01, substeps=2, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=1.0e4, contact_damping=300.0)
        self.dt = self.sim_params.dt

    def default_task_state(self) -> QuadTaskState:
        B, dev = self.num_envs, self.device
        return QuadTaskState(torch.zeros(B, 8, device=dev), torch.zeros(B, 4, device=dev))

    def reset_fn(self, rng: EnvRandom, params, task):
        u = rng.uniform(3)
        lo, hi = u.new_tensor([-1.5, -1.5, -0.2]), u.new_tensor([1.5, 1.5, 1.5])
        pos = self._target + lo + (hi - lo) * u
        jq = rng.uniform(self.model.nj, -0.2, 0.2)
        B = jq.shape[0]
        q = torch.cat([pos, Q.identity((B,), device=jq.device), jq], -1)
        qd = torch.zeros(B, self.model.nv, device=jq.device)
        return q, qd, params, QuadTaskState(jq[:, self._ref], torch.zeros(B, 4, device=jq.device))

    def pre_physics(self, state, actions):
        B, m = actions.shape[0], self.model
        t = state.task
        targets = torch.clamp(t.dof_targets + self.dt * 8 * math.pi * actions[:, 0:8],
                              -DOF_LIMIT, DOF_LIMIT)
        thrusts = torch.clamp(t.thrusts + self.dt * 200.0 * actions[:, 8:12], 0.0, 2.0)
        tpos = actions.new_zeros(B, m.nj)
        tpos[:, self._ref] = targets
        z = actions.new_zeros(B, m.nj)
        # thrust along each rotor's z axis (the reference's LOCAL_SPACE force)
        rot_q = forward_kinematics(m, state.q, state.qd).quat[:, self._rotors]
        zdir = Q.rotate(rot_q, actions.new_tensor([0.0, 0.0, 1.0]).expand(B, 4, 3))
        wrench = actions.new_zeros(B, m.nb, 6)
        wrench[:, self._rotors, 3:6] = thrusts[..., None] * zdir
        return Controls(tpos, z, z), wrench, QuadTaskState(targets, thrusts)

    def post_physics(self, state, prev_task):
        pos, quat = state.q[:, 0:3], state.q[:, 3:7]
        omega_w = Q.rotate(quat, state.qd[:, 0:3])
        linvel = state.qd[:, 3:6]
        jq = state.q[:, 7:][:, self._ref]
        obs = torch.cat([(self._target - pos) / 3.0, quat, linvel / 2.0, omega_w, jq,
                         pos], -1)[:, :self.num_obs]
        d = torch.linalg.norm(self._target - pos, dim=-1)
        pos_reward = 1.0 / (1.0 + d * d)
        up = Q.rotate(quat, pos.new_tensor([0.0, 0.0, 1.0]).expand_as(pos))
        tilt = torch.abs(1.0 - up[:, 2])
        up_reward = 1.0 / (1.0 + tilt * tilt)
        spin = torch.abs(omega_w[:, 2])
        spin_reward = 1.0 / (1.0 + spin * spin)
        reward = pos_reward + pos_reward * (up_reward + spin_reward)
        die = (d > 3.0) | (pos[:, 2] < 0.3)
        metrics = dict(state.metrics)
        metrics["target_dist"] = d
        return obs, reward, die.to(torch.float32), prev_task, metrics
