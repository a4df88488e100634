"""Ingenuity: the Mars helicopter hovering to a moving target. Port of
``thormang_isaacgym_tpu/tasks/ingenuity.py`` (the reference's
``tasks/ingenuity.py`` and ``cfg/task/Ingenuity.yaml``).

The copter is generated as URDF (``make_ingenuity_urdf``, the same string
as the JAX package's): a chassis box of half size 0.06 m, density 50, and
two coaxial rotor disks r 0.15 m, t 0.01 m, density 1000, 0.025 m apart, on
fixed joints. The rotors merge into the chassis: one floating body with no
joints, its ground candidates the box's corners and the two disks' rims,
the rotor attachment points kept as thrust sites.

- Mars gravity (0, 0, -3.721), set in code by the reference's create_sim:
  it holds under the YAML, whose sim block (dt 0.01 s, 2 substeps) still
  applies, but whose gravity (-9.81) does not (``fixed_gravity``). The model's
  defaults carry it too, so the physics flies under it. (The JAX class sets
  -3.721 in its sim parameters only; its model parameters keep Earth's.)
- obs (13): [target - pos, root quat, linvel / 2, angvel (world)]
- actions (6): per rotor a thrust vector in the body frame, vertical
  clamp(a_z 2000) dt, lateral vertical x clamp(a_xy, +/-0.2), applied at the
  rotor site: a world force and its torque r x f about the body origin,
  through the kernel's per-body wrench
- reward: pos 1 / (1 + d^2) x (1 + up 5 / (1 + tilt^2) + spin 1 / (1 +
  w_z^2)); done at d > 8 or z < 0.5
- reset: spawn (+/-1.5, +/-1.5, 1 + U(-0.2, 1.5)); the target resampled at
  reset and every 500 steps to xy +/-5, z in (1, 2)

Random draws are the port's per-env EnvRandom streams: the reset's on the
env's episode, the target resampling's (salt 501) on the global step. They
are not the JAX package's threefry draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom, Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams

ROTOR_SEP = 0.025
THRUST_LIMIT = 2000.0
LATERAL_FRAC = 0.2
MARS_GRAVITY = (0.0, 0.0, -3.721)


def make_ingenuity_urdf() -> str:
    cs = 0.06
    m_ch = 50.0 * (2 * cs) ** 3
    i_ch = m_ch * (2 * cs) ** 2 / 6
    rr, rt = 0.15, 0.01
    m_r = 1000.0 * np.pi * rr * rr * rt
    i_rz = 0.5 * m_r * rr * rr
    i_rx = m_r * (3 * rr * rr + rt * rt) / 12
    rotors = "".join(f"""
  <joint name="rotor_joint_{i}" type="fixed">
    <parent link="chassis"/><child link="rotor_{i}"/>
    <origin xyz="0 0 {i * ROTOR_SEP}"/>
  </joint>
  <link name="rotor_{i}">
    <inertial><mass value="{m_r:.4f}"/>
      <inertia ixx="{i_rx:.5f}" iyy="{i_rx:.5f}" izz="{i_rz:.5f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><cylinder radius="{rr}" length="{rt}"/></geometry></collision>
  </link>""" for i in range(2))
    return f"""
<robot name="ingenuity">
  <link name="chassis">
    <inertial><mass value="{m_ch:.4f}"/>
      <inertia ixx="{i_ch:.5f}" iyy="{i_ch:.5f}" izz="{i_ch:.5f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><box size="{2*cs} {2*cs} {2*cs}"/></geometry></collision>
  </link>{rotors}
</robot>"""


@dataclasses.dataclass(frozen=True)
class IngenuityTaskState:
    target: torch.Tensor    # (B, 3) hover target


def _sample_target(u: torch.Tensor) -> torch.Tensor:
    """(B, 3) uniforms -> targets: xy in [-5, 5), z in [1, 2)."""
    return torch.cat([-5.0 + 10.0 * u[:, 0:2], 1.0 + u[:, 2:3]], -1)


class Ingenuity(Task):
    num_obs = 13
    num_actions = 6
    max_episode_length = 2000
    fixed_gravity = True

    def __init__(self, num_envs: int = 4096, seed: int = 42, device=None, **_):
        super().__init__(num_envs, seed, device)
        dev = self.device
        self.model = load_urdf(make_ingenuity_urdf())
        self.model._defaults["gravity"] = np.asarray(MARS_GRAVITY, np.float32)
        self.rotor_sites = [self.model.sites[f"rotor_{i}"] for i in range(2)]
        self._site_body = [int(b) for b, _, _ in self.rotor_sites]
        self._site_pos = torch.tensor(np.array([p for _, p, _ in self.rotor_sites]),
                                      dtype=torch.float32, device=dev)
        self.sim_params = SimParams(
            dt=0.01, substeps=2, gravity=MARS_GRAVITY,
            contact_stiffness=1.0e4, contact_damping=300.0)
        self.dt = self.sim_params.dt

    def default_task_state(self) -> IngenuityTaskState:
        return IngenuityTaskState(torch.zeros(self.num_envs, 3, device=self.device))

    def reset_fn(self, rng: EnvRandom, params, task):
        u = rng.uniform(3)
        lo, hi = u.new_tensor([-1.5, -1.5, -0.2]), u.new_tensor([1.5, 1.5, 1.5])
        pos = u.new_tensor([0.0, 0.0, 1.0]) + lo + (hi - lo) * u
        B = pos.shape[0]
        q = torch.cat([pos, Q.identity((B,), device=pos.device)], -1)
        qd = torch.zeros(B, self.model.nv, device=pos.device)
        return q, qd, params, IngenuityTaskState(_sample_target(rng.uniform(3)))

    def pre_physics(self, state, actions):
        B, m = actions.shape[0], self.model
        a = actions.reshape(B, 2, 3)
        # per-rotor thrust vectors in the body frame
        tz = self.dt * torch.clamp(a[..., 2] * THRUST_LIMIT, -THRUST_LIMIT, THRUST_LIMIT)
        thrust = torch.cat([tz[..., None] * torch.clamp(a[..., 0:2], -LATERAL_FRAC, LATERAL_FRAC),
                            tz[..., None]], -1)
        root_q = state.q[:, None, 3:7].expand(B, 2, 4)
        f_w = Q.rotate(root_q, thrust)
        tau_w = torch.linalg.cross(Q.rotate(root_q, self._site_pos.expand(B, 2, 3)), f_w)
        wrench = actions.new_zeros(B, m.nb, 6)
        for k, body in enumerate(self._site_body):
            wrench[:, body, 0:3] += tau_w[:, k]
            wrench[:, body, 3:6] += f_w[:, k]
        z = actions.new_zeros(B, m.nj)
        return Controls(z, z, z), wrench, state.task

    def post_physics(self, state, prev_task):
        pos, quat = state.q[:, 0:3], state.q[:, 3:7]
        omega_w = Q.rotate(quat, state.qd[:, 0:3])
        linvel = state.qd[:, 3:6]
        # the target resampled every 500 steps
        due = ((state.progress % 500) == 0) & (state.progress > 0)
        new_t = _sample_target(EnvRandom.of_step(state, 501).uniform(3))
        target = torch.where(due[:, None], new_t, prev_task.target)
        obs = torch.cat([target - pos, quat, linvel / 2.0, omega_w], -1)
        d = torch.linalg.norm(target - pos, dim=-1)
        pos_reward = 1.0 / (1.0 + d * d)
        up = Q.rotate(quat, pos.new_tensor([0.0, 0.0, 1.0]).expand_as(pos))
        tilt = torch.abs(1.0 - up[:, 2])
        up_reward = 5.0 / (1.0 + tilt * tilt)
        spin = torch.abs(omega_w[:, 2])
        spin_reward = 1.0 / (1.0 + spin * spin)
        reward = pos_reward + pos_reward * (up_reward + spin_reward)
        die = (d > 8.0) | (pos[:, 2] < 0.5)
        metrics = dict(state.metrics)
        metrics["target_dist"] = d
        return obs, reward, die.to(torch.float32), IngenuityTaskState(target), metrics
