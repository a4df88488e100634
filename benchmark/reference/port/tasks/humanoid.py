"""Humanoid flat-ground locomotion. Port of
``thormang_isaacgym_tpu/tasks/humanoid.py`` (the reference's ``tasks/humanoid.py``
and ``cfg/task/Humanoid.yaml``, with the fork's reward).

- ``Humanoid``: the THORMANG robot from its URDF, which is not in the
  repository; the constructor raises ``FileNotFoundError`` without it.
- ``HumanoidMJCF``: the classic spec, ``assets/mjcf/nv_humanoid.xml``, 21
  DOFs, obs 110 / act 21, motor efforts from the MJCF actuator gears.

- obs (12 + 4N + 14): [torso_z, vel_loc(3), angvel_loc(3)*0.25, yaw, roll,
  angle_to_target, up_proj, heading_proj, dof_pos_scaled(N), dof_vel(N)*0.1,
  dof_force(N)*0.01, feet force-torque(12)*0.01, actions(N),
  potentials/60000, prev_potentials/60000]
- actions: N joint efforts * motor_efforts * power_scale
- reward: alive 2.0 + up (> 0.93: +0.1) + progress; death_cost below
  termination_height
- feet force-torque: each foot's net contact wrench in the foot frame
- reset: dof pos U(-0.1, 0.1) around the initial pose, vel U(-0.05, 0.05)
- ``randomize``: each body's mass x U(0.9, 1.1) every 600 steps (``MASS_DR``)
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from benchmark.reference.port.core import quat as Q
from benchmark.reference.port.engine.env import Task
from benchmark.reference.port.models import load_mjcf, load_urdf
from benchmark.reference.port.models.robot import DRIVE_EFFORT
from benchmark.reference.port.ops.kinematics import forward_kinematics
from benchmark.reference.port.ops.sim import Controls, SimParams
from benchmark.reference.port.tasks import common

REF_THORMANG = "/root/reference/assets/urdf/gogoro/urdf/thormang3.urdf"
NV_HUMANOID = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..", "..",
                                           "assets", "mjcf", "nv_humanoid.xml"))

# foot soles from robotis_l_leg_foot.obj bbox (x +-0.108, y -0.057..0.087,
# z -0.0275..0.015)
_FOOT_BOX = {"type": "box", "size": (0.108, 0.072, 0.021),
             "pos": (0.0, 0.015, -0.006), "quat": (1.0, 0, 0, 0)}


# the mass randomisation both humanoids take with ``randomize`` (every
# 600 steps, each body's mass x U(0.9, 1.1) on the actor ``humanoid``)
MASS_DR = {
    "frequency": 600,
    "actor_params": {"humanoid": {"rigid_body_properties": {
        "mass": {"range": [0.9, 1.1], "operation": "scaling",
                 "distribution": "uniform"}}}},
}


def _sphere(r, pos):
    return {"type": "sphere", "size": (r,), "pos": pos, "quat": (1, 0, 0, 0)}


@dataclasses.dataclass(frozen=True)
class HumanoidTaskState:
    potentials: torch.Tensor       # (B,)
    prev_potentials: torch.Tensor  # (B,)
    actions: torch.Tensor          # (B, N) last actions
    applied_torque: torch.Tensor   # (B, N) last efforts (the dof force sensors)


class Humanoid(Task):
    uses_net_torque = True   # 6-DOF feet force sensors read net_torque
    max_episode_length = 1000
    control_freq_inv = 1

    # Humanoid.yaml env block
    power_scale = 1.0
    heading_weight = 0.5
    up_weight = 0.1
    actions_cost_scale = 0.01
    energy_cost_scale = 0.05
    dof_vel_scale = 0.1
    angular_velocity_scale = 0.25
    contact_force_scale = 0.01
    joints_at_limit_cost_scale = 0.25
    death_cost = -1.0
    termination_height = 0.8

    def __init__(self, num_envs: int = 4096, seed: int = 42, device=None,
                 asset_path: str | None = None, randomize: bool = False, **_):
        super().__init__(num_envs, seed, device)
        path = asset_path or REF_THORMANG
        if not os.path.exists(path):
            raise FileNotFoundError(f"thormang asset not found at {path}")
        model = load_urdf(
            path,
            mesh_overrides={
                "l_leg_foot_link": _FOOT_BOX, "r_leg_foot_link": _FOOT_BOX,
                # coarse body collisions so falls make contact
                "pelvis_link": _sphere(0.15, (0, 0, 0)),
                "chest_link": _sphere(0.18, (0, 0, 0.1)),
                "l_leg_kn_p_link": _sphere(0.07, (0, 0, -0.15)),
                "r_leg_kn_p_link": _sphere(0.07, (0, 0, -0.15)),
            },
            armature=0.01,
        )
        d = model._defaults
        d["drive_mode"] = np.full(model.nj, DRIVE_EFFORT, np.int32)
        d["drive_effort_limit"] = np.full(model.nj, 1e6, np.float32)
        # passive joint damping helps stability of a 36-dof chain
        d["dof_damping"] = np.maximum(np.array(d["dof_damping"]), 0.5).astype(np.float32)
        # thormang URDF effort limits are a nominal 1000 Nm; cap at 300 Nm
        self._setup(model, np.full(model.nj, 300.0, np.float32),
                    ("l_leg_an_r_link", "r_leg_an_r_link"))
        if randomize:
            self.dr_config = MASS_DR

    def _setup(self, model, motor_efforts: np.ndarray, feet: tuple) -> None:
        dev = self.device
        self.model = model
        self.num_actions = model.nj
        self.num_obs = 12 + 4 * model.nj + 14
        self.sim_params = SimParams(
            dt=0.0166, substeps=4, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=4.0e4, contact_damping=1.5e3,
            friction_vel=0.05, plane_friction=1.0)
        self.dt = self.sim_params.dt
        self.motor_efforts = torch.as_tensor(motor_efforts, device=dev)
        self.max_motor_effort = float(np.max(motor_efforts))
        d = model._defaults
        dlower = np.array(d["dof_lower"], np.float32)
        dupper = np.array(d["dof_upper"], np.float32)
        self._init_jq = common.initial_dof_pos(dlower, dupper)
        self.init_jq = torch.as_tensor(self._init_jq, device=dev)
        self.dof_lower = torch.as_tensor(dlower, device=dev)
        self.dof_upper = torch.as_tensor(dupper, device=dev)
        self.spawn_z = common.solve_spawn_height(model, self._init_jq, clearance=0.02)
        self.feet = [model.body_id(n) for n in feet]
        self.net_torque_bodies = tuple(self.feet)
        # device tensors built once: a constant turned into a CUDA tensor
        # inside step_fn would be a synchronous host copy
        self._feet_idx = torch.tensor(self.feet, device=dev)
        self._root0 = torch.tensor([0.0, 0.0, self.spawn_z, 1.0, 0.0, 0.0, 0.0], device=dev)
        self.targets = torch.tensor([1000.0, 0.0, 0.0], device=dev)
        self.basis_vec0 = torch.tensor([1.0, 0.0, 0.0], device=dev)
        self.basis_vec1 = torch.tensor([0.0, 0.0, 1.0], device=dev)

    # ------------------------------------------------------------------
    def default_task_state(self):
        B, dev = self.num_envs, self.device
        p = torch.full((B,), -1000.0 / self.dt, device=dev)
        z = torch.zeros(B, self.num_actions, device=dev)
        return HumanoidTaskState(p, p, z, z)

    def reset_fn(self, rng, params, task):
        B, nj = task.actions.shape[0], self.model.nj
        jq = self.init_jq + rng.uniform(nj, -0.1, 0.1)
        jq = torch.minimum(torch.maximum(jq, self.dof_lower), self.dof_upper)
        jqd = rng.uniform(nj, -0.05, 0.05)
        q = torch.cat([self._root0.expand(B, 7), jq], dim=-1)
        qd = torch.cat([torch.zeros(B, 6, device=jq.device), jqd], dim=-1)
        to_target = self.targets - q[:, 0:3]
        pot = -torch.linalg.norm(to_target[:, 0:2], dim=-1) / self.dt
        z = torch.zeros_like(task.actions)
        return q, qd, params, HumanoidTaskState(pot, pot, z, z)

    def pre_physics(self, state, actions):
        efforts = actions * self.motor_efforts * self.power_scale
        z = torch.zeros_like(efforts)
        wrench = torch.zeros(actions.shape[0], self.model.nb, 6, device=actions.device)
        task = dataclasses.replace(state.task, actions=actions, applied_torque=efforts)
        return Controls(z, z, efforts), wrench, task

    def post_physics(self, state, prev_task):
        t = prev_task
        B = state.q.shape[0]
        pos = state.q[:, 0:3]
        quat = state.q[:, 3:7]
        vel_w = state.qd[:, 3:6]            # root linear velocity: world frame
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
        roll = common.normalize_angle(roll)
        yaw = common.normalize_angle(yaw)
        angle_to_target = common.normalize_angle(angle_to_target)

        dof_pos_scaled = common.unscale(jq, self.dof_lower, self.dof_upper)
        # 6-DOF feet force sensors: the contact wrench about each foot
        # origin, in the foot frame
        fq = forward_kinematics(self.model, state.q, state.qd).quat[:, self._feet_idx]
        feet_f = Q.rotate_inv(fq, state.net_contact[:, self._feet_idx, :])
        feet_t = Q.rotate_inv(fq, state.net_torque[:, self._feet_idx, :])
        sensors = torch.cat([feet_f, feet_t], dim=-1).reshape(B, 12)

        obs = torch.cat([
            pos[:, 2:3], vel_loc, angvel_loc * self.angular_velocity_scale,
            yaw[:, None], roll[:, None], angle_to_target[:, None],
            up_proj[:, None], heading_proj[:, None],
            dof_pos_scaled, jqd * self.dof_vel_scale,
            t.applied_torque * self.contact_force_scale,
            sensors * self.contact_force_scale,
            t.actions,
            potentials[:, None] / 60000.0, prev_pot[:, None] / 60000.0,
        ], dim=-1)

        # fork-modified reward: alive + up (+ progress); heading and energy
        # terms are off in the fork
        up_reward = torch.where(up_proj > 0.93, torch.full_like(up_proj, self.up_weight),
                                torch.zeros_like(up_proj))
        reward = potentials - prev_pot + 2.0 + up_reward
        fallen = pos[:, 2] < self.termination_height
        reward = torch.where(fallen, torch.full_like(reward, self.death_cost), reward)

        task = dataclasses.replace(t, potentials=potentials, prev_potentials=prev_pot)
        metrics = dict(state.metrics)
        metrics["torso_height"] = pos[:, 2]
        metrics["up_proj"] = up_proj
        return obs, reward, fallen.to(torch.float32), task, metrics


class HumanoidMJCF(Humanoid):
    """The classic Humanoid spec: nv_humanoid MJCF, 21 DOFs, obs 110 / act 21;
    motor efforts from the MJCF actuator gears."""

    def __init__(self, num_envs: int = 4096, seed: int = 42, device=None,
                 randomize: bool = False, **_):
        Task.__init__(self, num_envs, seed, device)
        model = load_mjcf(NV_HUMANOID)
        d = model._defaults
        d["drive_mode"] = np.full(model.nj, DRIVE_EFFORT, np.int32)
        d["drive_effort_limit"] = np.full(model.nj, 1e6, np.float32)
        self._setup(model, np.asarray(model.motor_efforts, np.float32),
                    ("right_foot", "left_foot"))
        if (self.num_obs, self.num_actions) != (110, 21):
            raise ValueError(f"nv_humanoid compiled to obs {self.num_obs} / act "
                             f"{self.num_actions}, expected 110 / 21")
        if randomize:
            self.dr_config = MASS_DR
