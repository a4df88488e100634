"""FrankaCabinet: a Panda opens the top drawer of a cabinet. Port of
``thormang_isaacgym_tpu/tasks/franka_cabinet.py`` (the reference's
``tasks/franka_cabinet.py`` and ``cfg/task/FrankaCabinet.yaml``). The
sektion-cabinet asset is absent from this repository; an equivalent cabinet
(2 doors + 2 drawers, DOF 3 = drawer_top, prismatic stroke 0.4 m with a
graspable handle bar) is generated here, as in the JAX package.

- scene: two fixed actors, the Franka at (1, 0, 0) turned 180 degrees about
  z and the cabinet at (0, 0, 0.4); the finger pads (boxes) touch the
  drawers and chassis (box-box) and the handle bars (capsule-box), so the
  drawer opens by grasp friction: the kernel's box instance
- obs (23): [Franka DOF positions scaled to [-1, 1] (9), velocities x 0.1
  (9), drawer grasp - Franka grasp (3), drawer position (1), velocity (1)]
- actions (9): position-target rates, target += speed_scale dt a 7.5,
  clamped to the limits; finger speed scale 0.1
- reward: squared-inverse distance (doubled inside 2 cm), signed-square
  axis alignment, around-handle bonus, finger-distance shaping, open reward
  (drawer position x 7.5), action penalty 0.01, bonuses at 0.01 / 0.2 /
  0.39 m, -1 when a finger is behind the handle plane
- reset: Franka DOFs = default + U(-0.125, 0.125) clamped, cabinet DOFs 0;
  done when the drawer is out 0.39 m, or at the timeout of 500

Random draws are the port's per-env murmur3 streams (``EnvRandom``), not
the JAX package's threefry draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom, Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.franka import (
    FRANKA_DEFAULT_DOF_POS, franka_dof_ids, load_franka,
)
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams

DRAWER_STROKE = 0.4
HANDLE_X = 0.31          # handle bar x in drawer frame (front face + standoff)
DRAWER_Z = 0.23          # drawer joint height in cabinet frame (world z 0.63)
FRANKA_POSE = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)     # yaw 180 degrees
CABINET_POSE = (0.0, 0.0, 0.4, 1.0, 0.0, 0.0, 0.0)


def make_cabinet_urdf() -> str:
    """Sektion-cabinet equivalent: chassis + 2 doors + 2 drawers; DOF order
    [door_left, door_right, drawer_bottom, drawer_top] so DOF 3 is
    drawer_top_joint, as ``cabinet_dof_pos[:, 3]`` in the reference."""
    def drawer(name, z):
        return f"""
  <joint name="{name}_joint" type="prismatic">
    <parent link="chassis"/><child link="{name}"/>
    <origin xyz="0 0 {z}"/><axis xyz="1 0 0"/>
    <limit lower="0.0" upper="{DRAWER_STROKE}" effort="1000" velocity="2"/>
    <dynamics damping="5.0" friction="1.0"/>
  </joint>
  <link name="{name}">
    <inertial><mass value="2.0"/>
      <inertia ixx="0.05" iyy="0.05" izz="0.05" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision name="{name}_box"><origin xyz="0 0 0"/>
      <geometry><box size="0.56 0.6 0.12"/></geometry></collision>
    <collision name="{name}_handle"><origin xyz="{HANDLE_X} 0 0" rpy="1.57079632679 0 0"/>
      <geometry><capsule radius="0.01" length="0.16"/></geometry></collision>
  </link>"""

    def door(name, y, sign):
        return f"""
  <joint name="{name}_joint" type="revolute">
    <parent link="chassis"/><child link="{name}"/>
    <origin xyz="0.3 {y} -0.1"/><axis xyz="0 0 {sign}"/>
    <limit lower="0.0" upper="1.57" effort="1000" velocity="2"/>
    <dynamics damping="5.0" friction="1.0"/>
  </joint>
  <link name="{name}">
    <inertial><origin xyz="0 {-y/2} 0"/><mass value="1.5"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.02" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>"""

    return f"""
<robot name="cabinet">
  <link name="chassis">
    <inertial><mass value="50.0"/>
      <inertia ixx="5" iyy="5" izz="5" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision name="chassis_box"><origin xyz="-0.05 0 -0.05"/>
      <geometry><box size="0.5 0.7 0.7"/></geometry></collision>
  </link>
  {door("door_left", 0.35, 1)}
  {door("door_right", -0.35, -1)}
  {drawer("drawer_bottom", -0.05)}
  {drawer("drawer_top", DRAWER_Z)}
</robot>"""


@dataclasses.dataclass(frozen=True)
class FrankaCabinetTaskState:
    dof_targets: torch.Tensor   # (B, 9) Franka DOF position targets
    actions: torch.Tensor       # (B, 9) last raw actions (action penalty)


class FrankaCabinet(Task):
    num_obs = 23
    num_actions = 9
    max_episode_length = 500   # FrankaCabinet.yaml:10
    clip_obs = 5.0             # FrankaCabinet.yaml:13
    action_scale = 7.5
    dof_vel_scale = 0.1
    dist_reward_scale = 2.0
    rot_reward_scale = 0.5
    around_handle_reward_scale = 0.25
    open_reward_scale = 7.5
    finger_dist_reward_scale = 5.0
    action_penalty_scale = 0.01
    distX_offset = 0.04

    def __init__(self, num_envs: int = 4096, seed: int = 42, device=None, **_):
        super().__init__(num_envs, seed, device)
        dev = self.device
        franka = load_franka()
        cabinet = load_urdf(make_cabinet_urdf(), fix_base_link=True)
        scene = compose([(franka, FRANKA_POSE, "franka/"), (cabinet, CABINET_POSE, "cabinet/")],
                        name="franka_cabinet")
        self.model = scene
        self.fr_ids = np.array(franka_dof_ids(scene, "franka/"))
        self._fr = torch.as_tensor(self.fr_ids, device=dev)
        self.drawer_dof = scene.dof_id("cabinet/drawer_top_joint")
        self.drawer_body = scene.body_id("cabinet/drawer_top")
        self.lfinger_body = scene.body_id("franka/panda_leftfinger")
        self.rfinger_body = scene.body_id("franka/panda_rightfinger")
        gb, gp, gq = scene.sites["franka/panda_grasp"]
        self.grasp_body = gb
        self.grasp_pos_l = torch.tensor(np.asarray(gp, np.float32), device=dev)
        self.grasp_quat_l = torch.tensor(np.asarray(gq, np.float32), device=dev)
        d = scene._defaults
        self.fr_lower = torch.as_tensor(np.array(d["dof_lower"])[self.fr_ids], device=dev)
        self.fr_upper = torch.as_tensor(np.array(d["dof_upper"])[self.fr_ids], device=dev)
        self.default_dof = torch.as_tensor(FRANKA_DEFAULT_DOF_POS, device=dev)
        self.speed_scales = torch.tensor([1.0] * 7 + [0.1] * 2, device=dev)
        self._handle = torch.tensor([HANDLE_X, 0.0, 0.01], device=dev)
        self._axes = torch.eye(3, device=dev)
        self.sim_params = SimParams(
            dt=1.0 / 60.0, substeps=4, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=1.0e5, contact_damping=1.0e3,
            friction_vel=0.004, plane_friction=1.0,
            max_depenetration_velocity=0.5)
        self.dt = self.sim_params.dt

    # ------------------------------------------------------------------
    def default_task_state(self) -> FrankaCabinetTaskState:
        B = self.num_envs
        return FrankaCabinetTaskState(self.default_dof.expand(B, 9).clone(),
                                      torch.zeros(B, 9, device=self.device))

    def reset_fn(self, rng: EnvRandom, params, task):
        pos = self.default_dof + 0.25 * (rng.uniform(9) - 0.5)
        pos = torch.minimum(torch.maximum(pos, self.fr_lower), self.fr_upper)
        B = pos.shape[0]
        q = pos.new_zeros(B, self.model.nj)       # no floating roots: q is joint_q
        q[:, self._fr] = pos
        return q, torch.zeros(B, self.model.nv, device=pos.device), params, \
            FrankaCabinetTaskState(pos, torch.zeros_like(pos))

    def pre_physics(self, state, actions):
        B = actions.shape[0]
        t = state.task
        targets = t.dof_targets + self.speed_scales * self.dt * actions * self.action_scale
        targets = torch.minimum(torch.maximum(targets, self.fr_lower), self.fr_upper)
        full = actions.new_zeros(B, self.model.nj)
        full[:, self._fr] = targets
        z = torch.zeros_like(full)
        wrench = actions.new_zeros(B, self.model.nb, 6)
        return Controls(full, z, z), wrench, FrankaCabinetTaskState(targets, actions)

    def post_physics(self, state, prev_task):
        frames = forward_kinematics(self.model, state.q, state.qd)
        jq, jqd = state.q, state.qd               # fixed-base scene: q is joint_q
        fr_pos, fr_vel = jq[:, self._fr], jqd[:, self._fr]
        drawer_pos = jq[:, self.drawer_dof]
        drawer_vel = jqd[:, self.drawer_dof]
        # grasp frames (compute_grasp_transforms, :325-338)
        bq = frames.quat[:, self.grasp_body]
        gq = Q.mul(bq, self.grasp_quat_l.expand_as(bq))
        gp = frames.pos[:, self.grasp_body] + Q.rotate(bq, self.grasp_pos_l.expand(bq.shape[0], 3))
        dq_ = frames.quat[:, self.drawer_body]
        dp_ = frames.pos[:, self.drawer_body] + Q.rotate(dq_, self._handle.expand(dq_.shape[0], 3))
        lf = frames.pos[:, self.lfinger_body]
        rf = frames.pos[:, self.rfinger_body]

        dof_pos_scaled = 2.0 * (fr_pos - self.fr_lower) / (self.fr_upper - self.fr_lower) - 1.0
        to_target = dp_ - gp
        obs = torch.cat([dof_pos_scaled, fr_vel * self.dof_vel_scale, to_target,
                         drawer_pos[:, None], drawer_vel[:, None]], -1)
        reward, done = self._reward(prev_task.actions, gp, gq, dp_, dq_, lf, rf, drawer_pos)
        metrics = dict(state.metrics)
        metrics["drawer_pos"] = drawer_pos
        metrics["grasp_dist"] = torch.linalg.norm(to_target, dim=-1)
        return obs, reward, done, prev_task, metrics

    def _reward(self, actions, gp, gq, dp_, dq_, lf, rf, drawer_pos):
        d = torch.linalg.norm(gp - dp_, dim=-1)
        dist_reward = 1.0 / (1.0 + d ** 2)
        dist_reward = dist_reward * dist_reward
        dist_reward = torch.where(d <= 0.02, dist_reward * 2, dist_reward)

        ex, ey, ez = (a.expand(gp.shape[0], 3) for a in self._axes)
        axis1 = Q.rotate(gq, ez)          # gripper forward
        axis2 = Q.rotate(dq_, -ex)        # drawer inward
        axis3 = Q.rotate(gq, ey)          # gripper up
        axis4 = Q.rotate(dq_, ez)         # drawer up
        dot1 = torch.sum(axis1 * axis2, -1)
        dot2 = torch.sum(axis3 * axis4, -1)
        rot_reward = 0.5 * (torch.sign(dot1) * dot1 ** 2 + torch.sign(dot2) * dot2 ** 2)

        between = (lf[:, 2] > dp_[:, 2]) & (rf[:, 2] < dp_[:, 2])
        zero = torch.zeros_like(d)
        around = torch.where(between, zero + 0.5, zero)
        lfd = torch.abs(lf[:, 2] - dp_[:, 2])
        rfd = torch.abs(rf[:, 2] - dp_[:, 2])
        finger_dist = torch.where(between, (0.04 - lfd) + (0.04 - rfd), zero)
        open_reward = drawer_pos * around + drawer_pos      # :533
        action_penalty = torch.sum(actions ** 2, -1)

        rewards = (self.dist_reward_scale * dist_reward
                   + self.rot_reward_scale * rot_reward
                   + self.around_handle_reward_scale * around
                   + self.open_reward_scale * open_reward
                   + self.finger_dist_reward_scale * finger_dist
                   - self.action_penalty_scale * action_penalty)
        rewards = torch.where(drawer_pos > 0.01, rewards + 0.5, rewards)
        rewards = torch.where(drawer_pos > 0.2, rewards + around, rewards)
        rewards = torch.where(drawer_pos > 0.39, rewards + 2.0 * around, rewards)
        # style: a finger behind the handle plane
        rewards = torch.where(lf[:, 0] < dp_[:, 0] - self.distX_offset, zero - 1.0, rewards)
        rewards = torch.where(rf[:, 0] < dp_[:, 0] - self.distX_offset, zero - 1.0, rewards)
        done = (drawer_pos > 0.39).to(rewards.dtype)
        return rewards, done
