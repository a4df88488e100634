"""BallBalance: a tripod tray balancing a free ball. Port of
``thormang_isaacgym_tpu/tasks/ball_balance.py`` (the reference's
``tasks/ball_balance.py`` and ``cfg/task/BallBalance.yaml``).

The balance bot is generated procedurally (``make_bbot_urdf``, the same
string as the JAX package's): a tray cylinder r=0.5 t=0.02 density 100 and
three 2-link capsule legs r=0.02 at 120-degree spokes with knee hinges. It is
composed with a free ball (r=0.1, mass 1) into a two-actor scene, so the
ball collides with the tray and the six leg capsules (7 round actor pairs);
the feet are pinned by three world-point attractors.

- obs (24): [knee pos (3), knee vel (3), ball pos (3), ball linvel (3), leg
  force sensors / 20 (12): the force of lower leg 0 and the torques of the
  three lower legs, in each leg's frame]
- actions (3): knee position-target velocities, target += dt *
  action_speed_scale * a clamped to the joint limits; knee PD kp 4000 kd 100,
  effort 30, dof damping 2 on every leg joint
- reward = 1 / (1 + |ball - (0, 0, 0.7)|) * 1 / (1 + |ball vel|)
- done when ball z < 1.5 r (or timeout); the ball respawns at a random
  radial position and height with an inward, falling velocity
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.robot import DRIVE_POS
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams

TRAY_RADIUS = 0.5
TRAY_THICK = 0.02
LEG_R = 0.02
LEG_OUTER = TRAY_RADIUS - 0.1
LEG_LEN = LEG_OUTER - 2 * LEG_R
LEG_INNER = LEG_OUTER - LEG_LEN / math.sqrt(2)
TRAY_H = LEG_LEN * math.sqrt(2) + 2 * LEG_R + 0.5 * TRAY_THICK
BALL_R = 0.1
_LEG_ANGLES = (0.0, 2 * math.pi / 3, 4 * math.pi / 3)


def _leg_urdf_fragment(i: int, angle: float) -> str:
    """One 2-link leg: the upper-leg joint at the tray rim (axis tangential),
    the knee joining upper and lower leg."""
    c, s = math.cos(angle), math.sin(angle)
    jx, jy = LEG_OUTER * c, LEG_OUTER * s
    jz = -LEG_R - 0.5 * TRAY_THICK
    m = 0.57  # capsule mass (density 1000)
    izz = 1e-5
    ixx = m * LEG_LEN**2 / 12.0
    return f"""
  <joint name="upper_leg_joint{i}" type="revolute">
    <parent link="tray"/><child link="upper_leg{i}"/>
    <origin xyz="{jx:.6f} {jy:.6f} {jz:.6f}" rpy="0 {-0.75*math.pi:.8f} {angle:.8f}"/>
    <axis xyz="0 1 0"/>
    <limit lower="-0.7854" upper="0.7854" effort="100" velocity="20"/>
  </joint>
  <link name="upper_leg{i}">
    <inertial><origin xyz="0 0 {LEG_LEN/2:.6f}"/><mass value="{m:.4f}"/>
      <inertia ixx="{ixx:.6f}" iyy="{ixx:.6f}" izz="{izz}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 {LEG_LEN/2:.6f}"/>
      <geometry><capsule radius="{LEG_R}" length="{LEG_LEN:.6f}"/></geometry></collision>
  </link>
  <joint name="lower_leg_joint{i}" type="revolute">
    <parent link="upper_leg{i}"/><child link="lower_leg{i}"/>
    <origin xyz="0 0 {LEG_LEN:.6f}" rpy="0 {-0.5*math.pi:.8f} 0"/>
    <axis xyz="0 1 0"/>
    <limit lower="-1.2217" upper="1.5708" effort="100" velocity="20"/>
  </joint>
  <link name="lower_leg{i}">
    <inertial><origin xyz="0 0 {LEG_LEN/2:.6f}"/><mass value="{m:.4f}"/>
      <inertia ixx="{ixx:.6f}" iyy="{ixx:.6f}" izz="{izz}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 {LEG_LEN/2:.6f}"/>
      <geometry><capsule radius="{LEG_R}" length="{LEG_LEN:.6f}"/></geometry></collision>
  </link>"""


def make_bbot_urdf() -> str:
    tray_m = 100 * math.pi * TRAY_RADIUS**2 * TRAY_THICK  # density 100
    ti = tray_m * TRAY_RADIUS**2 / 4
    legs = "".join(_leg_urdf_fragment(i, a) for i, a in enumerate(_LEG_ANGLES))
    return f"""
<robot name="bbot">
  <link name="tray">
    <inertial><mass value="{tray_m:.4f}"/>
      <inertia ixx="{ti:.5f}" iyy="{ti:.5f}" izz="{2*ti:.5f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><cylinder radius="{TRAY_RADIUS}" length="{TRAY_THICK}"/></geometry></collision>
  </link>{legs}
</robot>"""


BALL_URDF = f"""
<robot name="bball">
  <link name="ball"><inertial><mass value="1.0"/>
    <inertia ixx="0.004" iyy="0.004" izz="0.004" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><sphere radius="{BALL_R}"/></geometry></collision>
  </link>
</robot>"""


@dataclasses.dataclass(frozen=True)
class BBotTaskState:
    dof_targets: torch.Tensor   # (B, nj) position targets of every bbot dof


class BallBalance(Task):
    num_obs = 24
    num_actions = 3
    uses_net_torque = True      # the leg force sensors read net_torque
    max_episode_length = 500
    action_speed_scale = 20.0   # BallBalance.yaml actionSpeedScale

    def __init__(self, num_envs: int = 4096, seed: int = 42, device=None, **_):
        super().__init__(num_envs, seed, device)
        dev = self.device
        scene = compose([
            (load_urdf(make_bbot_urdf()), (0, 0, TRAY_H, 1, 0, 0, 0), "bbot/"),
            (load_urdf(BALL_URDF), (0.2, 0, 1.0, 1, 0, 0, 0), "ball/"),
        ], name="ball_balance")
        d = scene._defaults
        self.knees = [scene.dof_id(f"bbot/lower_leg_joint{i}") for i in range(3)]
        mode = np.zeros(scene.nj, np.int32)
        kp = np.zeros(scene.nj, np.float32)
        kd = np.zeros(scene.nj, np.float32)
        for k in self.knees:
            mode[k], kp[k], kd[k] = DRIVE_POS, 4000.0, 100.0
        d["drive_mode"] = mode
        d["drive_stiffness"] = kp
        d["drive_damping"] = kd
        # bounded knee actuators: soft attractor pins let 100 Nm legs catapult the tray
        d["drive_effort_limit"] = np.full(scene.nj, 30.0, np.float32)
        # passive damping on every leg joint: the tray-leg-attractor spring chain
        # needs dissipation at explicit substeps
        d["dof_damping"] = np.full(scene.nj, 2.0, np.float32)
        self.model = scene
        # 6-DOF force sensors on the three lower legs only
        self.legs = [scene.body_id(f"bbot/lower_leg{i}") for i in range(3)]
        self.net_torque_bodies = tuple(self.legs)
        self.sim_params = SimParams(
            dt=1.0 / 60.0, substeps=8, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=2.0e4, contact_damping=300.0,
            friction_vel=0.05, plane_friction=1.0,
            root_linear_damping=0.3, root_angular_damping=0.3)
        self.dt = self.sim_params.dt
        # feet pinned to the ground: the tip of each lower leg (local z = LEG_LEN)
        self.attractors = [
            (leg, (0.0, 0.0, LEG_LEN), (LEG_OUTER * math.cos(a), LEG_OUTER * math.sin(a), LEG_R),
             2.0e4, 100.0)
            for leg, a in zip(self.legs, _LEG_ANGLES)]
        self.tray_body = scene.body_id("bbot/tray")
        self.ball_body = scene.body_id("ball/ball")
        # device tensors built once (a constant made inside step_fn would be a host copy)
        self.dof_lower = torch.as_tensor(np.array(d["dof_lower"]), device=dev)
        self.dof_upper = torch.as_tensor(np.array(d["dof_upper"]), device=dev)
        self._knee_idx = torch.tensor(self.knees, device=dev)
        self._leg_idx = torch.tensor(self.legs, device=dev)
        self._bbot_root = torch.tensor([0.0, 0.0, TRAY_H, 1.0, 0.0, 0.0, 0.0], device=dev)
        self._ball_quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)

    def default_task_state(self):
        return BBotTaskState(torch.zeros(self.num_envs, self.model.nj, device=self.device))

    def reset_fn(self, rng, params, task):
        """The bot at rest; the ball at a random radial position and height,
        moving toward the tray centre and falling at 5 m/s."""
        B, nj = task.dof_targets.shape
        u = rng.uniform(4)
        ang = -math.pi + 2 * math.pi * u[:, 0]
        rad = 0.01 + (0.5 * TRAY_RADIUS - 0.01) * u[:, 1]
        height = 1.0 + u[:, 2]
        hspeed = 1.0 + u[:, 3]
        c, s = torch.cos(ang), torch.sin(ang)
        ball_pos = torch.stack([rad * c, rad * s, height], -1)
        k = hspeed * rad / TRAY_RADIUS
        ball_vel = torch.stack([-c * k, -s * k, torch.full_like(k, -5.0)], -1)
        z = torch.zeros(B, nj, device=u.device)
        q = torch.cat([self._bbot_root.expand(B, 7), ball_pos,
                       self._ball_quat.expand(B, 4), z], -1)
        # ball root velocity: identity orientation, so body frame == world
        qd = torch.cat([torch.zeros(B, 9, device=u.device), ball_vel, z], -1)
        return q, qd, params, BBotTaskState(z)

    def pre_physics(self, state, actions):
        B, nj = actions.shape[0], self.model.nj
        targets = state.task.dof_targets.clone()
        targets[:, self._knee_idx] += self.dt * self.action_speed_scale * actions
        targets = torch.minimum(torch.maximum(targets, self.dof_lower), self.dof_upper)
        z = torch.zeros(B, nj, device=actions.device)
        wrench = torch.zeros(B, self.model.nb, 6, device=actions.device)
        return Controls(targets, z, z), wrench, BBotTaskState(targets)

    def post_physics(self, state, prev_task):
        jq = state.q[:, 14:]
        jqd = state.qd[:, 12:]
        ball_pos = state.q[:, 7:10]
        ball_vel = state.qd[:, 9:12]        # root linear velocity: world frame
        # leg force sensors: the contact wrench of each lower leg in its frame
        frames = forward_kinematics(self.model, state.q, state.qd)
        lq = frames.quat[:, self._leg_idx]
        leg_f = Q.rotate_inv(lq, state.net_contact[:, self._leg_idx])
        leg_t = Q.rotate_inv(lq, state.net_torque[:, self._leg_idx])
        sensors = torch.cat([leg_f[:, 0], leg_t[:, 0], leg_t[:, 1], leg_t[:, 2]], -1)
        obs = torch.cat([jq[:, self._knee_idx], jqd[:, self._knee_idx], ball_pos, ball_vel,
                         sensors / 20.0], -1)
        dist = torch.sqrt(ball_pos[:, 0] ** 2 + ball_pos[:, 1] ** 2 + (ball_pos[:, 2] - 0.7) ** 2)
        speed = torch.linalg.norm(ball_vel, dim=-1)
        reward = 1.0 / (1.0 + dist) * 1.0 / (1.0 + speed)
        done = ball_pos[:, 2] < BALL_R * 1.5
        metrics = dict(state.metrics)
        metrics["ball_height"] = ball_pos[:, 2]
        metrics["ball_dist"] = dist
        return obs, reward, done.to(torch.float32), prev_task, metrics
