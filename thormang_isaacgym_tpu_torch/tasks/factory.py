"""Factory contact-rich manipulation: nut-bolt Pick / Place / Screw,
Insertion and Gears. Port of ``thormang_isaacgym_tpu/tasks/factory.py`` (the
reference's ``tasks/factory/``):

- ``FactoryBase``: the Franka and the table, the controller spec
  (``ops.control.parse_controller_spec``), the action -> target mapping of
  the reference's ``_apply_actions_as_ctrl_targets``
  (factory_task_nut_bolt_pick.py:221-266); the table is the kernel's flat
  ground at ``TABLE_Z`` = 0.4
- the nut-bolt scene: the reference's SDF mesh pairs become primitive
  manifolds, the nut a 4-wall square annulus of boxes, the bolt a square
  shaft and head, so pad-nut grasping and nut-on-shaft insertion go through
  the box-box narrowphase (the kernel's box instance)
- Pick: obs 20, keypoint reward toward the nut's grasp frame, success =
  the nut lifted; Place: obs 27, keypoint reward toward the bolt's tip;
  Screw: obs 32 (+ finger forces), the nut rides a revolute(z) +
  prismatic(z) chain on the bolt with a fixed tendon holding
  travel + pitch / (2 pi) spin at 0 (the thread), run by the kernel's tendon
  block; Insertion and Gears (the reference's placeholders completed with
  the family's keypoint reward, as in the JAX package): obs 32

Simplifications, as in the JAX package: the bolt's base pose is static per
scene (the reference randomizes it per env; the nut's spawn noise is kept),
and the scripted close-and-lift evaluation at episode end runs in tests,
not in the step.

The controller: ``ctrl_cfg`` given to the constructor, else the class
default ``_CTRL_YAML`` (joint_space_id with dls IK). ``tasks.make`` does not
pass a YAML's ``ctrl`` block to it, as the JAX package's ``make`` does not,
so the class default applies to every Factory task made from its YAML
(FactoryTaskNutBoltPick.yaml's block equals it). Random draws are the port's
per-env murmur3 streams (``EnvRandom``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom, Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.franka import franka_dof_ids, load_franka
from thormang_isaacgym_tpu_torch.models.robot import DRIVE_EFFORT
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.ops import control as C
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams
from thormang_isaacgym_tpu_torch.tasks.franka_cube_stack import arm_dynamics, grasp_frame

TABLE_Z = 0.4                  # FactoryBase.yaml table_height
# the Franka on the floor at x = franka_depth, turned 180 degrees about z to
# face the work area (factory_env_nut_bolt.py:145-149); the tabletop is a
# constant-height ground, which the arm's links (all but the fingers) do
# not collide with (Geom.ground = False)
FRANKA_POS = (0.5, 0.0, 0.0)
FRANKA_QUAT = (0.0, 0.0, 0.0, 1.0)

# nut-bolt dims (public M16: 24 mm across flats, 13 mm height, 16 mm bore,
# 2 mm pitch)
NUT_OUTER = 0.012              # half-width across flats
NUT_HOLE = 0.0085              # half-width of the square bore
NUT_H = 0.0065                 # half-height
BOLT_SHAFT = 0.008             # half-width of the square shaft
BOLT_LEN = 0.050               # shaft length
BOLT_HEAD_H = 0.005            # head half-height
THREAD_PITCH = 0.002           # m per revolution

_CTRL_YAML = {
    "ctrl_type": "joint_space_id",
    "all": {"jacobian_type": "geometric",
            "gripper_prop_gains": [50, 50], "gripper_deriv_gains": [2, 2]},
    "joint_space_id": {"ik_method": "dls",
                       "joint_prop_gains": [40] * 7,
                       "joint_deriv_gains": [8] * 7},
    "task_space_impedance": {"motion_ctrl_axes": [1] * 6,
                             "task_prop_gains": [40] * 6,
                             "task_deriv_gains": [8] * 6},
}

FRANKA_FACTORY_DOF = np.array(
    [0.3413, -0.8011, -0.0670, -1.8299, 0.0266, 1.0185, 1.0927, 0.04, 0.04],
    np.float32)   # FactoryTaskNutBoltPick.yaml:26 + open gripper


def _walls(name, hole, outer, half_h):
    """The 4 box walls of a square annulus around a square bore."""
    t = outer - hole
    walls = []
    for (cx, cy, hx, hy) in ((0.0, hole + t / 2, outer, t / 2),
                             (0.0, -(hole + t / 2), outer, t / 2),
                             (hole + t / 2, 0.0, t / 2, hole),
                             (-(hole + t / 2), 0.0, t / 2, hole)):
        walls.append(f'<collision name="{name}_wall{len(walls)}">'
                     f'<origin xyz="{cx} {cy} 0"/>'
                     f'<geometry><box size="{2 * hx} {2 * hy} {2 * half_h}"/></geometry>'
                     f'</collision>')
    return "".join(walls)


def _nut_urdf():
    """The nut: a 4-wall square annulus (graspable, insertable over the shaft)."""
    m, i = 0.03, 0.03 * (0.02 ** 2) / 6
    return f"""
<robot name="nut">
  <link name="nut">
    <inertial><mass value="{m}"/>
      <inertia ixx="{i:.2e}" iyy="{i:.2e}" izz="{i:.2e}" ixy="0" ixz="0" iyz="0"/></inertial>
    {_walls("nut", NUT_HOLE, NUT_OUTER, NUT_H)}
  </link>
</robot>"""


def _bolt_urdf():
    """The fixed bolt: head box + square shaft."""
    return f"""
<robot name="bolt">
  <link name="bolt">
    <inertial><mass value="0.1"/>
      <inertia ixx="1e-5" iyy="1e-5" izz="1e-5" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision name="bolt_head"><origin xyz="0 0 {BOLT_HEAD_H}"/>
      <geometry><box size="{4*BOLT_SHAFT} {4*BOLT_SHAFT} {2*BOLT_HEAD_H}"/></geometry></collision>
    <collision name="bolt_shaft"><origin xyz="0 0 {2*BOLT_HEAD_H + BOLT_LEN/2}"/>
      <geometry><box size="{2*BOLT_SHAFT} {2*BOLT_SHAFT} {BOLT_LEN}"/></geometry></collision>
  </link>
</robot>"""


def _bolt_nut_urdf():
    """The Screw task's articulation: the nut rides the bolt through
    revolute(z) + prismatic(z); the thread tendon holds
    z = -pitch / (2 pi) theta."""
    top = 2 * BOLT_HEAD_H + BOLT_LEN
    return f"""
<robot name="bolt_nut">
  <link name="bolt">
    <inertial><mass value="0.1"/>
      <inertia ixx="1e-5" iyy="1e-5" izz="1e-5" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision name="bolt_head"><origin xyz="0 0 {BOLT_HEAD_H}"/>
      <geometry><box size="{4*BOLT_SHAFT} {4*BOLT_SHAFT} {2*BOLT_HEAD_H}"/></geometry></collision>
  </link>
  <joint name="nut_spin" type="continuous">
    <parent link="bolt"/><child link="nut_carrier"/>
    <origin xyz="0 0 {top}"/><axis xyz="0 0 1"/>
    <dynamics damping="0.01" friction="0.06"/>
  </joint>
  <link name="nut_carrier">
    <inertial><mass value="0.005"/>
      <inertia ixx="1e-7" iyy="1e-7" izz="1e-7" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <joint name="nut_travel" type="prismatic">
    <parent link="nut_carrier"/><child link="nut"/>
    <origin xyz="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="{-BOLT_LEN}" upper="0.0" effort="1000" velocity="1.0"/>
    <dynamics damping="0.01"/>
  </joint>
  <link name="nut">
    <inertial><mass value="0.03"/>
      <inertia ixx="2e-6" iyy="2e-6" izz="2e-6" ixy="0" ixz="0" iyz="0"/></inertial>
    {_walls("nut", NUT_HOLE, NUT_OUTER, NUT_H)}
  </link>
</robot>"""


def _annulus_urdf(name, hole, outer, half_h, mass):
    """A square annulus link (socket, gear): 4 box walls around a square bore."""
    i = max(mass * outer * outer / 3, 1e-7)
    return (f'<robot name="{name}"><link name="{name}">'
            f'<inertial><mass value="{mass}"/>'
            f'<inertia ixx="{i:.2e}" iyy="{i:.2e}" izz="{i:.2e}" '
            f'ixy="0" ixz="0" iyz="0"/></inertial>{_walls(name, hole, outer, half_h)}'
            f'</link></robot>')


# insertion dims (public round_peg_hole_16mm re-derived as square sections)
PLUG_HALF = 0.008               # plug half-width
PLUG_LEN = 0.050                # plug length
SOCKET_HOLE = 0.0095            # socket bore half-width (1.5 mm clearance)
SOCKET_OUTER = 0.018
SOCKET_H = 0.0125               # socket half-height

# gears dims (public NIST gears plate)
GEAR_HOLE = 0.0065
GEAR_OUTER = 0.025
GEAR_H = 0.009
SHAFT_HALF = 0.005
SHAFT_LEN = 0.035


def _plug_urdf():
    i = 0.04 * PLUG_HALF * PLUG_HALF
    return (f'<robot name="plug"><link name="plug">'
            f'<inertial><origin xyz="0 0 {PLUG_LEN / 2}"/>'
            f'<mass value="0.04"/>'
            f'<inertia ixx="{i:.2e}" iyy="{i:.2e}" izz="{i:.2e}" '
            f'ixy="0" ixz="0" iyz="0"/></inertial>'
            f'<collision name="plug_shaft"><origin xyz="0 0 {PLUG_LEN / 2}"/>'
            f'<geometry><box size="{2 * PLUG_HALF} {2 * PLUG_HALF} '
            f'{PLUG_LEN}"/></geometry></collision>'
            # a grip collar so the fingers have a flat face to pinch
            f'<collision name="plug_collar"><origin xyz="0 0 {PLUG_LEN - 0.008}"/>'
            f'<geometry><box size="{2 * PLUG_HALF + 0.008} '
            f'{2 * PLUG_HALF + 0.008} 0.016"/></geometry></collision>'
            f'</link></robot>')


def _gear_base_urdf():
    """The fixed gear-base plate with the central shaft (the medium gear's)."""
    return (f'<robot name="gear_base"><link name="gear_base">'
            f'<inertial><mass value="0.5"/>'
            f'<inertia ixx="1e-4" iyy="1e-4" izz="1e-4" '
            f'ixy="0" ixz="0" iyz="0"/></inertial>'
            f'<collision name="plate"><origin xyz="0 0 0.005"/>'
            f'<geometry><box size="0.12 0.06 0.01"/></geometry></collision>'
            f'<collision name="shaft_mid"><origin xyz="0 0 '
            f'{0.01 + SHAFT_LEN / 2}"/>'
            f'<geometry><box size="{2 * SHAFT_HALF} {2 * SHAFT_HALF} '
            f'{SHAFT_LEN}"/></geometry></collision>'
            f'</link></robot>')


@dataclasses.dataclass(frozen=True)
class FactoryTaskState:
    actions: torch.Tensor


class FactoryBase(Task):
    """The Franka and table of the Factory family."""
    max_episode_length = 100
    clip_obs = 5.0
    num_actions = 12
    pos_action_scale = 0.1
    rot_action_scale = 0.1
    force_action_scale = 1.0
    torque_action_scale = 1.0
    clamp_rot_thresh = 1.0e-6
    keypoint_reward_scale = 1.0
    action_penalty_scale = 0.0
    num_keypoints = 4
    keypoint_scale = 0.5
    success_bonus = 0.0
    _gripper_target = 0.04     # open (franka_gripper_width_max / 2)

    def __init__(self, num_envs: int = 128, seed: int = 42, device=None,
                 ctrl_cfg: dict | None = None, **_):
        super().__init__(num_envs, seed, device)
        self.cfg_ctrl = C.parse_controller_spec(ctrl_cfg or _CTRL_YAML)
        self.sim_params = SimParams(
            dt=1.0 / 60.0, substeps=4, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=1.0e5, contact_damping=1.0e3,
            friction_vel=0.004, plane_friction=0.3,   # table_friction 0.3
            max_depenetration_velocity=0.5)
        self.dt = self.sim_params.dt

    def _franka_scene(self, others, name):
        """Compose the Franka with `others` ((model, pose, prefix) tuples),
        then finish the scene (``_finish_scene``)."""
        self._finish_scene(compose([(load_franka(), FRANKA_POS + FRANKA_QUAT, "franka/"),
                                    *others], name=name))

    def _finish_scene(self, scene):
        # the Franka's links opt out of the tabletop ground (the real table is
        # a box the floor-mounted arm reaches over); only the fingers may
        # press the tabletop
        fingers = {scene.body_id("franka/panda_leftfinger"),
                   scene.body_id("franka/panda_rightfinger")}
        geoms = tuple(
            dataclasses.replace(g, ground=False)
            if scene.body_names[g.body].startswith("franka/") and g.body not in fingers else g
            for g in scene.geoms)
        scene = dataclasses.replace(scene, geoms=geoms)
        dev = self.device
        self.model = scene
        self.fr_ids = np.array(franka_dof_ids(scene, "franka/"))
        self._fr = torch.as_tensor(self.fr_ids, device=dev)
        self._arm_cols = torch.as_tensor(6 * scene.n_floating + self.fr_ids[:7], device=dev)
        d = scene._defaults
        mode = np.array(d["drive_mode"])
        mode[self.fr_ids] = DRIVE_EFFORT           # manual mode: all 9 effort-driven
        d["drive_mode"] = mode
        self.effort_limit = torch.as_tensor(np.array(d["drive_effort_limit"])[self.fr_ids],
                                            device=dev)
        gb, gp, gq = scene.sites["franka/panda_grasp"]
        self.grasp_body = gb
        self.grasp_pos_l = torch.tensor(np.asarray(gp, np.float32), device=dev)
        self.grasp_quat_l = torch.tensor(np.asarray(gq, np.float32), device=dev)
        self.lfinger_body = scene.body_id("franka/panda_leftfinger")
        self.rfinger_body = scene.body_id("franka/panda_rightfinger")
        # keypoint offsets along the local z: linspace(0, 1) - 0.5, scaled
        # (factory_task_nut_bolt_pick.py:334-340)
        ko = np.zeros((self.num_keypoints, 3), np.float32)
        ko[:, 2] = (np.linspace(0.0, 1.0, self.num_keypoints) - 0.5) * self.keypoint_scale
        self.keypoint_offsets = torch.as_tensor(ko, device=dev)
        self._identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self._ez = torch.tensor([0.0, 0.0, 1.0], device=dev)
        self._franka_dof = torch.as_tensor(FRANKA_FACTORY_DOF, device=dev)
        self._arm_only = torch.tensor([1.0] * 7 + [0.0, 0.0], device=dev)

    def ground_height_fn(self):
        """The tabletop: a constant height, so the kernel's flat ground takes it."""
        return TABLE_Z

    def _eef(self, q, qd):
        """(pos, quat, linear velocity, angular velocity) of the fingertip
        midpoint frame."""
        gp, gq, vel = grasp_frame(self, q, qd)
        return gp, gq, vel[:, :3], vel[:, 3:]

    def default_task_state(self) -> FactoryTaskState:
        return FactoryTaskState(torch.zeros(self.num_envs, self.num_actions, device=self.device))

    def _arm_reset(self, rng: EnvRandom, noise: float, finger: float):
        """(B, nj) joint positions: the Factory pose with U(-noise, noise) on
        the 7 arm joints, the fingers at `finger`."""
        pos = self._franka_dof + noise * (rng.uniform(9) * 2 - 1) * self._arm_only
        pos[:, 7:] = finger
        jq = pos.new_zeros(pos.shape[0], self.model.nj)
        jq[:, self._fr] = pos
        return jq

    def _yaw_quat(self, yaw: torch.Tensor) -> torch.Tensor:
        return Q.from_axis_angle(self._ez, yaw)

    def _reset_out(self, q):
        B = q.shape[0]
        return q, torch.zeros(B, self.model.nv, device=q.device), \
            FactoryTaskState(torch.zeros(B, self.num_actions, device=q.device))

    # ---- actions -> controller targets -> torques ----
    def _torques(self, q, qd, actions, params, finger_force):
        """(B, 12) actions -> (B, 9) Franka DOF torques through the
        configured controller (joint_space_id by default)."""
        nf = self.model.n_floating
        jq, jqd = q[:, 7 * nf:], qd[:, 6 * nf:]
        gp, gq, v, w = self._eef(q, qd)
        pos_a = actions[:, 0:3] * self.pos_action_scale
        rot_a = actions[:, 3:6] * self.rot_action_scale
        angle = torch.linalg.norm(rot_a, dim=-1) + 1e-12
        dq = Q.from_axis_angle(rot_a / angle[:, None], angle)
        dq = torch.where((angle > self.clamp_rot_thresh)[:, None], dq, self._identity.expand_as(dq))
        target_pos = gp + pos_a
        target_quat = Q.mul(dq, gq)
        target_wrench = torch.cat([actions[:, 6:9] * self.force_action_scale,
                                   actions[:, 9:12] * self.torque_action_scale], -1) \
            if self.cfg_ctrl["do_force_ctrl"] else actions.new_zeros(actions.shape[0], 6)
        mm, j_eef = arm_dynamics(self, params, q)
        tau = C.compute_dof_torque(
            self.cfg_ctrl, jq[:, self._fr], jqd[:, self._fr], gp, gq, v, w, finger_force,
            j_eef, mm, self._gripper_target, target_pos, target_quat, target_wrench)
        return torch.minimum(torch.maximum(tau, -self.effort_limit), self.effort_limit)

    def pre_physics(self, state, actions):
        B, nj = actions.shape[0], self.model.nj
        # the measured fingertip wrench of the closed-loop force modes: the
        # net contact force on the fingers (the reference's force sensors)
        ff = state.net_contact[:, self.lfinger_body] + state.net_contact[:, self.rfinger_body]
        tau = self._torques(state.q, state.qd, actions, state.params, ff)
        effort = actions.new_zeros(B, nj)
        effort[:, self._fr] = tau
        z = torch.zeros_like(effort)
        return Controls(z, z, effort), actions.new_zeros(B, self.model.nb, 6), \
            FactoryTaskState(actions)

    def _keypoints(self, pos, quat):
        """(B, K, 3) world keypoints of a frame: pos + R offsets."""
        K = self.keypoint_offsets.shape[0]
        return pos[:, None] + Q.rotate(quat[:, None].expand(-1, K, 4),
                                       self.keypoint_offsets.expand(pos.shape[0], K, 3))

    def _keypoint_dist(self, pos_a, quat_a, pos_b, quat_b):
        return torch.linalg.norm(self._keypoints(pos_a, quat_a)
                                 - self._keypoints(pos_b, quat_b), dim=-1).sum(-1)

    def _reward(self, state, kd):
        a_pen = torch.linalg.norm(state.task.actions, dim=-1)
        return -kd * self.keypoint_reward_scale - a_pen * self.action_penalty_scale


class FactoryTaskNutBoltPick(FactoryBase):
    """Pick: reach the nut's grasp frame (keypoint reward); a scripted close
    and lift must then carry it (in tests). Obs 20
    (factory_task_nut_bolt_pick.py:157-168)."""
    num_obs = 20

    def __init__(self, num_envs: int = 128, seed: int = 42, device=None, **kw):
        super().__init__(num_envs, seed, device, **kw)
        self._franka_scene([
            (load_urdf(_nut_urdf()), (0.0, -0.1, TABLE_Z + NUT_H, 1.0, 0.0, 0.0, 0.0), "nut/"),
            (load_urdf(_bolt_urdf(), fix_base_link=True),
             (0.15, 0.1, TABLE_Z, 1.0, 0.0, 0.0, 0.0), "bolt/"),
        ], "factory_nut_bolt_pick")
        self.nut_body = self.model.body_id("nut/nut")
        self.qN = 0            # the nut's root q block
        dev = self.device
        self._nut_top = torch.tensor([0.0, 0.0, NUT_H], device=dev)
        # the grasp frame's z flipped to face the downward gripper
        # (nut_grasp_quat_local = 180 degrees about x, :89-90)
        self._x180 = torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev)
        self._nut_xy = torch.tensor([0.0, -0.1], device=dev)

    def reset_fn(self, rng: EnvRandom, params, task):
        jq = self._arm_reset(rng, 0.1, 0.04)
        nxy = self._nut_xy + 0.1 * (rng.uniform(2) * 2 - 1)
        yaw = rng.uniform(1, -math.pi, math.pi)[:, 0]
        qn = torch.cat([nxy, jq.new_full((jq.shape[0], 1), TABLE_Z + NUT_H), self._yaw_quat(yaw)], -1)
        q, qd, t = self._reset_out(torch.cat([qn, jq], -1))
        return q, qd, params, t

    def post_physics(self, state, prev_task):
        gp, gq, v, w = self._eef(state.q, state.qd)
        nut_pos = state.q[:, self.qN:self.qN + 3]
        nut_quat = state.q[:, self.qN + 3:self.qN + 7]
        grasp_pos = nut_pos + Q.rotate(nut_quat, self._nut_top.expand_as(nut_pos))
        grasp_quat = Q.mul(nut_quat, self._x180.expand_as(nut_quat))
        obs = torch.cat([gp, gq, v, w, grasp_pos, grasp_quat], -1)
        kd = self._keypoint_dist(gp, gq, grasp_pos, grasp_quat)
        reward = self._reward(state, kd)
        metrics = dict(state.metrics)
        metrics["keypoint_dist"] = kd
        metrics["success"] = ((nut_pos[:, 2] - TABLE_Z) > 3.0 * 2 * NUT_H).to(kd.dtype)
        return obs, reward, torch.zeros_like(reward), prev_task, metrics


class FactoryTaskNutBoltPlace(FactoryBase):
    """Place: the nut starts in the closed gripper above the bolt; move it
    onto the bolt's top (keypoint reward toward the bolt-tip frame). Obs 27."""
    num_obs = 27
    _gripper_target = 0.011    # hold the nut (half-width 12 mm)

    def __init__(self, num_envs: int = 128, seed: int = 42, device=None, **kw):
        super().__init__(num_envs, seed, device, **kw)
        self.bolt_pos = np.array([0.1, 0.0, TABLE_Z], np.float32)
        self._franka_scene([
            (load_urdf(_nut_urdf()), (0.0, 0.0, TABLE_Z + 0.3, 1.0, 0.0, 0.0, 0.0), "nut/"),
            (load_urdf(_bolt_urdf(), fix_base_link=True),
             tuple(self.bolt_pos) + (1.0, 0.0, 0.0, 0.0), "bolt/"),
        ], "factory_nut_bolt_place")
        self.nut_body = self.model.body_id("nut/nut")
        self.qN = 0
        dev = self.device
        self._bolt_pos = torch.as_tensor(self.bolt_pos, device=dev)
        self._drop = torch.tensor([0.0, 0.0, -0.005], device=dev)   # the nut under the grasp point
        # the target: the nut seated over the shaft's tip
        self._tip = self._bolt_pos + torch.tensor([0.0, 0.0, 2 * BOLT_HEAD_H + BOLT_LEN + NUT_H],
                                                  device=dev)

    def reset_fn(self, rng: EnvRandom, params, task):
        jq = self._arm_reset(rng, 0.05, 0.013)      # the fingers on the nut
        B = jq.shape[0]
        # the nut at the gripper: FK finds the grasp point
        root = jq.new_zeros(B, 7)
        root[:, 3] = 1.0
        gp, gq, _, _ = self._eef(torch.cat([root, jq], -1), jq.new_zeros(B, self.model.nv))
        yaw_g = torch.atan2(2 * (gq[:, 0] * gq[:, 3] + gq[:, 1] * gq[:, 2]),
                            1 - 2 * (gq[:, 2] ** 2 + gq[:, 3] ** 2))
        qn = torch.cat([gp + self._drop, self._yaw_quat(yaw_g)], -1)
        q, qd, t = self._reset_out(torch.cat([qn, jq], -1))
        return q, qd, params, t

    def post_physics(self, state, prev_task):
        gp, gq, v, w = self._eef(state.q, state.qd)
        nut_pos = state.q[:, self.qN:self.qN + 3]
        nut_quat = state.q[:, self.qN + 3:self.qN + 7]
        bolt_pos = self._bolt_pos.expand_as(nut_pos)
        bolt_quat = self._identity.expand_as(nut_quat)
        obs = torch.cat([gp, gq, v, w, nut_pos, nut_quat, bolt_pos, bolt_quat], -1)
        kd = self._keypoint_dist(nut_pos, nut_quat, self._tip.expand_as(nut_pos), bolt_quat)
        reward = self._reward(state, kd)
        metrics = dict(state.metrics)
        metrics["keypoint_dist"] = kd
        metrics["success"] = (torch.linalg.norm(nut_pos - self._tip, dim=-1) < 0.01).to(kd.dtype)
        return obs, reward, torch.zeros_like(reward), prev_task, metrics


class FactoryTaskNutBoltScrew(FactoryBase):
    """Screw: the nut starts threaded at the bolt's top; screwing it down is
    rotation about the shaft, the thread tendon turning spin into travel.
    Obs 32 (+ finger forces, factory_task_nut_bolt_screw.py)."""
    num_obs = 32
    max_episode_length = 200
    _gripper_target = 0.011

    def __init__(self, num_envs: int = 128, seed: int = 42, device=None, **kw):
        super().__init__(num_envs, seed, device, **kw)
        self.bolt_pos = np.array([0.1, 0.0, TABLE_Z], np.float32)
        scene = compose([
            (load_franka(), FRANKA_POS + FRANKA_QUAT, "franka/"),
            (load_urdf(_bolt_nut_urdf(), fix_base_link=True),
             tuple(self.bolt_pos) + (1.0, 0.0, 0.0, 0.0), "bn/"),
        ], name="factory_nut_bolt_screw")
        # the thread: L = travel + pitch / (2 pi) spin pinned to 0
        spin = scene.dof_id("bn/nut_spin")
        travel = scene.dof_id("bn/nut_travel")
        coef = np.zeros(scene.nj, np.float32)
        coef[travel] = 1.0
        coef[spin] = THREAD_PITCH / (2 * np.pi)
        scene = dataclasses.replace(
            scene, tendons=scene.tendons + ((tuple(coef), 0.0, 0.0, "bn/thread"),))
        d = scene._defaults
        d["tendon_stiffness"] = np.concatenate([d["tendon_stiffness"], [2.0e4]]).astype(np.float32)
        d["tendon_damping"] = np.concatenate([d["tendon_damping"], [50.0]]).astype(np.float32)
        self._finish_scene(scene)
        self.nut_body = scene.body_id("bn/nut")
        self.spin_dof = spin
        self.travel_dof = travel

    def reset_fn(self, rng: EnvRandom, params, task):
        jq = self._arm_reset(rng, 0.05, 0.013)
        jq[:, self.travel_dof] = 0.0                # the nut at the top of the thread
        jq[:, self.spin_dof] = 0.0
        q, qd, t = self._reset_out(jq)
        return q, qd, params, t

    def post_physics(self, state, prev_task):
        gp, gq, v, w = self._eef(state.q, state.qd)
        frames = forward_kinematics(self.model, state.q, state.qd)
        nb = self.nut_body
        ff = state.net_contact[:, self.lfinger_body] + state.net_contact[:, self.rfinger_body]
        obs = torch.cat([gp, gq, v, w, frames.pos[:, nb], frames.quat[:, nb], frames.vel[:, nb],
                         frames.omega[:, nb], ff, torch.zeros_like(ff)], -1)
        travel = state.q[:, 7 * self.model.n_floating + self.travel_dof]
        # reward: screw the nut down the full thread
        reward = -(travel + BOLT_LEN) / BOLT_LEN
        metrics = dict(state.metrics)
        metrics["travel"] = travel
        metrics["success"] = (travel < -0.9 * BOLT_LEN).to(travel.dtype)
        return obs, reward, torch.zeros_like(reward), prev_task, metrics


class _SeatTask(FactoryBase):
    """Insertion and Gears: a free part on the table to seat at a fixed
    pose (the reference's placeholder tasks, completed with the family's
    keypoint reward toward the seated pose). Obs 32."""
    num_obs = 32
    max_episode_length = 1024
    spawn_z = TABLE_Z

    def _part_reset(self, rng: EnvRandom, spawn_xy: torch.Tensor, noise_xy: float, yaw: bool):
        jq = self._arm_reset(rng, 0.05, 0.04)
        B = jq.shape[0]
        nxy = spawn_xy + noise_xy * (rng.uniform(2) * 2 - 1)
        quat = self._yaw_quat(rng.uniform(1, -math.pi, math.pi)[:, 0]) if yaw \
            else self._identity.expand(B, 4)
        qp = torch.cat([nxy, jq.new_full((B, 1), self.spawn_z), quat], -1)
        return self._reset_out(torch.cat([qp, jq], -1))

    def _seat_obs(self, state, seat):
        """(obs, part position, part quaternion): 13 + 13 + 3 + 3."""
        gp, gq, v, w = self._eef(state.q, state.qd)
        pos, quat = state.q[:, 0:3], state.q[:, 3:7]
        vel, omega = state.qd[:, 3:6], Q.rotate(quat, state.qd[:, 0:3])
        obs = torch.cat([gp, gq, v, w, pos, quat, vel, omega, seat.expand_as(pos) - pos,
                         pos - gp], -1)
        return obs, pos, quat


class FactoryTaskInsertion(_SeatTask):
    """Insertion: insert a free plug into a fixed socket on the table (the
    reference's ``factory_task_insertion.py`` is a placeholder whose reward
    and reset are ``pass``; its env half and config, obs 32, act 12,
    episode 1024, plug_bias_y -0.1, plug_noise_xy 0.05, are reproduced)."""
    plug_bias_y = -0.1
    plug_noise_xy = 0.05

    def __init__(self, num_envs: int = 128, seed: int = 42, device=None, **kw):
        super().__init__(num_envs, seed, device, **kw)
        self.socket_pos = np.array([0.1, 0.0, TABLE_Z + SOCKET_H], np.float32)
        self._franka_scene([
            (load_urdf(_plug_urdf()), (0.0, self.plug_bias_y, TABLE_Z, 1.0, 0.0, 0.0, 0.0), "plug/"),
            (load_urdf(_annulus_urdf("socket", SOCKET_HOLE, SOCKET_OUTER, SOCKET_H, 0.2),
                       fix_base_link=True), tuple(self.socket_pos) + (1.0, 0.0, 0.0, 0.0),
             "socket/"),
        ], "factory_insertion")
        self.plug_body = self.model.body_id("plug/plug")
        self.qP = 0
        # seated: the plug's base at the socket bore's centre on the table
        self._seat = torch.tensor([self.socket_pos[0], self.socket_pos[1], TABLE_Z],
                                  device=self.device)
        self._spawn_xy = torch.tensor([0.0, self.plug_bias_y], device=self.device)

    def reset_fn(self, rng: EnvRandom, params, task):
        q, qd, t = self._part_reset(rng, self._spawn_xy, self.plug_noise_xy, yaw=False)
        return q, qd, params, t

    def post_physics(self, state, prev_task):
        obs, pos, quat = self._seat_obs(state, self._seat)
        kd = self._keypoint_dist(pos, quat, self._seat.expand_as(pos), self._identity.expand_as(quat))
        reward = self._reward(state, kd)
        inserted = (torch.linalg.norm((self._seat - pos)[:, :2], dim=-1) < 0.003) \
            & (pos[:, 2] < TABLE_Z + 0.005)
        metrics = dict(state.metrics)
        metrics["keypoint_dist"] = kd
        metrics["success"] = inserted.to(kd.dtype)
        return obs, reward, torch.zeros_like(reward), prev_task, metrics


class FactoryTaskGears(_SeatTask):
    """Gears: place the medium gear onto the base plate's shaft (the
    reference's ``factory_task_gears.py`` is a placeholder; its env half,
    gears_bias_y -0.1, gears_noise_xy 0.05, and config, obs 32, act 12,
    episode 1024, are reproduced, the medium gear the manipulated part)."""
    gears_bias_y = -0.1
    gears_noise_xy = 0.05
    spawn_z = TABLE_Z + GEAR_H

    def __init__(self, num_envs: int = 128, seed: int = 42, device=None, **kw):
        super().__init__(num_envs, seed, device, **kw)
        self.base_pos = np.array([0.1, 0.0, TABLE_Z], np.float32)
        self._franka_scene([
            (load_urdf(_annulus_urdf("gear_medium", GEAR_HOLE, GEAR_OUTER, GEAR_H, 0.05)),
             (0.0, self.gears_bias_y, TABLE_Z + GEAR_H, 1.0, 0.0, 0.0, 0.0), "gear/"),
            (load_urdf(_gear_base_urdf(), fix_base_link=True),
             tuple(self.base_pos) + (1.0, 0.0, 0.0, 0.0), "base/"),
        ], "factory_gears")
        self.gear_body = self.model.body_id("gear/gear_medium")
        self.qG = 0
        # the shaft's top centre (the seated gear's target)
        self.shaft_seat = self.base_pos + np.array([0.0, 0.0, 0.01 + GEAR_H], np.float32)
        self._seat = torch.as_tensor(self.shaft_seat, device=self.device)
        self._spawn_xy = torch.tensor([0.0, self.gears_bias_y], device=self.device)

    def reset_fn(self, rng: EnvRandom, params, task):
        q, qd, t = self._part_reset(rng, self._spawn_xy, self.gears_noise_xy, yaw=True)
        return q, qd, params, t

    def post_physics(self, state, prev_task):
        obs, pos, quat = self._seat_obs(state, self._seat)
        kd = self._keypoint_dist(pos, quat, self._seat.expand_as(pos), self._identity.expand_as(quat))
        reward = self._reward(state, kd)
        seated = (torch.linalg.norm(pos[:, :2] - self._seat[:2], dim=-1) < 0.004) \
            & (torch.abs(pos[:, 2] - self._seat[2]) < 0.006)
        metrics = dict(state.metrics)
        metrics["keypoint_dist"] = kd
        metrics["success"] = seated.to(kd.dtype)
        return obs, reward, torch.zeros_like(reward), prev_task, metrics
