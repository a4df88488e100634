"""Trifinger: cube repositioning and reorientation with the TriFingerPro.
Port of ``thormang_isaacgym_tpu/tasks/trifinger.py`` (the reference's
``tasks/trifinger.py`` and ``cfg/task/Trifinger.yaml``).

The scene is the fixed 3-finger robot (``models/trifinger.py``) and a free
0.065 m, 16 g cube: the kernel's box instance, the fingertip spheres and
link capsules against the cube (sphere-box, capsule-box).

- obs 41 = robot q 9 + robot qd 9 + object pose 7 + goal pose 7 + the last
  actions 9; with ``asymmetric_obs`` the privileged states, 113 = obs +
  object velocity 6 + fingertip states 39 + joint torques 9 + the 6-DOF
  fingertip wrenches 18 (the net contact force and torque of the three tip
  bodies, rotated into the tip frames)
- ``normalize_obs``: each obs entry scaled to [-1, 1] by its spec limits
- ``command_mode`` torque: actions in [-1, 1] -> +/-0.36 N m
  (``normalize_action``), less the safety damping [0.08, 0.08, 0.04] x qd
  per finger (``apply_safety_damping``), clamped; applied through
  ``Controls.effort`` on the effort-driven joints. Position mode: a PD
  (kp 10, kd [0.1, 0.3, 0.001]) to targets scaled to the joint limits.
- reward: the finger-movement penalty (-0.5 |tip velocity|^2), the
  fingertip-to-cube reach rate (-250, gated to global steps x envs in [0,
  5e7]) and the keypoint pose reward (2000 dt x the lgsk kernel of the 8
  cube corners' distances to the goal's); no early termination
- success: position within 0.02 m and, at difficulty 4, orientation within
  0.4 rad
- reset: the robot at its default pose + N(0, 0.4) (clamped to the limits),
  velocities N(0, 0.2); the cube anywhere in the arena with a random yaw;
  the goal by ``task_difficulty`` (4: a random position up to 0.1 m high and
  a random orientation)

Random draws are the port's per-env EnvRandom streams (normals by
Box-Muller), not the JAX package's threefry draws.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom, Task
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.models.trifinger import (
    ARENA_RADIUS, FINGER_ANGLES, JOINT_DEFAULT, JOINT_HIGH, JOINT_LOW,
    MAX_TORQUE, MAX_VELOCITY, load_trifinger, make_cube_urdf, trifinger_dof_ids,
)
from thormang_isaacgym_tpu_torch.models.urdf import load_urdf
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams
from thormang_isaacgym_tpu_torch.tasks.common import normal

CUBE_SIZE = 0.065
# the cube's 8 corners, corner i's k-th coordinate -s/2 where bit k of i is set
_CORNERS = np.array([[(1 if ((i >> k) & 1) == 0 else -1) * CUBE_SIZE / 2 for k in range(3)]
                     for i in range(8)], np.float32)


def lgsk_kernel(x, scale=50.0, eps=2.0):
    """The logistic kernel, bounded to [0, 1 / (2 + eps))."""
    scaled = x * scale
    return 1.0 / (torch.exp(scaled) + eps + torch.exp(-scaled))


def gen_keypoints(pos, quat, corners):
    """The cube's 8 corners in the world frame: pos (B, 3), quat (B, 4),
    corners (8, 3) -> (B, 8, 3)."""
    return pos[:, None, :] + Q.rotate(quat[:, None, :], corners)


def quat_diff_rad(a, b):
    """The angle between two orientations."""
    d = torch.abs(torch.sum(a * b, dim=-1))
    return 2.0 * torch.acos(torch.clamp(d, -1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class TrifingerTaskState:
    actions: torch.Tensor          # (B, 9) raw, in [-1, 1]
    goal_pos: torch.Tensor         # (B, 3)
    goal_quat: torch.Tensor        # (B, 4) wxyz
    last_object: torch.Tensor      # (B, 13) the previous step's cube state
    last_fingertip: torch.Tensor   # (B, 3, 13)
    torques: torch.Tensor          # (B, 9) the applied torques
    successes: torch.Tensor        # (B,) success flag


class Trifinger(Task):
    uses_net_torque = True
    max_episode_length = 750
    clip_obs = 5.0
    task_difficulty = 4
    normalize_obs = True
    normalize_action = True
    apply_safety_damping = True
    command_mode = "torque"
    use_keypoints = True
    finger_move_penalty_weight = -0.5
    finger_reach_object_weight = -250.0
    # the reach term's window in aggregate env steps (global steps x envs)
    ft_sched_start = 0.0
    ft_sched_end = 5e7
    object_dist_weight = 2000.0
    object_rot_weight = 2000.0
    position_tolerance = 0.02
    orientation_tolerance = 0.4
    dof_pos_stddev = 0.4
    dof_vel_stddev = 0.2
    safety_damping = (0.08, 0.08, 0.04)

    def __init__(self, num_envs: int = 16384, seed: int = 42, device=None,
                 asymmetric_obs: bool = True, randomize: bool = False, **_):
        super().__init__(num_envs, seed, device)
        if randomize:
            raise NotImplementedError("domain randomization (randomize: true) is not ported yet")
        dev = self.device
        robot = load_trifinger()
        cube = load_urdf(make_cube_urdf(CUBE_SIZE))
        scene = compose([
            (robot, (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0), "robot/"),
            (cube, (0.0, 0.0, CUBE_SIZE / 2, 1.0, 0.0, 0.0, 0.0), "obj/"),
        ], name="trifinger_scene")
        self.model = scene
        self.asymmetric_obs = asymmetric_obs
        self.num_obs = 41
        self.num_states = 113 if asymmetric_obs else 0
        self.num_actions = 9
        self.dof_ids = np.array(trifinger_dof_ids(scene, "robot/"), np.int64)
        self.tips = [scene.sites[f"robot/finger_tip_link_{int(a)}"] for a in FINGER_ANGLES]
        self.net_torque_bodies = tuple(int(b) for b, _, _ in self.tips)
        self.cube_body = scene.body_id("obj/cube")
        self._dof = torch.as_tensor(self.dof_ids, device=dev)
        self._tip_body = torch.as_tensor(self.net_torque_bodies, device=dev)
        self._tip_pos = torch.tensor(np.array([p for _, p, _ in self.tips]), dtype=torch.float32,
                                     device=dev)
        self._tip_quat = torch.tensor(np.array([q for _, _, q in self.tips]), dtype=torch.float32,
                                      device=dev)
        f32 = np.float32
        self.q_lo = torch.as_tensor(np.tile(JOINT_LOW, 3).astype(f32), device=dev)
        self.q_hi = torch.as_tensor(np.tile(JOINT_HIGH, 3).astype(f32), device=dev)
        self.q_def = torch.as_tensor(np.tile(JOINT_DEFAULT, 3).astype(f32), device=dev)
        self.safety_kd = torch.as_tensor(np.tile(self.safety_damping, 3).astype(f32), device=dev)
        self._corners = torch.as_tensor(_CORNERS, device=dev)
        # the obs spec's limits (normalize_obs)
        pose_lo, pose_hi = [-0.3, -0.3, 0.0, -1, -1, -1, -1], [0.3, 0.3, 0.3, 1, 1, 1, 1]
        self._obs_lo = torch.as_tensor(np.concatenate([
            np.tile(JOINT_LOW, 3), np.full(9, -MAX_VELOCITY), pose_lo, pose_lo,
            np.full(9, -1.0)]).astype(f32), device=dev)
        self._obs_hi = torch.as_tensor(np.concatenate([
            np.tile(JOINT_HIGH, 3), np.full(9, MAX_VELOCITY), pose_hi, pose_hi,
            np.full(9, 1.0)]).astype(f32), device=dev)
        self.sim_params = SimParams(
            dt=0.02, substeps=4, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=4.0e4, contact_damping=8.0e2,
            friction_vel=0.01, plane_friction=1.0)
        self.dt = self.sim_params.dt

    # ------------------------------------------------------------------
    def _fingertip_state(self, q, qd):
        """(B, 3, 13) fingertip position, orientation, velocity and angular
        velocity, world frame, from the tip sites."""
        f = forward_kinematics(self.model, q, qd)
        bp, bq = f.pos[:, self._tip_body], f.quat[:, self._tip_body]
        omega = f.omega[:, self._tip_body]
        p = bp + Q.rotate(bq, self._tip_pos)
        qq = Q.mul(bq, self._tip_quat.expand_as(bq))
        v = f.vel[:, self._tip_body] + torch.linalg.cross(omega, p - bp)
        return torch.cat([p, qq, v, omega], -1)

    def _object_state(self, q, qd):
        """(B, 13) the cube's state; the cube is the only floating root."""
        quat = q[:, 3:7]
        return torch.cat([q[:, 0:3], quat, qd[:, 3:6], Q.rotate(quat, qd[:, 0:3])], -1)

    def _joints(self, state):
        return state.q[:, 7:][:, self._dof], state.qd[:, 6:][:, self._dof]

    # ------------------------------------------------------------------
    def _sample_goal(self, u):
        """Goal poses from 7 uniforms per env: by difficulty, a position in
        the arena (above 1: up to 0.1 m high) and, at 4, a random
        orientation, else a random yaw."""
        r = torch.sqrt(u[:, 0]) * (ARENA_RADIUS - CUBE_SIZE)
        th = u[:, 1] * 2 * math.pi
        if self.task_difficulty <= 1:
            z = torch.full_like(r, CUBE_SIZE / 2)
        else:
            z = CUBE_SIZE / 2 + (0.1 - CUBE_SIZE / 2) * u[:, 2]
        pos = torch.stack([r * torch.cos(th), r * torch.sin(th), z], -1)
        if self.task_difficulty >= 4:
            quat = Q.normalize(normal(u[:, 3:7]))
        else:
            quat = Q.from_axis_angle(u.new_tensor([0.0, 0.0, 1.0]), u[:, 3] * 2 * math.pi)
        return pos, quat

    def default_task_state(self) -> TrifingerTaskState:
        B, dev = self.num_envs, self.device
        z = torch.zeros(B, 9, device=dev)
        return TrifingerTaskState(
            actions=z, goal_pos=torch.zeros(B, 3, device=dev),
            goal_quat=Q.identity((B,), device=dev),
            last_object=torch.zeros(B, 13, device=dev),
            last_fingertip=torch.zeros(B, 3, 13, device=dev),
            torques=z, successes=torch.zeros(B, device=dev))

    def reset_fn(self, rng: EnvRandom, params, task):
        """The robot at its default pose with noise, the cube anywhere in
        the arena with a random yaw, a goal by difficulty."""
        n = normal(rng.uniform(18))
        jq9 = torch.minimum(torch.maximum(self.q_def + self.dof_pos_stddev * n[:, :9], self.q_lo),
                            self.q_hi)
        jqd9 = self.dof_vel_stddev * n[:, 9:]
        B, dev = jq9.shape[0], jq9.device
        jq = torch.zeros(B, self.model.nj, device=dev)
        jqd = torch.zeros(B, self.model.nj, device=dev)
        jq[:, self._dof] = jq9
        jqd[:, self._dof] = jqd9
        u = rng.uniform(3)
        r = torch.sqrt(u[:, 0]) * (ARENA_RADIUS - CUBE_SIZE)
        th = u[:, 1] * 2 * math.pi
        obj_pos = torch.stack([r * torch.cos(th), r * torch.sin(th),
                               torch.full_like(r, CUBE_SIZE / 2)], -1)
        obj_quat = Q.from_axis_angle(u.new_tensor([0.0, 0.0, 1.0]), u[:, 2] * 2 * math.pi)
        q = torch.cat([obj_pos, obj_quat, jq], -1)
        qd = torch.cat([torch.zeros(B, 6, device=dev), jqd], -1)
        goal_pos, goal_quat = self._sample_goal(rng.uniform(7))
        obj = torch.cat([obj_pos, obj_quat, torch.zeros(B, 6, device=dev)], -1)
        z9 = torch.zeros(B, 9, device=dev)
        return q, qd, params, TrifingerTaskState(
            actions=z9, goal_pos=goal_pos, goal_quat=goal_quat, last_object=obj,
            last_fingertip=self._fingertip_state(q, qd), torques=z9,
            successes=torch.zeros(B, device=dev))

    # ------------------------------------------------------------------
    def pre_physics(self, state, actions):
        B = actions.shape[0]
        jq, jqd = self._joints(state)
        if self.command_mode == "torque":
            tau = actions * MAX_TORQUE if self.normalize_action else actions
        else:
            # position mode: targets tracked by a PD here
            tgt = 0.5 * (actions + 1.0) * (self.q_hi - self.q_lo) + self.q_lo \
                if self.normalize_action else actions
            kp = actions.new_tensor([10.0, 10.0, 10.0] * 3)
            kd = actions.new_tensor([0.1, 0.3, 0.001] * 3)
            tau = kp * (tgt - jq) - kd * jqd
        if self.apply_safety_damping:
            tau = tau - self.safety_kd * jqd
        tau = torch.clamp(tau, -MAX_TORQUE, MAX_TORQUE)
        effort = actions.new_zeros(B, self.model.nj)
        effort[:, self._dof] = tau
        z = torch.zeros_like(effort)
        task = dataclasses.replace(state.task, actions=actions, torques=tau)
        return Controls(z, z, effort), actions.new_zeros(B, self.model.nb, 6), task

    def _obs(self, jq, jqd, obj, t):
        obs = torch.cat([jq, jqd, obj[:, 0:7], t.goal_pos, t.goal_quat, t.actions], -1)
        if self.normalize_obs:
            obs = 2.0 * (obs - self._obs_lo) / (self._obs_hi - self._obs_lo) - 1.0
        return obs

    def post_physics(self, state, prev_task):
        t = prev_task
        B = state.q.shape[0]
        jq, jqd = self._joints(state)
        obj = self._object_state(state.q, state.qd)
        ft = self._fingertip_state(state.q, state.qd)

        # reward
        ft_vel = (ft[:, :, 0:3] - t.last_fingertip[:, :, 0:3]) / self.dt
        move_pen = self.finger_move_penalty_weight * torch.sum(ft_vel.reshape(B, 9) ** 2, -1)
        curr_n = torch.linalg.norm(ft[:, :, 0:3] - obj[:, None, 0:3], dim=-1)
        prev_n = torch.linalg.norm(t.last_fingertip[:, :, 0:3] - t.last_object[:, None, 0:3], dim=-1)
        env_steps = state.global_step.to(torch.float32) * B
        sched = ((env_steps >= self.ft_sched_start)
                 & (env_steps <= self.ft_sched_end)).to(torch.float32)
        reach = self.finger_reach_object_weight * sched * torch.sum(curr_n - prev_n, -1)
        if self.use_keypoints:
            d = torch.linalg.norm(gen_keypoints(obj[:, 0:3], obj[:, 3:7], self._corners)
                                  - gen_keypoints(t.goal_pos, t.goal_quat, self._corners), dim=-1)
            pose_rew = self.object_dist_weight * self.dt * lgsk_kernel(d, 30.0, 2.0).mean(-1)
        else:
            dist = torch.linalg.norm(obj[:, 0:3] - t.goal_pos, dim=-1)
            rot = quat_diff_rad(obj[:, 3:7], t.goal_quat)
            pose_rew = self.object_dist_weight * self.dt * lgsk_kernel(dist, 50.0, 2.0) \
                + self.object_rot_weight * self.dt / (3 * torch.abs(rot) + 0.01)
        reward = move_pen + reach + pose_rew

        # success
        pos_ok = torch.linalg.norm(obj[:, 0:3] - t.goal_pos, dim=-1) < self.position_tolerance
        quat_ok = quat_diff_rad(obj[:, 3:7], t.goal_quat) < self.orientation_tolerance
        success = pos_ok & quat_ok if self.task_difficulty == 4 else pos_ok

        obs = self._obs(jq, jqd, obj, t)
        task = dataclasses.replace(t, last_object=obj, last_fingertip=ft,
                                   successes=success.to(torch.float32))
        metrics = dict(state.metrics)
        metrics["success"] = success.to(torch.float32)
        metrics["pose_reward"] = pose_rew
        metrics["finger_obj_dist"] = curr_n.mean(-1)
        return obs, reward, torch.zeros(B, device=obs.device), task, metrics

    def compute_states(self, state, task_state):
        """The privileged states: the obs (before normalization), the cube's
        velocity, the fingertip states, the applied torques and the tip
        wrenches in the tip frames."""
        t = task_state
        B = state.q.shape[0]
        jq, jqd = self._joints(state)
        obj = t.last_object
        obs = torch.cat([jq, jqd, obj[:, 0:7], t.goal_pos, t.goal_quat, t.actions], -1)
        tq = t.last_fingertip[:, :, 3:7]
        f_l = Q.rotate_inv(tq, state.net_contact[:, self._tip_body])
        t_l = Q.rotate_inv(tq, state.net_torque[:, self._tip_body])
        wrench = torch.cat([f_l, t_l], -1).reshape(B, 18)
        return torch.cat([obs, obj[:, 7:13], t.last_fingertip.reshape(B, -1), t.torques, wrench],
                         -1)
