"""ShadowHand cube reorientation. Port of
``thormang_isaacgym_tpu/tasks/shadow_hand.py`` (the reference's
``tasks/shadow_hand.py`` and ``cfg/task/ShadowHand.yaml``): a fixed
24-DOF Shadow Hand (20 actuated, four distal joints coupled by fixed
tendons) holds a free cube palm-up and turns it to a goal orientation.

- actions (20): absolute position targets scaled to the actuated DOF
  limits with a moving average ``actionsMovingAverage``, or relative
  ``dofSpeedScale * dt`` deltas
- obs openai / full_no_vel / full / full_state = 42 / 77 / 157 / 211; the
  fingertip force-torque and DOF-force channels are scaled by 10, the
  velocities by 0.2
- reward: goal distance * -10 + 1 / (|rot_dist| + 0.1), actions^2 *
  -0.0002, +250 on success (rot_dist <= 0.1); done when the cube falls
  0.24 m from the goal position. On success the goal resamples without a
  reset; successes and the consecutive-success EMA (factor 0.1) count.
- goal-distance curriculum (the JAX package's, no reference analog): a
  fresh goal lies a uniform angle in [0.2, cap] from the cube's current
  orientation about a uniform axis; the cap grows by 2.5e-4 rad a step while
  the EMA is at least 0.6, and at pi - 0.05 the goal is the reference's
  uniform draw (pi rand about x, then about y)
- reset: cube position noise 0.01 m, a random orientation, hand DOF noise
  0.2 toward the limits
- random object forces (``forceScale``, probability per env loguniform in
  [0.001, 0.1], decay 0.99 per 0.08 s) through the body-wrench path
- ``randomize``: the domain randomisation of ``cfg/task/ShadowHand.yaml``'s
  ``randomization_params`` (engine/dr.py); AllegroHand passes it through

Random draws are the port's per-env murmur3 streams (``EnvRandom``): the
reset's on the env's episode, the force kicks' (salt 77) and the goal
resampling's (salt 303) on the global step. They are not the JAX package's
threefry draws. The hand's four fixed tendons run in the kernel's tendon
block (B4b). AllegroHand (``tasks/allegro_hand.py``) subclasses this task.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom, Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.models.shadow_hand import (
    ACTUATED_DOF_NAMES, FINGERTIP_BODIES, load_shadow_hand, make_block_urdf,
)
from thormang_isaacgym_tpu_torch.ops.dynamics import tendon_tables
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams
from thormang_isaacgym_tpu_torch.tasks.common import normal
from thormang_isaacgym_tpu_torch.utils.config import CFG_ROOT, load_yaml

HAND_POS = (0.0, 0.0, 0.5)
# cube spawn over the palm, clearing the cube's half diagonal in every orientation
OBJECT_START = (0.0, -0.39, 0.625)
GOAL_POS = (0.0, -0.39, 0.56)

NUM_OBS = {"openai": 42, "full_no_vel": 77, "full": 157, "full_state": 211}


@dataclasses.dataclass(frozen=True)
class HandTaskState:
    goal_rot: torch.Tensor        # (B, 4) wxyz
    successes: torch.Tensor       # (B,)
    cons_successes: torch.Tensor  # (B,) the EMA, the same in every env
    prev_targets: torch.Tensor    # (B, nj)
    actions: torch.Tensor         # (B, num_actions)
    rb_force: torch.Tensor        # (B, 3) decaying random object force
    force_prob: torch.Tensor      # (B,)
    goal_cap: torch.Tensor        # (B,) curriculum cap on the goal distance, the same in every env


def _rand_rot(r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """randomize_rotation: pi r0 about x, then pi r1 about y (r in [-1, 1))."""
    ex = r0.new_tensor([1.0, 0.0, 0.0])
    ey = r0.new_tensor([0.0, 1.0, 0.0])
    return Q.mul(Q.from_axis_angle(ex, r0 * math.pi), Q.from_axis_angle(ey, r1 * math.pi))


def _curriculum_goal(u: torch.Tensor, obj_rot, cap, min_angle: float):
    """A goal orientation from 7 uniforms per env (B, 7): a uniform angle in
    [min_angle, cap] about a uniform axis from the current orientation, or,
    once the cap is within 0.05 of pi, the reference's uniform draw."""
    full = _rand_rot(2.0 * u[:, 0] - 1.0, 2.0 * u[:, 1] - 1.0)
    axis = normal(u[:, 2:6])[:, :3]
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-9)
    ang = min_angle + (cap - min_angle) * u[:, 6]
    near = Q.mul(Q.conj(Q.from_axis_angle(axis, ang)), obj_rot)
    return torch.where((cap >= math.pi - 0.05)[:, None], full, near)


def _unscale(x, lo, hi):
    return (2.0 * x - (hi + lo)) / (hi - lo)


def _scale(x, lo, hi):
    return 0.5 * (x + 1.0) * (hi - lo) + lo


class ShadowHand(Task):
    """Cube reorientation (``isaacgym_task_map["ShadowHand"]``)."""

    uses_net_torque = True
    num_actions = 20
    max_episode_length = 600
    clip_obs = 5.0

    # reward and task constants (ShadowHand.yaml)
    dist_reward_scale = -10.0
    rot_reward_scale = 1.0
    rot_eps = 0.1
    action_penalty_scale = -0.0002
    success_tolerance = 0.1
    reach_goal_bonus = 250.0
    fall_dist = 0.24
    fall_penalty = 0.0
    max_consecutive_successes = 0
    av_factor = 0.1
    vel_obs_scale = 0.2
    ft_obs_scale = 10.0
    reset_position_noise = 0.01
    reset_dof_pos_noise = 0.2
    reset_dof_vel_noise = 0.0
    use_relative_control = False
    dof_speed_scale = 20.0
    act_moving_average = 1.0
    object_start = OBJECT_START
    goal_pos = GOAL_POS
    curriculum_start = 0.8
    curriculum_min_angle = 0.2
    curriculum_promote = 0.6
    curriculum_rate = 2.5e-4

    def __init__(self, num_envs: int = 16384, seed: int = 42, device=None,
                 obs_type: str = "full_state", asymmetric_obs: bool = False,
                 randomize: bool = False, force_scale: float = 0.0,
                 goal_curriculum: bool = True, hand_model=None,
                 object_urdf: str | None = None, **_):
        super().__init__(num_envs, seed, device)
        if obs_type not in NUM_OBS:
            raise ValueError(f"obs_type {obs_type!r}: one of {sorted(NUM_OBS)}")
        dev = self.device
        self.goal_curriculum = goal_curriculum
        self.obs_type = obs_type
        self.num_obs = NUM_OBS[obs_type]
        self.num_states = 211 if asymmetric_obs else 0
        self.force_scale = force_scale
        self.force_prob_range = (0.001, 0.1)
        self.force_decay = 0.99
        self.force_decay_interval = 0.08

        hand = hand_model or load_shadow_hand()
        block = load_urdf(object_urdf or make_block_urdf())
        scene = compose([
            (hand, HAND_POS + (1.0, 0.0, 0.0, 0.0), ""),
            (block, tuple(self.object_start) + (1.0, 0.0, 0.0, 0.0), "obj/"),
        ], name="shadow_hand_scene")
        self.model = scene
        self.nj = scene.nj
        d = scene._defaults
        self.dof_lower = torch.as_tensor(np.array(d["dof_lower"]), device=dev)
        self.dof_upper = torch.as_tensor(np.array(d["dof_upper"]), device=dev)
        self.kp = torch.as_tensor(np.array(d["drive_stiffness"]), device=dev)
        self.kd = torch.as_tensor(np.array(d["drive_damping"]), device=dev)
        self.effort_lim = torch.as_tensor(np.array(d["drive_effort_limit"]), device=dev)
        if set(ACTUATED_DOF_NAMES) <= set(scene.joint_names):
            self._set_maps([scene.dof_id(n) for n in ACTUATED_DOF_NAMES],
                           [scene.body_id(b) for b in FINGERTIP_BODIES])
        else:
            # another hand (AllegroHand): its subclass sets the maps
            self._set_maps(list(range(self.num_actions)), [])
        self.object_body = scene.body_id("obj/object")
        self.object_mass = float(np.asarray(d["body_mass"])[self.object_body])
        self._tendon = tendon_tables(scene.tendons, dev) if scene.tendons else None
        # ShadowHand.yaml's sim block: dt 0.01667, 2 substeps
        self.sim_params = SimParams(
            dt=1.0 / 60.0, substeps=2, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=5.0e4, contact_damping=200.0,
            friction_vel=0.01, plane_friction=1.0,
            max_depenetration_velocity=1.0)
        self.dt = self.sim_params.dt
        if randomize:
            # ShadowHand.yaml's whole randomization_params block: correlated
            # obs / action noise, gravity, tendon, dof, mass and friction
            # blocks with 250 buckets, setup-only mass and object scale
            self.dr_config = load_yaml(os.path.join(CFG_ROOT, "task", "ShadowHand.yaml")) \
                ["task"]["randomization_params"]
        # device constants built once (a constant made in step_fn is a host copy)
        self._object_start = torch.tensor(self.object_start, device=dev)
        self._goal_pos = torch.tensor(self.goal_pos, device=dev)

    def _set_maps(self, act_ids, fingertip_ids) -> None:
        """Actuated DOFs and fingertip bodies; the fingertips carry the
        6-DOF force sensors, so the kernel keeps torque rows for them only."""
        dev = self.device
        self.act_ids = np.asarray(act_ids, np.int64)
        self.fingertip_ids = np.asarray(fingertip_ids, np.int64)
        self._act = torch.as_tensor(self.act_ids, device=dev)
        self._ft = torch.as_tensor(self.fingertip_ids, device=dev)
        self.act_lower = self.dof_lower[self._act]
        self.act_upper = self.dof_upper[self._act]
        if len(self.fingertip_ids):
            self.net_torque_bodies = tuple(int(b) for b in self.fingertip_ids)

    # ------------------------------------------------------------------
    def default_task_state(self) -> HandTaskState:
        B, dev = self.num_envs, self.device
        z = torch.zeros(B, device=dev)
        return HandTaskState(
            goal_rot=Q.identity((B,), device=dev),
            successes=z, cons_successes=z,
            prev_targets=torch.zeros(B, self.nj, device=dev),
            actions=torch.zeros(B, self.num_actions, device=dev),
            rb_force=torch.zeros(B, 3, device=dev),
            force_prob=torch.full((B,), 0.01, device=dev),
            goal_cap=torch.full((B,), self.curriculum_start if self.goal_curriculum
                                else math.pi, device=dev))

    def reset_fn(self, rng: EnvRandom, params, task: HandTaskState):
        """Every env's reset: cube position noise and a random orientation, a
        goal within the curriculum cap, hand DOFs noised toward their limits."""
        B = task.goal_rot.shape[0]
        pos = self._object_start + self.reset_position_noise * rng.uniform(3, -1.0, 1.0)
        r = rng.uniform(2, -1.0, 1.0)
        obj_rot = _rand_rot(r[:, 0], r[:, 1])
        goal_rot = _curriculum_goal(rng.uniform(7), obj_rot, task.goal_cap,
                                    self.curriculum_min_angle)
        rand = rng.uniform(self.nj, -1.0, 1.0)
        rand_delta = self.dof_lower + (self.dof_upper - self.dof_lower) * 0.5 * (rand + 1.0)
        jq = torch.minimum(torch.maximum(self.reset_dof_pos_noise * rand_delta, self.dof_lower),
                           self.dof_upper)
        jqd = self.reset_dof_vel_noise * rng.uniform(self.nj, -1.0, 1.0)
        q = torch.cat([pos, obj_rot, jq], -1)
        qd = torch.cat([torch.zeros(B, 6, device=jq.device), jqd], -1)
        lo, hi = self.force_prob_range
        u = rng.uniform(1)[:, 0]
        force_prob = torch.exp((math.log(lo) - math.log(hi)) * u + math.log(hi))
        z = torch.zeros(B, device=jq.device)
        task = HandTaskState(
            goal_rot=goal_rot, successes=z, cons_successes=task.cons_successes,
            prev_targets=jq, actions=torch.zeros(B, self.num_actions, device=jq.device),
            rb_force=torch.zeros(B, 3, device=jq.device), force_prob=force_prob,
            goal_cap=task.goal_cap)
        return q, qd, params, task

    # ------------------------------------------------------------------
    def pre_physics(self, state, actions):
        """Position targets, and the random object force as a body wrench."""
        B = actions.shape[0]
        t = state.task
        prev = t.prev_targets
        lo, hi = self.act_lower, self.act_upper
        if self.use_relative_control:
            tgt = prev[:, self._act] + self.dof_speed_scale * self.dt * actions
        else:
            tgt = _scale(actions, lo, hi)
            tgt = self.act_moving_average * tgt + (1.0 - self.act_moving_average) * prev[:, self._act]
        tgt = torch.minimum(torch.maximum(tgt, lo), hi)
        targets = prev.clone()
        targets[:, self._act] = tgt
        wrench = torch.zeros(B, self.model.nb, 6, device=actions.device)
        rb_force = t.rb_force
        if self.force_scale > 0.0:
            u = EnvRandom.of_step(state, 77).uniform(5)
            decay = self.force_decay ** (self.dt / self.force_decay_interval)
            kick = u[:, 0] < t.force_prob
            new_f = normal(u[:, 1:5])[:, :3] * (self.object_mass * self.force_scale)
            rb_force = torch.where(kick[:, None], new_f, rb_force * decay)
            wrench[:, self.object_body, 3:6] = rb_force
        z = torch.zeros(B, self.nj, device=actions.device)
        return Controls(targets, z, z), wrench, dataclasses.replace(
            t, prev_targets=targets, actions=actions, rb_force=rb_force)

    # ------------------------------------------------------------------
    def _object_state(self, state):
        """(position, orientation, linear velocity, angular velocity), world."""
        rot = state.q[:, 3:7]
        return state.q[:, 0:3], rot, state.qd[:, 3:6], Q.rotate(rot, state.qd[:, 0:3])

    def _fingertip_state(self, state):
        f = forward_kinematics(self.model, state.q, state.qd)
        ft = self._ft
        return f.pos[:, ft], f.quat[:, ft], f.vel[:, ft], f.omega[:, ft]

    def _joints(self, state):
        nf = self.model.n_floating
        return state.q[:, 7 * nf:], state.qd[:, 6 * nf:]

    def _dof_force_estimate(self, state, task):
        """The DOF force sensors: the drive torque, plus the tendon limit
        springs' torque where the hand has tendons, at the current state."""
        jq, jqd = self._joints(state)
        tau = self.kp * (task.prev_targets - jq) - self.kd * jqd
        tau = torch.minimum(torch.maximum(tau, -self.effort_lim), self.effort_lim)
        if self._tendon is not None:
            coefs, lo, hi = self._tendon
            L = jq @ coefs.t()
            Ld = jqd @ coefs.t()
            viol = L - torch.minimum(torch.maximum(L, lo), hi)
            k = state.params.tendon_stiffness
            c = state.params.tendon_damping
            f = -(k * viol + c * Ld * (torch.abs(viol) > 0).to(L.dtype))
            tau = tau + f @ coefs
        return tau

    def _goal(self, B):
        return self._goal_pos.expand(B, 3)

    def _full_state(self, state, task):
        """The 211-dim full_state layout."""
        B = state.q.shape[0]
        jq, jqd = self._joints(state)
        obj_pos, obj_rot, obj_lin, obj_ang = self._object_state(state)
        fpos, fquat, fvel, fomega = self._fingertip_state(state)
        ft_state = torch.cat([fpos, fquat, fvel, self.vel_obs_scale * fomega], -1).reshape(B, 65)
        ft_force = Q.rotate_inv(fquat, state.net_contact[:, self._ft])
        ft_torque = Q.rotate_inv(fquat, state.net_torque[:, self._ft])
        ft_ft = torch.cat([ft_force, ft_torque], -1).reshape(B, 30)
        return torch.cat([
            _unscale(jq, self.dof_lower, self.dof_upper), self.vel_obs_scale * jqd,
            self.ft_obs_scale * self._dof_force_estimate(state, task),
            obj_pos, obj_rot, obj_lin, self.vel_obs_scale * obj_ang,
            self._goal(B), task.goal_rot, Q.mul(obj_rot, Q.conj(task.goal_rot)),
            ft_state, self.ft_obs_scale * ft_ft, task.actions], -1)

    def compute_states(self, state, task_state):
        return self._full_state(state, task_state)

    def _observations(self, state, t, obj_pos, obj_rot, obj_lin, obj_ang, quat_diff):
        B = state.q.shape[0]
        jq, jqd = self._joints(state)
        if self.obs_type == "openai":
            fpos = self._fingertip_state(state)[0]
            return torch.cat([fpos.reshape(B, 15), obj_pos, quat_diff, t.actions], -1)
        if self.obs_type == "full_no_vel":
            fpos = self._fingertip_state(state)[0]
            return torch.cat([_unscale(jq, self.dof_lower, self.dof_upper), obj_pos, obj_rot,
                              self._goal(B), t.goal_rot, quat_diff, fpos.reshape(B, 15),
                              t.actions], -1)
        if self.obs_type == "full":
            fpos, fquat, fvel, fomega = self._fingertip_state(state)
            ft_state = torch.cat([fpos, fquat, fvel, self.vel_obs_scale * fomega],
                                 -1).reshape(B, -1)
            return torch.cat([_unscale(jq, self.dof_lower, self.dof_upper),
                              self.vel_obs_scale * jqd, obj_pos, obj_rot, obj_lin,
                              self.vel_obs_scale * obj_ang, self._goal(B), t.goal_rot,
                              quat_diff, ft_state, t.actions], -1)
        return self._full_state(state, t)

    # ------------------------------------------------------------------
    def post_physics(self, state, prev_task):
        t = prev_task
        B = state.q.shape[0]
        obj_pos, obj_rot, obj_lin, obj_ang = self._object_state(state)
        quat_diff = Q.mul(obj_rot, Q.conj(t.goal_rot))
        obs = self._observations(state, t, obj_pos, obj_rot, obj_lin, obj_ang, quat_diff)

        # reward (compute_hand_reward)
        goal_dist = torch.linalg.norm(obj_pos - self._goal_pos, dim=-1)
        rot_dist = 2.0 * torch.asin(torch.clamp(torch.linalg.norm(quat_diff[:, 1:4], dim=-1),
                                                0.0, 1.0))
        reward = goal_dist * self.dist_reward_scale \
            + 1.0 / (torch.abs(rot_dist) + self.rot_eps) * self.rot_reward_scale \
            + torch.sum(t.actions ** 2, -1) * self.action_penalty_scale
        goal_reached = torch.abs(rot_dist) <= self.success_tolerance
        successes = t.successes + goal_reached.to(reward.dtype)
        reward = torch.where(goal_reached, reward + self.reach_goal_bonus, reward)
        fell = goal_dist >= self.fall_dist
        reward = torch.where(fell, reward + self.fall_penalty, reward)
        done = fell
        timeout = state.progress >= self.max_episode_length - 1
        if self.max_consecutive_successes > 0:
            done = done | (successes >= self.max_consecutive_successes)
            reward = torch.where(timeout, reward + 0.5 * self.fall_penalty, reward)
        done = done.to(reward.dtype)

        # on success a new goal, within the cap of the orientation just reached
        u = EnvRandom.of_step(state, 303).uniform(7)
        new_goals = _curriculum_goal(u, obj_rot, t.goal_cap, self.curriculum_min_angle)
        goal_rot = torch.where(goal_reached[:, None], new_goals, t.goal_rot)

        # the consecutive-success EMA over this step's resets
        resets_all = torch.maximum(done, timeout.to(done.dtype))
        num_resets = torch.sum(resets_all)
        finished = torch.sum(successes * resets_all)
        cons = torch.where(num_resets > 0,
                           self.av_factor * finished / torch.clamp(num_resets, min=1.0)
                           + (1.0 - self.av_factor) * t.cons_successes, t.cons_successes)
        goal_cap = t.goal_cap
        if self.goal_curriculum:
            gate = (cons >= self.curriculum_promote).to(cons.dtype)
            goal_cap = torch.clamp(goal_cap + gate * self.curriculum_rate, max=math.pi)
        task = dataclasses.replace(t, goal_rot=goal_rot, successes=successes,
                                   cons_successes=cons, goal_cap=goal_cap)
        metrics = dict(state.metrics)
        metrics["consecutive_successes"] = cons
        metrics["successes"] = successes
        metrics["rot_dist"] = rot_dist
        metrics["goal_dist"] = goal_dist
        metrics["goal_cap"] = goal_cap
        return obs, reward, done, task, metrics
