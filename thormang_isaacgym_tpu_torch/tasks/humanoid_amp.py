"""HumanoidAMP: the adversarial-motion-prior humanoid. Port of
``thormang_isaacgym_tpu/tasks/humanoid_amp.py`` (the reference's
``tasks/humanoid_amp.py`` and ``tasks/amp/humanoid_amp_base.py``).

- The 28-DOF AMP humanoid (``models/amp_humanoid.py``: 29 bodies, no actor
  pairs, so the kernel's flat instance), PD position control through the
  extended action offset and scale map (3-DOF joints span +-pi, 1-DOF
  joints their mid-range +- 0.7 x their range).
- obs: the 105-wide AMP feature of the current state, [root height, root
  rotation tan-norm (6), local root velocity (3), local root angular
  velocity (3), dof_obs (52), dof velocities (28), local key-body
  positions (12)] (``build_amp_observations``).
- The AMP window, ``numAMPObsSteps`` frames current first, is the task
  state, rolled every step; the learner reads it (``learn/amp.py``).
- The control step ``dt`` is the physics step times ``control_freq_inv``
  (0.0166 x 2 = 0.0332 s): the history window and the demo windows step by
  it, so ``set_dt`` multiplies what ``apply_cfg_sim`` passes.
- Reference-state init from the motion library, in the four modes Default
  (0: the default pose), Start (1: t = 0), Random (2) and Hybrid (3: the
  reference state with probability ``hybrid_init_prob``); the history
  window holds the motion at max(t0 - k dt, 0).
- Early termination: a non-foot body in contact and a non-foot body (the
  massless ``__`` sub-joint links left out) below ``termination_height``,
  after the first step. Reward 1; the style reward comes from the
  discriminator. Metric ``pose_error``: the least mean absolute joint-angle
  difference to a bank of at most 128 demo poses, wrapped to [-pi, pi).

Forward kinematics runs once per step for the observation and the height
check. Randomness: the reset's draws come from the env's counter-based
stream (``EnvRandom``), the demo fetch's from an explicit
``torch.Generator``; ``reset_from`` and ``demo_obs`` take the sampled
motion ids and times, so the CPU tests feed JAX's draws across.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import Task
from thormang_isaacgym_tpu_torch.learn.motion_lib import default_motion_lib
from thormang_isaacgym_tpu_torch.models import amp_humanoid as AH
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams

NUM_AMP_OBS_PER_STEP = 13 + 52 + 28 + 12
STATE_INIT = {"Default": 0, "Start": 1, "Random": 2, "Hybrid": 3}


def dof_to_obs(dof_pos_amp: torch.Tensor) -> torch.Tensor:
    """(..., 28) AMP-layout DOF positions -> (..., 52) features: 3-DOF joints
    as the tan-norm of their rotation, 1-DOF joints as they are."""
    parts = []
    for j, (_, _, _, size) in enumerate(AH._JOINTS):
        o = AH.DOF_OFFSETS[j]
        if size == 3:
            # intrinsic z-y-x Euler angles (the model's chart)
            qz, qy, qx = dof_pos_amp[..., o], dof_pos_amp[..., o + 1], dof_pos_amp[..., o + 2]
            parts.append(Q.to_tan_norm(Q.from_euler_xyz(qx, qy, qz)))
        else:
            parts.append(dof_pos_amp[..., o:o + 1])
    return torch.cat(parts, dim=-1)


def build_amp_observations(root_pos, root_rot, root_vel, root_ang_vel, dof_pos_amp, dof_vel_amp,
                           key_pos_world, local_root_obs: bool = False) -> torch.Tensor:
    """The observation and AMP feature of one frame (the reference's
    ``build_amp_observations``); broadcasts over leading axes."""
    root_h = root_pos[..., 2:3]
    heading_inv = Q.heading_quat_inv(root_rot)
    rot_obs = Q.mul(heading_inv, root_rot) if local_root_obs else root_rot
    rot_obs = Q.to_tan_norm(rot_obs)
    local_vel = Q.rotate(heading_inv, root_vel)
    local_ang_vel = Q.rotate(heading_inv, root_ang_vel)
    rel_key = key_pos_world - root_pos[..., None, :]
    local_key = Q.rotate(heading_inv[..., None, :].expand(rel_key.shape[:-1] + (4,)), rel_key)
    local_key = local_key.reshape(local_key.shape[:-2] + (-1,))
    return torch.cat([root_h, rot_obs, local_vel, local_ang_vel, dof_to_obs(dof_pos_amp),
                      dof_vel_amp, local_key], dim=-1)


@dataclasses.dataclass(frozen=True)
class AMPTaskState:
    amp_obs: torch.Tensor     # (B, S, 105) the window, current frame first


class HumanoidAMP(Task):
    """State-init modes: 0 Default, 1 Start, 2 Random, 3 Hybrid."""

    max_episode_length = 300
    control_freq_inv = 2               # 30 Hz control
    power_scale = 1.0
    pd_control = True
    termination_height = 0.5
    enable_early_termination = True
    local_root_obs = False
    hybrid_init_prob = 0.5

    def __init__(self, num_envs: int = 4096, seed: int = 42, device=None,
                 state_init: str = "Random", num_amp_obs_steps: int = 2,
                 motion_file: str | None = None, randomize: bool = False, **_):
        super().__init__(num_envs, seed, device)
        if num_amp_obs_steps < 2:
            raise ValueError(f"numAMPObsSteps must be at least 2, got {num_amp_obs_steps}")
        dev = self.device
        self.state_init = STATE_INIT[state_init]
        self.num_amp_obs_steps = num_amp_obs_steps
        self.num_amp_obs = num_amp_obs_steps * NUM_AMP_OBS_PER_STEP
        self.model = model = AH.load_amp_humanoid()
        perm = AH.amp_dof_perm(model)
        self.perm = torch.as_tensor(perm, dtype=torch.int64, device=dev)
        self.inv_perm = torch.as_tensor(np.argsort(perm), dtype=torch.int64, device=dev)
        self.motion_lib = default_motion_lib(motion_file, device=dev)
        self.num_obs = NUM_AMP_OBS_PER_STEP
        self.num_actions = AH.NUM_DOF
        self.sim_params = SimParams(
            dt=0.0166, substeps=2, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=4.0e4, contact_damping=1.5e3,
            friction_vel=0.1, plane_friction=1.0)
        self.dt = self.sim_params.dt * self.control_freq_inv
        self._ks = torch.arange(num_amp_obs_steps, dtype=torch.float32, device=dev)

        # PD action offset and scale, built in the AMP layout, scattered
        # into the model's DOF layout
        d = model._defaults
        lo = np.array(d["dof_lower"], np.float64).copy()
        hi = np.array(d["dof_upper"], np.float64).copy()
        for j, (_, _, _, size) in enumerate(AH._JOINTS):
            o = AH.DOF_OFFSETS[j]
            idx = perm[o:o + size]
            if size == 3:
                lo[idx], hi[idx] = -np.pi, np.pi
            else:
                mid = 0.5 * (hi[idx] + lo[idx])
                half = 0.7 * (hi[idx] - lo[idx])
                lo[idx], hi[idx] = mid - half, mid + half
        self.pd_offset = torch.as_tensor(0.5 * (hi + lo), dtype=torch.float32, device=dev)
        self.pd_scale = torch.as_tensor(0.5 * (hi - lo), dtype=torch.float32, device=dev)

        # key bodies: the hands are sites on the lower arms, the feet bodies
        body, offset = [], []
        for k in AH.KEY_BODY_NAMES:
            if k in model.sites:
                b, pos, _ = model.sites[k]
                body.append(b)
                offset.append(pos)
            else:
                body.append(model.body_id(k))
                offset.append((0.0, 0.0, 0.0))
        self._key_body = torch.as_tensor(body, dtype=torch.int64, device=dev)
        self._key_offset = torch.as_tensor(np.asarray(offset, np.float32), device=dev)
        contact_ids = [model.body_id(n) for n in AH.CONTACT_BODY_NAMES]
        mask = np.ones(model.nb, bool)
        mask[contact_ids] = False
        # the sub-joint links are massless, without geometry, at joint anchors
        height_mask = mask & np.array(["__" not in n for n in model.body_names])
        self._noncontact_mask = torch.as_tensor(mask, device=dev)
        self._height_mask = torch.as_tensor(height_mask, device=dev)

        # the default pose: arms out (the upper arms' x sub-DOFs at +-pi/2)
        q_def = np.zeros(model.nq, np.float32)
        q_def[2], q_def[3] = AH.PELVIS_HEIGHT, 1.0
        q_def[7 + model.dof_id("right_upper_arm_x")] = 0.5 * np.pi
        q_def[7 + model.dof_id("left_upper_arm_x")] = -0.5 * np.pi
        self._q_def = torch.as_tensor(q_def, device=dev)
        self._qd_def = torch.zeros(model.nv, device=dev)
        amp_def, _ = self._amp_obs_from_state(self._q_def[None], self._qd_def[None])
        self._amp_def = amp_def.expand(num_amp_obs_steps, -1).clone()    # (S, 105)

        # imitation quality: at most 128 demo poses across all clips
        nf = self.motion_lib.num_frames.cpu().numpy()
        dof = self.motion_lib.dof_pos.cpu().numpy()
        rows = np.concatenate([dof[i, :int(nf[i])] for i in range(len(nf))])
        stride = max(1, len(rows) // 128)
        self._demo_dof_bank = torch.as_tensor(rows[::stride][:128], device=dev)   # (Fb, 28)

    def set_dt(self, dt: float) -> None:
        """`dt` is the physics step (``apply_cfg_sim``); the task's dt is the
        control step, control_freq_inv of them."""
        self.dt = dt * self.control_freq_inv

    # ------------------------------------------------------------------
    def _amp_obs_from_state(self, q, qd):
        """(B, 105) features and (B, nb) body heights of the physics state:
        one forward kinematics for both."""
        frames = forward_kinematics(self.model, q, qd)
        key_pos = frames.pos[:, self._key_body] + Q.rotate(
            frames.quat[:, self._key_body], self._key_offset.expand(q.shape[0], -1, -1))
        root_rot = q[:, 3:7]
        obs = build_amp_observations(
            q[:, 0:3], root_rot, qd[:, 3:6], Q.rotate(root_rot, qd[:, 0:3]),
            q[:, 7:][:, self.perm], qd[:, 6:][:, self.perm], key_pos, self.local_root_obs)
        return obs, frames.pos[..., 2]

    def _motion_state_to_qqd(self, ms):
        root_pos, root_rot, dof_pos, root_vel, root_ang_vel, dof_vel, _ = ms
        q = torch.cat([root_pos, root_rot, dof_pos[..., self.inv_perm]], dim=-1)
        qd = torch.cat([Q.rotate_inv(root_rot, root_ang_vel), root_vel,
                        dof_vel[..., self.inv_perm]], dim=-1)
        return q, qd

    def _window(self, motion_ids, t0):
        """(n, S, 105) features of the motion at max(t0 - k dt, 0), k < S,
        straight from the motion data (its stored key positions)."""
        times = torch.clamp(t0[:, None] - self._ks[None, :] * self.dt, min=0.0)
        ms = self.motion_lib.get_motion_state(motion_ids[:, None].expand_as(times), times)
        root_pos, root_rot, dof_pos, root_vel, root_ang_vel, dof_vel, kp = ms
        return build_amp_observations(root_pos, root_rot, root_vel, root_ang_vel, dof_pos,
                                      dof_vel, kp, self.local_root_obs)

    # ------------------------------------------------------------------
    def default_task_state(self):
        return AMPTaskState(torch.zeros(self.num_envs, self.num_amp_obs_steps,
                                        NUM_AMP_OBS_PER_STEP, device=self.device))

    def reset_from(self, motion_ids, t_rand, use_ref):
        """(q, qd, window) of a reset from sampled motion ids, times and, in
        the Hybrid mode, the envs that take the reference state."""
        B = motion_ids.shape[0]
        q_def = self._q_def.expand(B, -1)
        qd_def = self._qd_def.expand(B, -1)
        amp_def = self._amp_def.expand(B, -1, -1)
        if self.state_init == 0:
            return q_def.clone(), qd_def.clone(), amp_def.clone()
        t0 = torch.zeros_like(t_rand) if self.state_init == 1 else t_rand
        q_ref, qd_ref = self._motion_state_to_qqd(self.motion_lib.get_motion_state(motion_ids, t0))
        amp_ref = self._window(motion_ids, t0)
        if self.state_init in (1, 2):
            return q_ref, qd_ref, amp_ref
        return (torch.where(use_ref[:, None], q_ref, q_def),
                torch.where(use_ref[:, None], qd_ref, qd_def),
                torch.where(use_ref[:, None, None], amp_ref, amp_def))

    def reset_fn(self, rng, params, task):
        u = rng.uniform(3)
        ml = self.motion_lib
        ids = ml.ids_at(u[:, 1])
        q, qd, amp = self.reset_from(ids, u[:, 2] * ml.lengths[ids],
                                     u[:, 0] < self.hybrid_init_prob)
        return q, qd, params, AMPTaskState(amp)

    def pre_physics(self, state, actions):
        B = actions.shape[0]
        target = self.pd_offset + self.pd_scale * actions
        z = torch.zeros_like(target)
        wrench = torch.zeros(B, self.model.nb, 6, device=actions.device)
        return Controls(target, z, z), wrench, state.task

    def post_physics(self, state, prev_task):
        B = state.q.shape[0]
        cur, body_h = self._amp_obs_from_state(state.q, state.qd)
        amp = torch.cat([cur[:, None], prev_task.amp_obs[:, :-1]], dim=1)
        contact = torch.linalg.norm(state.net_contact, dim=-1) > 0.1
        fall_contact = (contact & self._noncontact_mask).any(-1)
        fall_height = ((body_h < self.termination_height) & self._height_mask).any(-1)
        has_fallen = fall_contact & fall_height & (state.progress > 1)
        if not self.enable_early_termination:
            has_fallen = torch.zeros_like(has_fallen)
        reward = torch.ones(B, device=state.q.device)
        metrics = dict(state.metrics)
        metrics["terminate"] = has_fallen.to(torch.float32)
        d = state.q[:, 7:][:, self.perm][:, None, :] - self._demo_dof_bank[None]
        d = torch.remainder(d + math.pi, 2.0 * math.pi) - math.pi
        metrics["pose_error"] = torch.abs(d).mean(-1).amin(-1)
        return cur, reward, has_fallen.to(torch.float32), AMPTaskState(amp), metrics

    # ------------------------------------------------------------------
    def demo_obs(self, motion_ids, t0) -> torch.Tensor:
        """(n, num_amp_obs) demo windows of the motions at sampled times."""
        return self._window(motion_ids, t0).reshape(motion_ids.shape[0], self.num_amp_obs)

    def fetch_amp_obs_demo(self, gen: torch.Generator, num_samples: int) -> torch.Tensor:
        """(num_samples, num_amp_obs) demo windows from the motion library
        (the reference's ``fetch_amp_obs_demo``), drawn from `gen`."""
        ids = self.motion_lib.sample_motions(gen, num_samples)
        return self.demo_obs(ids, self.motion_lib.sample_time(gen, ids))
