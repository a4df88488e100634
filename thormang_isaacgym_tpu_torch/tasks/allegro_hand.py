"""AllegroHand cube reorientation. Port of
``thormang_isaacgym_tpu/tasks/allegro_hand.py`` (the reference's
``tasks/allegro_hand.py`` and ``cfg/task/AllegroHand.yaml``): the ShadowHand
machinery (goal resampling, success counting, the reward) with the fixed
16-DOF Allegro hand, every DOF actuated, no tendons. Obs 50 / 72 / 88 for
full_no_vel / full / full_state; full_state has no fingertip tail. The
6-DOF force sensors, and so the kernel's torque rows, are on the four
fingertip bodies.

The scene: the hand (17 bodies, 13 collision geoms: a palm box and 12
phalanx capsules) and the 6.5 cm cube, 18 bodies. Its actor pairs are one
box vs box (palm and cube) and twelve capsule vs box, 65 contact
candidates; the kernel runs them in its box instance (block B6).
"""
from __future__ import annotations

import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.models.allegro_hand import ALLEGRO_DOF_NAMES, load_allegro_hand
from thormang_isaacgym_tpu_torch.tasks.shadow_hand import ShadowHand, _unscale

ALLEGRO_NUM_OBS = {"full_no_vel": 50, "full": 72, "full_state": 88}
FINGERTIPS = ("index_link_3", "middle_link_3", "ring_link_3", "thumb_link_3")


class AllegroHand(ShadowHand):
    num_actions = 16
    max_episode_length = 600
    # the cube spawns over the Allegro palm (palm-up, palm centre y ~ -0.08)
    object_start = (0.0, -0.08, 0.60)
    goal_pos = (0.0, -0.08, 0.54)

    def __init__(self, num_envs: int = 16384, seed: int = 42, device=None,
                 obs_type: str = "full", asymmetric_obs: bool = False,
                 randomize: bool = False, **kw):
        if obs_type not in ALLEGRO_NUM_OBS:
            raise ValueError(f"obs_type {obs_type!r}: one of {sorted(ALLEGRO_NUM_OBS)}")
        super().__init__(num_envs=num_envs, seed=seed, device=device, obs_type="full",
                         asymmetric_obs=False, randomize=randomize,
                         hand_model=load_allegro_hand(), **kw)
        self.obs_type = obs_type
        self.num_obs = ALLEGRO_NUM_OBS[obs_type]
        self.num_states = 88 if asymmetric_obs else 0
        m = self.model
        self._set_maps([m.dof_id(n) for n in ALLEGRO_DOF_NAMES], [m.body_id(b) for b in FINGERTIPS])

    def _full_state(self, state, task):
        """88: DOF position, velocity and force, cube, goal, actions."""
        B = state.q.shape[0]
        jq, jqd = self._joints(state)
        obj_pos, obj_rot, obj_lin, obj_ang = self._object_state(state)
        return torch.cat([
            _unscale(jq, self.dof_lower, self.dof_upper), self.vel_obs_scale * jqd,
            self.ft_obs_scale * self._dof_force_estimate(state, task),
            obj_pos, obj_rot, obj_lin, self.vel_obs_scale * obj_ang,
            self._goal(B), task.goal_rot, Q.mul(obj_rot, Q.conj(task.goal_rot)),
            task.actions], -1)

    def _observations(self, state, t, obj_pos, obj_rot, obj_lin, obj_ang, quat_diff):
        B = state.q.shape[0]
        jq, jqd = self._joints(state)
        if self.obs_type == "full_no_vel":      # 50
            return torch.cat([_unscale(jq, self.dof_lower, self.dof_upper), obj_pos, obj_rot,
                              self._goal(B), t.goal_rot, quat_diff, t.actions], -1)
        if self.obs_type == "full":             # 72
            return torch.cat([_unscale(jq, self.dof_lower, self.dof_upper),
                              self.vel_obs_scale * jqd, obj_pos, obj_rot, obj_lin,
                              self.vel_obs_scale * obj_ang, self._goal(B), t.goal_rot,
                              quat_diff, t.actions], -1)
        return self._full_state(state, t)       # 88

