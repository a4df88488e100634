"""Cartpole task. Port of ``thormang_isaacgym_tpu/tasks/cartpole.py`` (the
reference's ``tasks/cartpole.py``).

- obs = [cart_pos, cart_vel, pole_angle, pole_vel]
- action: 1 effort on the slider scaled by max_effort
- reward = 1 - pole_angle^2 - 0.01|cart_vel| - 0.005|pole_vel|; -2 on reset
  conditions (|cart_pos| > reset_dist or |pole_angle| > pi/2); timeout 500
- reset: dof pos U(-0.1, 0.1), dof vel U(-0.25, 0.25)
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.engine.env import Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams

_ASSET = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "cartpole.urdf")


class Cartpole(Task):
    num_obs = 4
    num_actions = 1
    max_episode_length = 500

    def __init__(self, num_envs: int = 512, seed: int = 42, device=None,
                 reset_dist: float = 3.0, max_effort: float = 400.0, **_):
        super().__init__(num_envs, seed, device)
        self.reset_dist = reset_dist
        self.max_effort = max_effort
        model = load_urdf(_ASSET, fix_base_link=True)
        model._defaults["drive_mode"] = np.array([3, 0], dtype=np.int32)
        self.model = model
        self.slider = model.dof_id("slider_to_cart")
        self.pole = model.dof_id("cart_to_pole")
        self.sim_params = SimParams(dt=1.0 / 60.0, substeps=2, gravity=(0.0, 0.0, -9.81))

    def reset_fn(self, rng, params, task):
        q = 0.2 * (rng.uniform(self.model.nq) - 0.5)
        qd = 0.5 * (rng.uniform(self.model.nv) - 0.5)
        return q, qd, params, task

    def pre_physics(self, state, actions):
        B, nj = actions.shape[0], self.model.nj
        z = torch.zeros(B, nj, device=actions.device)
        effort = z.clone()
        effort[:, self.slider] = actions[:, 0] * self.max_effort
        wrench = torch.zeros(B, self.model.nb, 6, device=actions.device)
        return Controls(z, z, effort), wrench, state.task

    def post_physics(self, state, prev_task):
        cart_pos = state.q[:, self.slider]
        cart_vel = state.qd[:, self.slider]
        pole_angle = state.q[:, self.pole]
        pole_vel = state.qd[:, self.pole]
        obs = torch.stack([cart_pos, cart_vel, pole_angle, pole_vel], dim=-1)
        reward = 1.0 - pole_angle ** 2 - 0.01 * torch.abs(cart_vel) - 0.005 * torch.abs(pole_vel)
        out = (torch.abs(cart_pos) > self.reset_dist) | (torch.abs(pole_angle) > math.pi / 2)
        reward = torch.where(out, torch.full_like(reward, -2.0), reward)
        return obs, reward, out.to(torch.float32), prev_task, dict(state.metrics)
