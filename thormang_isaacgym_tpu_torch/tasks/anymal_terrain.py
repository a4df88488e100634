"""AnymalTerrain: rough-terrain locomotion with a curriculum. Port of
``thormang_isaacgym_tpu/tasks/anymal_terrain.py`` (the reference's
``tasks/anymal_terrain.py`` and ``cfg/task/AnymalTerrain.yaml``), on the
Anymal morphology of ``tasks/anymal.py``.

- terrain: ``engine/terrain.TerrainGrid``, 10 levels x 20 types of 8 x 8 m
  tiles (rows = difficulty); the heightfield is the physics ground
  (``ground_height_fn``), which the fused CUDA kernel samples itself
- control step: dt 0.02 s of 4 substeps, i.e. the YAML's physics dt 0.005 x
  ``decimation`` 4; PD Kp 80 Kd 2, action_scale 0.5, torque clip 80 Nm
- obs (188): [lin_vel*2, ang_vel*0.25, projected_gravity,
  commands*(2, 2, 0.25), dof_pos_scaled, dof_vel*0.05, height scan (140,
  clip(base_z - 0.5 - h, -1, 1) * 5), actions]
- height scan: 14 x 10 points, x in +-0.8, y in +-0.5 without the centre
  line, yaw-rotated, one plain bilinear gather (``Heightfield.height_fn``)
- 13-term reward with the YAML scales (x dt), clipped >= 0 before the
  termination term; feet air time
- curriculum: at an episode's end the env's level goes up when it walked
  past half a tile, down when it covered less than a quarter of its
  commanded distance
- pushes every 15 s: a one-control-step base wrench m dv / dt, dv ~ U(-1, 1)
  in x and y from an EnvRandom stream (salt 311) keyed on the global step
- spawn at env_origins[level, type] + U(-0.5, 0.5) in x and y; commands
  zeroed when |cmd_xy| < 0.25; done on base contact (knee contacts are
  allowed and cost reward)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.engine.env import EnvRandom
from thormang_isaacgym_tpu_torch.engine.terrain import TerrainGrid
from thormang_isaacgym_tpu_torch.tasks.anymal import _LEGS, Anymal


@dataclasses.dataclass(frozen=True)
class AnymalTerrainTaskState:
    commands: torch.Tensor       # (B, 3)
    actions: torch.Tensor        # (B, 12)
    last_actions: torch.Tensor   # (B, 12)
    last_dof_vel: torch.Tensor   # (B, 12)
    feet_air_time: torch.Tensor  # (B, 4)
    terrain_level: torch.Tensor  # (B,) int32
    terrain_type: torch.Tensor   # (B,) int32
    origin: torch.Tensor         # (B, 3) spawn point on the grid


class AnymalTerrain(Anymal):
    num_obs = 188
    clip_obs = 5.0
    # physics steps per control step (AnymalTerrain.yaml control.decimation)
    decimation = 4

    # control (AnymalTerrain.yaml)
    Kp = 80.0
    Kd = 2.0
    action_scale = 0.5
    # reward scales (AnymalTerrain.yaml learn block)
    rew_scales = dict(
        termination=0.0, lin_vel_xy=1.0, lin_vel_z=-4.0, ang_vel_xy=-0.05,
        ang_vel_z=0.5, orient=-0.0, torque=-0.00002, joint_acc=-0.0005,
        base_height=-0.0, air_time=1.0, collision=-0.25, stumble=-0.0,
        action_rate=-0.01, hip=-0.0,
    )
    lin_vel_scale = 2.0
    ang_vel_scale = 0.25
    dof_pos_scale = 1.0
    dof_vel_scale = 0.05
    height_meas_scale = 5.0
    command_x_range = (-1.0, 1.0)
    command_y_range = (-1.0, 1.0)
    command_yaw_range = (-3.14, 3.14)
    episode_length_s = 20.0
    push_interval_s = 15.0
    allow_knee_contacts = True
    tile_length = 8.0

    def __init__(self, num_envs: int = 4096, seed: int = 42, device=None,
                 curriculum: bool = True, num_levels: int = 10, num_types: int = 20, **kw):
        super().__init__(num_envs, seed, device, **kw)
        dev = self.device
        self.curriculum = curriculum
        self.sim_params = dataclasses.replace(self.sim_params, dt=0.02, substeps=4)
        self.grid = TerrainGrid(num_levels=num_levels, num_types=num_types, cells=80,
                                horizontal_scale=0.1, vertical_scale=1.0, seed=seed)
        self.num_levels = num_levels
        self.num_types = num_types
        self.field = self.grid.field.to(dev)
        self.env_origins = torch.as_tensor(self.grid.env_origins, device=dev)  # (L, T, 3)
        self._height_fn = self.field.height_fn()

        # height-scan grid (the reference's init_height_points)
        ys = 0.1 * np.array([-5, -4, -3, -2, -1, 1, 2, 3, 4, 5], np.float32)
        xs = 0.1 * np.array([-8, -7, -6, -5, -4, -3, -2, 2, 3, 4, 5, 6, 7, 8], np.float32)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        self._scan_x = torch.as_tensor(gx.ravel(), device=dev)[None]    # (1, 140)
        self._scan_y = torch.as_tensor(gy.ravel(), device=dev)[None]

        m = self.model
        self.feet = [m.body_id(f"{n}_SHANK") for n, _, _ in _LEGS]
        self.hips_dofs = [m.dof_id(f"{n}_HAA") for n, _, _ in _LEGS]
        self._feet_idx = torch.tensor(self.feet, device=dev)
        self._hips_idx = torch.tensor(self.hips_dofs, device=dev)
        self._cmd_scale = torch.tensor([self.lin_vel_scale, self.lin_vel_scale,
                                        self.ang_vel_scale], device=dev)
        self._quat0 = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self.set_dt(self.sim_params.dt)

    def set_dt(self, dt: float) -> None:
        super().set_dt(dt)
        self.push_interval = int(self.push_interval_s / dt + 0.5)

    def ground_height_fn(self):
        """The physics ground: the terrain's Heightfield, on the task's device."""
        return self.field

    # ------------------------------------------------------------------
    def default_task_state(self):
        B, dev = self.num_envs, self.device
        z12 = torch.zeros(B, 12, device=dev)
        return AnymalTerrainTaskState(
            commands=torch.zeros(B, 3, device=dev), actions=z12, last_actions=z12,
            last_dof_vel=z12, feet_air_time=torch.zeros(B, 4, device=dev),
            # every env starts on level 0; terrain types round-robin
            terrain_level=torch.zeros(B, dtype=torch.int32, device=dev),
            terrain_type=torch.arange(B, dtype=torch.int32, device=dev) % self.num_types,
            origin=torch.zeros(B, 3, device=dev))

    def reset_fn(self, rng, params, task):
        B = task.actions.shape[0]
        jq, qd = self._reset_joints(rng, B)
        origin = self.env_origins[task.terrain_level.long(), task.terrain_type.long()]
        xy = origin[:, 0:2] + rng.uniform(2, -0.5, 0.5)
        pos = torch.cat([xy, origin[:, 2:3] + self.base_init_z], dim=-1)
        q = torch.cat([pos, self._quat0.expand(B, 4), jq], dim=-1)
        cmd = self._uniform3(rng, (self.command_x_range, self.command_y_range,
                                   self.command_yaw_range))
        cmd = cmd * (torch.linalg.norm(cmd[:, :2], dim=1, keepdim=True) > 0.25)
        z12 = torch.zeros_like(task.actions)
        task = dataclasses.replace(
            task, commands=cmd, actions=z12, last_actions=z12, last_dof_vel=z12,
            feet_air_time=torch.zeros_like(task.feet_air_time), origin=pos)
        return q, qd, params, task

    # ------------------------------------------------------------------
    def pre_physics(self, state, actions):
        ctrl, wrench, task = super().pre_physics(state, actions)
        t = state.task
        # the reference sets the root velocity; the same impulse here is a
        # one-control-step base wrench F = m dv / dt
        push_now = (state.progress % self.push_interval) == (self.push_interval - 1)
        dv = EnvRandom.of_step(state, 311).uniform(2, -1.0, 1.0)
        base_mass = state.params.body_mass[:, 0]
        wrench[:, 0, 3:5] += base_mass[:, None] * dv / self.dt * push_now[:, None]
        task = dataclasses.replace(task, last_actions=t.actions, last_dof_vel=state.qd[:, 6:])
        return ctrl, wrench, task

    def _height_scan(self, state):
        """Terrain heights at the 140 scan points around the base, rotated by
        its yaw alone: for the quat (w, 0, 0, z) the plane rotation with
        cos = (w^2 - z^2) / (w^2 + z^2), sin = 2 w z / (w^2 + z^2)."""
        w, z = state.q[:, 3], state.q[:, 6]
        n2 = w * w + z * z + 1e-9
        c = ((w * w - z * z) / n2)[:, None]
        s = (2.0 * w * z / n2)[:, None]
        x = state.q[:, 0:1] + c * self._scan_x - s * self._scan_y
        y = state.q[:, 1:2] + s * self._scan_x + c * self._scan_y
        return self._height_fn(x, y)                       # (B, 140)

    def post_physics(self, state, prev_task):
        t = prev_task
        base_lin_vel, base_ang_vel, projected_gravity = self._base_frame(state)
        jq = state.q[:, 7:]
        jqd = state.qd[:, 6:]
        torques = self._torques(state, t)
        rs = {k: v * self.dt for k, v in self.rew_scales.items()}

        heights = self._height_scan(state)
        rel_heights = torch.clamp(state.q[:, 2:3] - 0.5 - heights, -1.0, 1.0) \
            * self.height_meas_scale
        obs = torch.cat([
            base_lin_vel * self.lin_vel_scale,
            base_ang_vel * self.ang_vel_scale,
            projected_gravity,
            t.commands * self._cmd_scale,
            (jq - self.default_dof_pos) * self.dof_pos_scale,
            jqd * self.dof_vel_scale,
            rel_heights,
            t.actions,
        ], dim=-1)

        # ---- 13-term reward ----
        lin_vel_err = torch.sum((t.commands[:, :2] - base_lin_vel[:, :2]) ** 2, dim=1)
        ang_vel_err = (t.commands[:, 2] - base_ang_vel[:, 2]) ** 2
        r = {}
        r["lin_vel_xy"] = torch.exp(-lin_vel_err / 0.25) * rs["lin_vel_xy"]
        r["ang_vel_z"] = torch.exp(-ang_vel_err / 0.25) * rs["ang_vel_z"]
        r["lin_vel_z"] = base_lin_vel[:, 2] ** 2 * rs["lin_vel_z"]
        r["ang_vel_xy"] = torch.sum(base_ang_vel[:, :2] ** 2, dim=1) * rs["ang_vel_xy"]
        r["orient"] = torch.sum(projected_gravity[:, :2] ** 2, dim=1) * rs["orient"]
        r["base_height"] = (state.q[:, 2] - 0.52) ** 2 * rs["base_height"]
        r["torque"] = torch.sum(torques ** 2, dim=1) * rs["torque"]
        r["joint_acc"] = torch.sum((t.last_dof_vel - jqd) ** 2, dim=1) * rs["joint_acc"]
        knee_contact = torch.linalg.norm(state.net_contact[:, self._knees_idx], dim=-1) > 1.0
        r["collision"] = torch.sum(knee_contact, dim=1) * rs["collision"]
        feet_f = state.net_contact[:, self._feet_idx]
        stumble = (torch.linalg.norm(feet_f[..., :2], dim=-1) > 5.0) \
            & (torch.abs(feet_f[..., 2]) < 1.0)
        r["stumble"] = torch.sum(stumble, dim=1) * rs["stumble"]
        r["action_rate"] = torch.sum((t.last_actions - t.actions) ** 2, dim=1) * rs["action_rate"]

        contact = feet_f[..., 2] > 1.0
        air = t.feet_air_time
        first_contact = (air > 0.0) & contact
        air = air + self.dt
        r_air = torch.sum((air - 0.5) * first_contact, dim=1) * rs["air_time"]
        r["air_time"] = r_air * (torch.linalg.norm(t.commands[:, :2], dim=1) > 0.1)
        air = air * (~contact)

        r["hip"] = torch.sum(torch.abs(jq[:, self._hips_idx]
                                       - self.default_dof_pos[self._hips_idx]), dim=1) * rs["hip"]

        reward = torch.clamp(sum(r.values()), min=0.0)

        done = torch.linalg.norm(state.net_contact[:, self.base_index], dim=-1) > 1.0
        if not self.allow_knee_contacts:
            done = done | torch.any(knee_contact, dim=1)
        reward = reward + rs["termination"] * done

        # ---- curriculum: promotion / demotion where the episode ends ----
        dist = torch.linalg.norm(state.q[:, :2] - t.origin[:, :2], dim=1)
        timeout = state.progress >= self.max_episode_length - 1
        finishing = done | timeout
        demote = dist < torch.linalg.norm(t.commands[:, :2], dim=1) * self.episode_length_s * 0.25
        promote = dist > self.tile_length / 2
        delta = promote.to(torch.int32) - demote.to(torch.int32)
        new_level = t.terrain_level
        if self.curriculum:
            new_level = torch.clamp(t.terrain_level + torch.where(finishing, delta, 0),
                                    0, self.num_levels - 1).to(torch.int32)
        task = dataclasses.replace(t, feet_air_time=air, terrain_level=new_level)

        metrics = dict(state.metrics)
        for k in ("lin_vel_xy", "ang_vel_z", "air_time", "collision"):
            metrics["rew_" + k] = r[k]
        metrics["terrain_level"] = t.terrain_level.to(torch.float32)
        return obs, reward, done.to(torch.float32), task, metrics
