"""Gogoro scooter balance and heading task. Port of
``thormang_isaacgym_tpu/tasks/gogoro.py`` (the reference's
``tasks/gogoro_new.py``, registered as "Gogoro", and ``cfg/task/Gogoro.yaml``).

- asset: the reference's ``scooter_V13.urdf``, which the repository does
  not hold yet: looked for under ``assets/urdf/gogoro/urdf/``
  (``REF_SCOOTER``) unless ``asset_path=`` names it; a missing file raises
  FileNotFoundError naming the path. The wheels' meshes become cylinders
  of r 0.2 m, half-width 0.045 m (``WHEEL_OVERRIDE``).
- the 31 THORMANG joints of ``JOINTS_POS`` and the seat prismatics base_x,
  base_y, base_z are locked (``dof_locked``); the seat offsets are per-env
  locked positions N(0, 0.02) drawn at reset
- rear wheel: velocity servo, damping 1000, effort 170; steering: position
  drive Kp 3000, Kd per env U(100, 1000) at reset, effort 100, velocity
  limit 200 rad/s; wheel friction rear 0.98, front 0.9, ground 0.99
- incremental steering: cmd += clip(0.2 a, +/-0.2), cmd in [-0.5, 0.5], plus
  the steering offset and N(0, 0.03) action noise
- obs (6): roll, d_roll, d_yaw, speed, delta_yaw, last command; the sensor
  noise and offsets in ``observation_noise`` (the speed channel clamped to
  [0, 5] and rounded; ``reproduce_ref_obs_bug=True`` writes round(delta_yaw)
  there, as the reference's indexing slip does)
- reward: 5 / (1 + (30 yaw_err)^2) + 0.2 (1 - tilt_err^2) + 0.3 (1 -
  dtilt_err^2) + 0.5 sum(1 - a^2) over the 5-action history; |roll| >= 0.3
  falls: -100 and reset
- commands: wheel speed U(4, 13) rad/s and heading U(-pi, pi), resampled at
  step 300; spawn at z 0.03 with yaw = heading + U(-1.57, 1.57)
- ``randomize=True`` sets the YAML's DR block: gravity and the actor's mass
  scaled by U(0.95, 1.05) every 600 steps

Random draws are the port's per-env EnvRandom streams (the reset's on the
episode; the action noise, salt 601, and the command resampling, salt 602,
on the global step; the observation noise on the env's hook stream, salt
43), not the JAX package's threefry draws; the tests feed JAX's draws
through ``reset_draws``, ``steer_noise``, ``resample`` and
``obs_noise_draws``.
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
from thormang_isaacgym_tpu_torch.models.robot import DRIVE_POS, DRIVE_VEL
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams
from thormang_isaacgym_tpu_torch.tasks.common import normal

GOGORO_ASSETS = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                                              "urdf", "gogoro", "urdf"))
REF_SCOOTER = os.path.join(GOGORO_ASSETS, "scooter_V13.urdf")

# THORMANG riding pose (cfg/task/Gogoro.yaml:61-93)
JOINTS_POS = {
    "l_arm_el_y": 0.0, "l_arm_wr_r": 0.0, "head_y": 0.0, "r_arm_grip": 0.0,
    "l_arm_wr_p": 0.0, "torso_y": 0.0, "r_arm_sh_r": -1.57, "l_arm_sh_p1": 0.0,
    "l_arm_sh_r": 1.57, "l_leg_an_r": 0.0, "l_leg_an_p": 0.0, "r_leg_hip_p": 1.4,
    "r_leg_an_p": 0.0, "l_arm_wr_y": 0.0, "l_leg_hip_p": -1.4, "r_leg_hip_y": 0.0,
    "l_leg_hip_r": 0.0, "l_leg_kn_p": 1.4, "r_arm_sh_p2": 0.0, "r_arm_sh_p1": 0.0,
    "l_leg_hip_y": 0.0, "r_leg_hip_r": 0.0, "l_arm_sh_p2": 0.0, "r_arm_wr_y": 0.0,
    "head_p": 0.0, "r_arm_wr_p": 0.0, "r_arm_wr_r": 0.0, "r_arm_el_y": 0.0,
    "l_arm_grip": 0.0, "r_leg_an_r": 0.0, "r_leg_kn_p": -1.4,
}

# noise / command tables (cfg/task/Gogoro.yaml:34-58)
NOISES = dict(
    seat_offset_x_range=(0, 0.02), seat_offset_y_range=(0, 0.02),
    seat_offset_z_range=(0, 0.02), steering_offset=(0, 0.01),
    imu_filter_noise=(0, 0.001), imu_noise=(0, 0.001),
    seat_offset_xr_range=(0, 0.05), speed_sensor_offset=(-0.5, 0.5),
    speed_sensor_noise=(0, 0.3), steering_action_noise=(0, 0.03),
    spawn_x_angle=(0, 0.05), steering_damping_range=(100, 1000),
    speed_range=(4.0, 13.0), speed_freq_update=300, yaw_freq_update=300,
)

# the wheel mesh as a disk r 0.2, half-width 0.045 (wheel_V3.obj); the URDF's
# collision origin rpy (1.5708, 0, 0) already maps the mesh's z onto the
# link's y spin axis
WHEEL_OVERRIDE = {
    "type": "cylinder", "size": (0.2, 0.045),
    "pos": (0, 0, 0), "quat": (1.0, 0.0, 0.0, 0.0),
}

SALT_STEER_NOISE = 601
SALT_RESAMPLE = 602


def asset_or_raise(path: str, what: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(f"{what} asset not found at {path}; pass asset_path=")
    return path


def wheel_friction(model) -> np.ndarray:
    """Per-geom friction: rear wheel 0.98, front 0.9, else 1."""
    gf = np.ones(model.ng, np.float32)
    for gi, g in enumerate(model.geoms):
        if g.body == model.body_id("back"):
            gf[gi] = 0.98
        elif g.body == model.body_id("front"):
            gf[gi] = 0.9
    return gf


def _build_model(asset_path: str | None = None):
    path = asset_or_raise(asset_path or REF_SCOOTER, "gogoro")
    model = load_urdf(path, mesh_overrides={"front": WHEEL_OVERRIDE, "back": WHEEL_OVERRIDE},
                      armature=1e-4)       # asset_options.armature (gogoro_new.py:210)
    d = model._defaults
    nj = model.nj
    sid = model.dof_id("steering_joint")
    rid = model.dof_id("rear_wheel_joint")
    # the THORMANG pose and the seat offsets locked (per-env offsets at reset)
    locked = np.zeros(nj, np.float32)
    locked_pos = np.zeros(nj, np.float32)
    for jn, pos in JOINTS_POS.items():
        i = model.dof_id(jn)
        locked[i] = 1.0
        locked_pos[i] = pos
    for jn in ("base_x", "base_y", "base_z"):
        locked[model.dof_id(jn)] = 1.0
    d["dof_locked"] = locked
    d["dof_locked_pos"] = locked_pos
    mode = np.zeros(nj, np.int32)
    kp = np.zeros(nj, np.float32)
    kd = np.zeros(nj, np.float32)
    eff = np.zeros(nj, np.float32)
    # steering: the drive after the first reset (gogoro_new.py:595-601)
    mode[sid], kp[sid], kd[sid], eff[sid] = DRIVE_POS, 3000.0, 200.0, 100.0
    # rear wheel velocity servo (gogoro_new.py:266-269)
    mode[rid], kd[rid], eff[rid] = DRIVE_VEL, 1000.0, 170.0
    d["drive_mode"] = mode
    d["drive_stiffness"] = kp
    d["drive_damping"] = kd
    d["drive_effort_limit"] = eff
    vl = np.array(d["dof_velocity_limit"], np.float32)
    vl[sid] = 200.0
    d["dof_velocity_limit"] = vl
    d["geom_friction"] = wheel_friction(model)
    return model


@dataclasses.dataclass(frozen=True)
class GogoroTaskState:
    steer_cmd: torch.Tensor       # (B,) integrated steering command
    speed_cmd: torch.Tensor       # (B,) rear wheel speed command (rad/s)
    yaw_cmd: torch.Tensor         # (B,) target heading
    action_history: torch.Tensor  # (B, 5)
    imu_offset: torch.Tensor      # (B,)
    steer_offset: torch.Tensor    # (B,)
    speed_offset: torch.Tensor    # (B,)


def uniform_draws(rng: EnvRandom, specs: dict) -> dict:
    """{name: (B, *shape) draws} of U(lo, hi) for each ``name: (lo, hi, shape)``."""
    out = {}
    for name, (lo, hi, shape) in specs.items():
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = rng.uniform(n, lo, hi).reshape((-1,) + tuple(shape))
    return out


def normal_draws(rng: EnvRandom, specs: dict) -> dict:
    """{name: (B,) draws} of N(mean, std) for each ``name: (mean, std)``."""
    z = normal(rng.uniform(2 * ((len(specs) + 1) // 2)))
    return {name: mean + std * z[:, i] for i, (name, (mean, std)) in enumerate(specs.items())}


class Gogoro(Task):
    """Scooter balance and heading tracking, PPO, 1 action."""

    num_obs = 6
    num_actions = 1
    max_episode_length = 1000
    max_steering = 0.5           # gogoro_new.py:86
    max_steering_change = 0.2    # gogoro_new.py:87
    resample_salt = SALT_RESAMPLE

    def __init__(self, num_envs: int = 4096, seed: int = 42, asset_path: str | None = None,
                 reproduce_ref_obs_bug: bool = False, randomize: bool = False, device=None,
                 **_):
        super().__init__(num_envs, seed, device)
        self.model = _build_model(asset_path)
        self.reproduce_ref_obs_bug = reproduce_ref_obs_bug
        if randomize:
            # cfg/task/Gogoro.yaml:95-113 randomization_params
            self.dr_config = {
                "frequency": 600,
                "sim_params": {"gravity": {"range": [0.95, 1.05], "operation": "scaling",
                                           "distribution": "uniform"}},
                "actor_params": {"Gogoro": {"rigid_body_properties": {"mass": {
                    "range": [0.95, 1.05], "operation": "scaling",
                    "distribution": "uniform"}}}},
            }
        self.sim_params = SimParams(
            dt=0.03, substeps=6,   # the reference's 3 PhysX substeps; penalty contact needs 5 ms
            gravity=(0.0, 0.0, -9.81), contact_stiffness=4.0e4, contact_damping=2.0e3,
            friction_vel=0.1, plane_friction=0.99,
            root_linear_damping=0.01,   # asset_options.linear_damping (gogoro_new.py:209)
            max_velocity=200.0)
        self.dt = self.sim_params.dt
        m = self.model
        self.sid = m.dof_id("steering_joint")
        self.rid = m.dof_id("rear_wheel_joint")
        self.base_dofs = tuple(m.dof_id(j) for j in ("base_x", "base_y", "base_z"))
        self._init_joint_q = torch.as_tensor(np.array(m._defaults["dof_locked_pos"], np.float32),
                                             device=self.device)

    # ------------------------------------------------------------------
    def default_task_state(self) -> GogoroTaskState:
        z = torch.zeros(self.num_envs, device=self.device)
        return GogoroTaskState(z, z + 8.0, z, torch.zeros(self.num_envs, 5, device=self.device),
                               z, z, z)

    def reset_draws(self, rng: EnvRandom) -> dict:
        """The reset's random values, (B,) each (``seat`` (B, 3))."""
        n = NOISES
        out = uniform_draws(rng, dict(
            speed_cmd=(*n["speed_range"], ()), yaw_target=(-math.pi, math.pi, ()),
            yaw_off=(-1.57, 1.57, ()), speed_offset=(*n["speed_sensor_offset"], ()),
            damp=(*n["steering_damping_range"], ())))
        out.update(normal_draws(rng, dict(
            steer_offset=n["steering_offset"], imu_offset=n["seat_offset_xr_range"],
            seat_x=n["seat_offset_x_range"], seat_y=n["seat_offset_y_range"],
            seat_z=n["seat_offset_z_range"])))
        out["seat"] = torch.stack([out.pop(k) for k in ("seat_x", "seat_y", "seat_z")], -1)
        return out

    def reset_fn(self, rng: EnvRandom, params, task):
        return self.reset_from(self.reset_draws(rng), params)

    def reset_from(self, d: dict, params):
        """reset_idx (gogoro_new.py:505-591): commands and offsets, the
        per-env steering damping and seat offsets, the spawn pose."""
        B = d["speed_cmd"].shape[0]
        dev = d["speed_cmd"].device
        damping = params.drive_damping.clone()
        damping[:, self.sid] = d["damp"]
        locked_pos = params.dof_locked_pos.clone()
        joint_q = self._init_joint_q.expand(B, -1).clone()
        for k, dof in enumerate(self.base_dofs):
            locked_pos[:, dof] = d["seat"][:, k]
            joint_q[:, dof] = d["seat"][:, k]
        params = dataclasses.replace(params, drive_damping=damping, dof_locked_pos=locked_pos)
        zero = torch.zeros(B, device=dev)
        root_pos = torch.tensor([0.0, 0.0, 0.03], device=dev).expand(B, 3)
        root_quat = Q.from_euler_xyz(zero, zero, d["yaw_target"] + d["yaw_off"])
        q = torch.cat([root_pos, root_quat, joint_q], -1)
        qd = torch.zeros(B, self.model.nv, device=dev)
        task = GogoroTaskState(steer_cmd=zero, speed_cmd=d["speed_cmd"], yaw_cmd=d["yaw_target"],
                               action_history=torch.zeros(B, 5, device=dev),
                               imu_offset=d["imu_offset"], steer_offset=d["steer_offset"],
                               speed_offset=d["speed_offset"])
        return q, qd, params, task

    # ------------------------------------------------------------------
    def steer_noise(self, state) -> torch.Tensor:
        """(B,) steering action noise N(0, 0.03) of this step."""
        return normal_draws(EnvRandom.of_step(state, SALT_STEER_NOISE),
                            dict(n=NOISES["steering_action_noise"]))["n"]

    def _targets(self, B, dev, steer, speed):
        nj = self.model.nj
        target_pos = torch.zeros(B, nj, device=dev)
        target_pos[:, self.sid] = steer
        target_vel = torch.zeros(B, nj, device=dev)
        target_vel[:, self.rid] = speed
        return Controls(target_pos, target_vel, torch.zeros(B, nj, device=dev))

    def pre_physics(self, state, actions):
        """pre_physics_step (gogoro_new.py:347-369)."""
        B, dev = actions.shape[0], actions.device
        t = state.task
        a = actions[:, 0]
        history = torch.cat([t.action_history[:, 1:], a[:, None]], 1)
        delta = torch.clamp(a * self.max_steering_change, -self.max_steering_change,
                            self.max_steering_change)
        steer_cmd = torch.clamp(t.steer_cmd + delta, -self.max_steering, self.max_steering)
        ctrl = self._targets(B, dev, steer_cmd + t.steer_offset + self.steer_noise(state),
                             t.speed_cmd)
        wrench = torch.zeros(B, self.model.nb, 6, device=dev)
        return ctrl, wrench, dataclasses.replace(t, steer_cmd=steer_cmd, action_history=history)

    # ------------------------------------------------------------------
    def resample(self, state, lo: float, hi: float):
        """(B,) new speed commands U(lo, hi) and headings U(-pi, pi) of this step."""
        u = EnvRandom.of_step(state, self.resample_salt).uniform(2)
        return lo + (hi - lo) * u[:, 0], Q.wrap_to_pi(-math.pi + 2.0 * math.pi * u[:, 1])

    def _scooter_state(self, state, yaw_cmd):
        """(roll, pitch, yaw, d_roll, d_yaw, speed (body x), delta_yaw)."""
        root_quat = state.q[:, 3:7]
        roll, pitch, yaw = Q.to_euler_xyz(root_quat)
        omega_b = state.qd[:, 0:3]          # body frame
        v_b = Q.rotate_inv(root_quat, state.qd[:, 3:6])
        delta_yaw = Q.shortest_angle_distance(yaw, yaw_cmd)
        return roll, pitch, yaw, omega_b[:, 0], omega_b[:, 2], v_b[:, 0], delta_yaw

    def post_physics(self, state, prev_task):
        """post_physics_step and compute_obs_rwd (gogoro_new.py:373-462, 645-723)."""
        t = prev_task
        roll, _, _, d_roll, d_yaw, speed, delta_yaw = self._scooter_state(state, t.yaw_cmd)
        obs = torch.stack([roll, d_roll, d_yaw, speed, delta_yaw, t.steer_cmd], -1)
        tilt_err = torch.clamp(roll / 0.30, -1.0, 1.0)
        yaw_err = torch.clamp(delta_yaw / math.pi, -1.0, 1.0)
        dtilt_err = torch.clamp(d_roll / 0.3, -1.0, 1.0)
        r1 = 1.0 / (1.0 + (yaw_err * 30.0) ** 2)
        r2 = 1.0 - tilt_err ** 2
        r4 = 1.0 - dtilt_err ** 2
        command_energy = torch.sum(1.0 - t.action_history ** 2, -1)
        reward = r1 * 5.0 + r2 * 0.2 + r4 * 0.3 + command_energy * 0.5
        felt = torch.abs(roll) >= 0.30
        reward = torch.where(felt, torch.full_like(reward, -100.0), reward)
        # command resampling at fixed steps (gogoro_new.py:384-389)
        new_speed, new_yaw = self.resample(state, *NOISES["speed_range"])
        task = dataclasses.replace(
            t, speed_cmd=torch.where(state.progress == NOISES["speed_freq_update"], new_speed,
                                     t.speed_cmd),
            yaw_cmd=torch.where(state.progress == NOISES["yaw_freq_update"], new_yaw, t.yaw_cmd))
        metrics = dict(state.metrics)
        metrics["rew_yaw"] = r1 * 5.0
        metrics["rew_tilt"] = r2 * 0.2
        metrics["roll_abs"] = torch.abs(roll)
        metrics["speed"] = speed
        return obs, reward, felt.to(torch.float32), task, metrics

    # ------------------------------------------------------------------
    def obs_noise_draws(self, rng: EnvRandom) -> dict:
        """The sensor noise of one step: imu_filter, imu (2), speed, filter2 (B,) each."""
        n = NOISES
        return normal_draws(rng, dict(roll=n["imu_filter_noise"], d_roll=n["imu_noise"],
                                      d_yaw=n["imu_noise"], speed=n["speed_sensor_noise"],
                                      delta_yaw=n["imu_filter_noise"]))

    def observation_noise(self, rng: EnvRandom, obs: torch.Tensor, task_state):
        """Sensor noise and offsets (gogoro_new.py:449-461)."""
        d = self.obs_noise_draws(rng)
        t = task_state
        obs = obs.clone()
        obs[:, 0] += d["roll"] + t.imu_offset
        obs[:, 1] += d["d_roll"]
        obs[:, 2] += d["d_yaw"]
        if self.reproduce_ref_obs_bug:
            # gogoro_new.py:457-458 writes channel 3 from channel 4
            obs[:, 3] = torch.round(obs[:, 4])
        else:
            obs[:, 3] = torch.round(torch.clamp(obs[:, 3] + d["speed"] + t.speed_offset, 0.0, 5.0))
        obs[:, 4] += d["delta_yaw"]
        return obs
