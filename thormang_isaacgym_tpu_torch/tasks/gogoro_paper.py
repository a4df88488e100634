"""Gogoro paper variant: direct steering with actuation delay, pushes, and a
20-frame observation window. Port of ``thormang_isaacgym_tpu/tasks/gogoro_paper.py``
(the reference's ``tasks/gogoro_realistic_turning_sim_paper.py`` and
``cfg/task/Gogoro_paper.yaml``), on the scooter model of ``tasks/gogoro.py``.

- direct steering: command = 0.5 a; a 5-slot command ring, the applied
  command history[-delay] with delay U{0..4} per env (the reference's
  ``-delay`` indexing makes delay 0 the oldest slot, reproduced)
- observation: 20 frames of 8 channels [roll, yaw, d_roll, d_yaw, speed,
  delta_yaw, command, delay / 5], noisy and normalised (/pi, /3, /5, /pi,
  /0.5), the command difference fed into the d_roll and roll channels, the
  yaw channel zeroed: 160
- pushes every 10 steps on the first half of the envs: U(-30, 30) N across
  the heading and -U(0, 30) N down on ``head_p_link``
- reward: 0.45 (1 - yaw_err^2) + 0.1 (1 - tilt_err^2) + 0.35 (1 -
  dtilt_err^2) + 2 (1 - a^2 gated near upright) + 0.2 (1 - mean(diff(a)^2)),
  clipped at 0; |roll| >= 0.38 falls: -1 and reset
- speed command U(5, 20), resampled at step 300; 3600-step episodes

Random draws: the reset's on the episode, the pushes (salt 603), the frame
noise (604) and the resampling (605) on the global step; the tests feed
JAX's draws through ``reset_draws``, ``push_draws``, ``frame_noise`` and
``resample``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom
from thormang_isaacgym_tpu_torch.tasks.gogoro import Gogoro, uniform_draws

# cfg/task/Gogoro_paper.yaml noises block
PAPER_NOISES = dict(
    imu_filter_noise=(-0.003, 0.003), imu_noise=(-0.003, 0.003),
    speed_sensor_offset=(-0.3, 0.3), speed_sensor_noise=(0.0, 0.3),
    seat_offset_x_range=(-0.1, 0.1), seat_offset_y_range=(-0.1, 0.1),
    seat_offset_z_range=(-0.05, 0.05), imu_x_offset=(-0.02, 0.02),
    spawn_x_angle=(-0.02, 0.02), steering_action_noise=(-0.05, 0.05),
    steering_offset=(-0.05, 0.05), steering_damping_range=(50, 1000),
    speed_range=(5.0, 20.0), speed_freq_update=300, yaw_freq_update=300,
)
DELAY_W = 5            # command_delay: [0, 5]
BUFF = 20              # buff_size
NUM_CH = 8
MAX_TILT = 0.38
SALT_PUSH = 603
SALT_FRAME = 604
SALT_RESAMPLE = 605


@dataclasses.dataclass(frozen=True)
class GogoroPaperTaskState:
    speed_cmd: torch.Tensor        # (B,)
    yaw_cmd: torch.Tensor          # (B,)
    command_history: torch.Tensor  # (B, 5) steering-command ring
    steer_delay: torch.Tensor      # (B,) int32 in [0, 5)
    obs_clean: torch.Tensor        # (B, 20, 8) raw frame window
    obs_noisy: torch.Tensor        # (B, 20, 8) normalised noisy window
    imu_x_offset: torch.Tensor     # (B,)
    speed_offset: torch.Tensor     # (B,)
    cur_command: torch.Tensor      # (B,) this step's raw command


class GogoroPaper(Gogoro):
    num_obs = BUFF * NUM_CH
    num_actions = 1
    max_episode_length = 3600      # Gogoro_paper.yaml max_steps
    push_force = 30.0
    resample_salt = SALT_RESAMPLE

    def __init__(self, num_envs: int = 4096, seed: int = 42, **kw):
        super().__init__(num_envs, seed, **kw)
        self.head_body = self.model.body_id("head_p_link")

    # ------------------------------------------------------------------
    def default_task_state(self) -> GogoroPaperTaskState:
        B, dev = self.num_envs, self.device
        z = torch.zeros(B, device=dev)
        win = torch.zeros(B, BUFF, NUM_CH, device=dev)
        return GogoroPaperTaskState(z + 8.0, z, torch.zeros(B, DELAY_W, device=dev),
                                    torch.zeros(B, dtype=torch.int32, device=dev), win, win,
                                    z, z, z)

    def reset_draws(self, rng: EnvRandom) -> dict:
        n = PAPER_NOISES
        d = uniform_draws(rng, dict(
            speed_cmd=(*n["speed_range"], ()), yaw_target=(-math.pi, math.pi, ()),
            yaw_off=(-1.57, 1.57, ()), delay=(0.0, float(DELAY_W), ()),
            imu_x=(*n["imu_x_offset"], ()), speed_offset=(*n["speed_sensor_offset"], ()),
            damp=(*n["steering_damping_range"], ()), spawn_roll=(*n["spawn_x_angle"], ())))
        d["delay"] = torch.clamp(torch.floor(d["delay"]), max=DELAY_W - 1).to(torch.int32)
        return d

    def reset_from(self, d: dict, params):
        B = d["speed_cmd"].shape[0]
        dev = d["speed_cmd"].device
        damping = params.drive_damping.clone()
        damping[:, self.sid] = d["damp"]
        params = dataclasses.replace(params, drive_damping=damping)
        root_pos = torch.tensor([0.0, 0.0, 0.03], device=dev).expand(B, 3)
        root_quat = Q.from_euler_xyz(d["spawn_roll"], torch.zeros(B, device=dev),
                                     d["yaw_target"] + d["yaw_off"])
        q = torch.cat([root_pos, root_quat, self._init_joint_q.expand(B, -1)], -1)
        qd = torch.zeros(B, self.model.nv, device=dev)
        win = torch.zeros(B, BUFF, NUM_CH, device=dev)
        t = GogoroPaperTaskState(
            speed_cmd=d["speed_cmd"], yaw_cmd=d["yaw_target"],
            command_history=torch.zeros(B, DELAY_W, device=dev), steer_delay=d["delay"],
            obs_clean=win, obs_noisy=win, imu_x_offset=d["imu_x"],
            speed_offset=d["speed_offset"], cur_command=torch.zeros(B, device=dev))
        return q, qd, params, t

    # ------------------------------------------------------------------
    def push_draws(self, state) -> dict:
        """This step's push forces: across the heading U(-30, 30) N, down
        -U(0, 30) N; (B,) each."""
        u = EnvRandom.of_step(state, SALT_PUSH).uniform(2)
        return dict(x=-self.push_force + 2.0 * self.push_force * u[:, 0],
                    z=-u[:, 1] * self.push_force)

    def pre_physics(self, state, actions):
        B, dev = actions.shape[0], actions.device
        t = state.task
        command = torch.clamp(actions[:, 0], -1.0, 1.0) * self.max_steering   # direct
        history = torch.cat([t.command_history[:, 1:], command[:, None]], 1)
        # applied = history[-delay] (-0 indexes the oldest slot)
        idx = (DELAY_W - t.steer_delay.to(torch.int64)) % DELAY_W
        applied = torch.gather(history, 1, idx[:, None])[:, 0]
        ctrl = self._targets(B, dev, applied, t.speed_cmd)
        # pushes: every 10 steps, the first half of the envs
        p = self.push_draws(state)
        yaw = t.obs_clean[:, -1, 1]
        need = ((state.progress + 1) % 10 == 0) & (torch.arange(B, device=dev) < B // 2)
        f = torch.stack([p["x"] * torch.cos(yaw + math.pi / 2),
                         p["x"] * torch.sin(yaw + math.pi / 2), p["z"]], -1) * need[:, None]
        wrench = torch.zeros(B, self.model.nb, 6, device=dev)
        wrench[:, self.head_body, 0:3] = f
        return ctrl, wrench, dataclasses.replace(t, command_history=history, cur_command=command)

    # ------------------------------------------------------------------
    def frame_noise(self, state) -> dict:
        """This step's frame noise: imu_filter (B, 2), imu (B, 2), speed (B,),
        delta_yaw (B,)."""
        n = PAPER_NOISES
        return uniform_draws(EnvRandom.of_step(state, SALT_FRAME), dict(
            imu_filter=(*n["imu_filter_noise"], (2,)), imu=(*n["imu_noise"], (2,)),
            speed=(*n["speed_sensor_noise"], ()), delta_yaw=(*n["imu_filter_noise"], ())))

    def post_physics(self, state, prev_task):
        t = prev_task
        B = state.q.shape[0]
        roll, _, yaw, d_roll, d_yaw, speed, delta_yaw = self._scooter_state(state, t.yaw_cmd)
        delay_n = t.steer_delay.to(torch.float32) / DELAY_W
        frame = torch.stack([roll, yaw, d_roll, d_yaw, speed, delta_yaw, t.cur_command, delay_n],
                            -1)
        obs_clean = torch.cat([t.obs_clean[:, 1:], frame[:, None]], 1)
        # the noisy, normalised frame
        z = self.frame_noise(state)
        nf = frame.clone()
        nf[:, 0:2] += z["imu_filter"]
        nf[:, 0] += t.imu_x_offset
        nf[:, 2:4] += z["imu"]
        nf[:, 4] = torch.clamp(nf[:, 4] + z["speed"] + t.speed_offset, min=0.0)
        nf[:, 5] += z["delta_yaw"]
        nf = nf / nf.new_tensor([math.pi, math.pi, 3.0, 3.0, 5.0, math.pi, self.max_steering, 1.0])
        # the noise-removal trick: command differences into d_roll and roll
        cmd_diff = obs_clean[:, -2, 6] - obs_clean[:, -1, 6]
        nf[:, 2] += cmd_diff
        nf[:, 0] += cmd_diff * 0.3
        obs_noisy = torch.cat([t.obs_noisy[:, 1:], nf[:, None]], 1)
        obs_noisy[:, :, 1] = 0.0                      # yaw zeroed
        obs = obs_noisy.reshape(B, BUFF * NUM_CH)

        act_buff = obs_clean[:, :, 6] / self.max_steering
        tilt_err = torch.clamp(roll / MAX_TILT, -1.0, 1.0)
        yaw_err = torch.clamp(delta_yaw / math.pi, -1.0, 1.0)
        dtilt_err = torch.clamp(d_roll / 0.3, -1.0, 1.0)
        r1 = 1.0 - yaw_err ** 2
        r2 = 1.0 - tilt_err ** 2
        r4 = 1.0 - dtilt_err ** 2
        tilt_w = 1.0 - torch.tanh(50.0 * tilt_err ** 2)
        dtilt_w = 1.0 - torch.tanh(50.0 * dtilt_err ** 2)
        r5 = 1.0 - (act_buff[:, -1] ** 2) * (tilt_w * dtilt_w)
        r7 = 1.0 - torch.mean(torch.diff(act_buff, dim=1) ** 2, 1)
        reward = torch.clamp(r1 * 0.45 + r2 * 0.1 + r4 * 0.35 + r5 * 2.0 + r7 * 0.2, min=0.0)
        felt = torch.abs(roll) >= MAX_TILT
        reward = torch.where(felt, torch.full_like(reward, -1.0), reward)

        n = PAPER_NOISES
        new_speed, new_yaw = self.resample(state, *n["speed_range"])
        task = dataclasses.replace(
            t, obs_clean=obs_clean, obs_noisy=obs_noisy,
            speed_cmd=torch.where(state.progress == n["speed_freq_update"], new_speed,
                                  t.speed_cmd),
            yaw_cmd=torch.where(state.progress == n["yaw_freq_update"], new_yaw, t.yaw_cmd))
        metrics = dict(state.metrics)
        metrics["roll_abs"] = torch.abs(roll)
        metrics["yaw_err_abs"] = torch.abs(delta_yaw)
        metrics["speed"] = speed
        return obs, reward, felt.to(torch.float32), task, metrics

    def observation_noise(self, rng: EnvRandom, obs: torch.Tensor, task_state):
        """The noise goes into each frame in post_physics (the window keeps
        each frame's draw): none on the output."""
        return obs
