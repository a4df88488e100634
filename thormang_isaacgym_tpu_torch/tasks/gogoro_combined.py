"""THORMANG3 riding the Gogoro, articulated: freewheel assists, a wheel
spin-up ramp, and damped-least-squares IK keeping both hands on the
handlebars. Port of ``thormang_isaacgym_tpu/tasks/gogoro_combined.py`` (the
reference's ``tasks/gogoro/gogoro.py``).

- asset: the reference's ``gogoro_and_thormang3_Light_freewheels.urdf``,
  which the repository does not hold yet: looked for beside the scooter's
  (``REF_COMBINED``) unless ``asset_path=`` names it; a missing file
  raises FileNotFoundError naming the path; the wheel meshes become
  cylinders r 0.2, half-width 0.05
- drives: every joint a position drive Kp 10000 / Kd 300 at the riding
  pose; rear wheel a velocity drive, damping 3; front wheel and the four
  freewheel DOFs free (friction 1e-4); steering Kp 1000 / Kd 100; base_x/y/z
  Kp 1e7 / Kd 10. The URDF's placeholder wheel masses and freewheel
  inertias are replaced by physical values (JAX's reasons, in its module).
- wheel spin-up ramp over the first 70 steps, then speed x 30 + 20
- five prismatic rider offsets (handles, base_x/y/z) U(-0.06, 0.06) per
  env, drawn at reset, as position targets
- hands on the handlebars (``use_ik``, on by default): per side the 6 x 7
  jacobian of the arm's DOFs at the hand site (``ops/inertia.point_jacobian``)
  and damped least squares (damping 0.3) toward the handle end, orientation
  rows zero; the deltas add onto the arm's current joint positions
- obs (8): roll, pitch, yaw, delta_yaw, speed km/h / 100, body angular
  velocity (3); reward -100 roll^2; reset at |roll| > 1 or |pitch| > 0.1
  or after 500 steps
- spawn at z 0.1 with roll -0.3; heading 0; wheel speed U(0.6, 1.0)

Random draws: the reset's EnvRandom stream on the episode; the tests feed
JAX's through ``reset_draws``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom, Task
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.robot import DRIVE_POS, DRIVE_VEL
from thormang_isaacgym_tpu_torch.ops.inertia import point_jacobian
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams
from thormang_isaacgym_tpu_torch.tasks.gogoro import (
    GOGORO_ASSETS, JOINTS_POS, asset_or_raise, uniform_draws, wheel_friction,
)

REF_COMBINED = os.path.join(GOGORO_ASSETS, "gogoro_and_thormang3_Light_freewheels.urdf")

# the wheel mesh (front_wheel.obj: r 0.2 disk, 0.1 wide, centred at (0.732,
# 0, 0.202) in the mesh frame) as a cylinder; the override's pos cancels the
# URDF collision origin and its quat maps the cylinder's z onto the link's
# y spin axis
_WHEEL_OVERRIDE = {
    "type": "cylinder", "size": (0.2, 0.05),
    "pos": (0.731969, 0.0, 0.201999),
    "quat": (0.70710678, 0.70710678, 0.0, 0.0),
}

# the 7 IK-controlled arm DOFs per side (the grip joints excluded)
_ARM_JOINTS = {
    "l": ("l_arm_sh_p1", "l_arm_sh_r", "l_arm_sh_p2", "l_arm_el_y",
          "l_arm_wr_r", "l_arm_wr_y", "l_arm_wr_p"),
    "r": ("r_arm_sh_p1", "r_arm_sh_r", "r_arm_sh_p2", "r_arm_el_y",
          "r_arm_wr_r", "r_arm_wr_y", "r_arm_wr_p"),
}
_PRISMATIC_DOFS = ("r_handle_prismatic_joint", "l_handle_prismatic_joint",
                   "base_x", "base_y", "base_z")
_FREE_DOFS = ("l_metal_freewheel_holder_TO_l_dummy", "dummy_TO_l_free_wheel",
              "r_metal_freewheel_holder_TO_r_dummy", "dummy_TO_r_free_wheel")


def _build_model(asset_path: str | None = None):
    path = asset_or_raise(asset_path or REF_COMBINED, "combined gogoro")
    model = load_urdf(path, mesh_overrides={"front": _WHEEL_OVERRIDE, "back": _WHEEL_OVERRIDE})
    d = model._defaults
    nj = model.nj
    mode = np.full(nj, DRIVE_POS, np.int32)
    kp = np.full(nj, 10000.0, np.float32)
    kd = np.full(nj, 300.0, np.float32)
    sid = model.dof_id("steering_joint")
    rid = model.dof_id("rear_wheel_joint")
    fid = model.dof_id("front_wheel_joint")
    mode[rid], kp[rid], kd[rid] = DRIVE_VEL, 0.0, 3.0
    mode[fid], kp[fid], kd[fid] = 0, 0.0, 0.0          # runs freely
    fric = np.array(d.get("dof_friction", np.zeros(nj)), np.float32)
    for jn in _FREE_DOFS:
        i = model.dof_id(jn)
        mode[i], kp[i], kd[i], fric[i] = 0, 0.0, 0.0, 1e-4
    mode[sid], kp[sid], kd[sid] = DRIVE_POS, 1000.0, 100.0
    for jn in ("base_x", "base_y", "base_z"):
        i = model.dof_id(jn)
        kp[i], kd[i] = 1.0e7, 10.0
    d["drive_mode"] = mode
    d["drive_stiffness"] = kp
    d["drive_damping"] = kd
    d["dof_friction"] = fric
    d["geom_friction"] = wheel_friction(model)
    # the URDF's 0.1 kg placeholder wheels and the freewheels' identity
    # inertia replaced by physical values (JAX gogoro_combined.py, _build_model)
    bm = np.array(d["body_mass"], np.float32)
    bi = np.array(d["body_inertia"], np.float32)
    for wname in ("back", "front"):
        b = model.body_id(wname)
        if bm[b] < 0.5:
            bm[b] = 2.753
            bi[b] = np.diag([0.8712e-3, 7.728e-3, 0.8712e-3])
    for wname in ("l_free_wheel", "r_free_wheel"):
        b = model.body_id(wname)
        if bm[b] < 0.5:
            bm[b] = 2.7
            bi[b] = np.diag([7.3e-3, 7.3e-3, 13.5e-3])
    d["body_mass"] = bm
    d["body_inertia"] = bi
    return model


@dataclasses.dataclass(frozen=True)
class GogoroCombinedTaskState:
    speed_cmd: torch.Tensor      # (B,) normalised wheel speed in [0.6, 1)
    yaw_cmd: torch.Tensor        # (B,) target heading (0)
    prismatic: torch.Tensor      # (B, 5) rider-offset targets
    last_action: torch.Tensor    # (B,)


class GogoroCombined(Task):
    """Articulated THORMANG3 riding the scooter; balance by steering."""

    num_obs = 8
    num_actions = 1
    max_episode_length = 500
    action0_scale = 0.5
    ik_damping = 0.3

    def __init__(self, num_envs: int = 4096, seed: int = 42, asset_path: str | None = None,
                 use_ik: bool = True, device=None, **_):
        super().__init__(num_envs, seed, device)
        self.model = _build_model(asset_path)
        self.use_ik = use_ik
        # 10 substeps of 3 ms: the 134 kg machine on r <= 0.2 wheels under
        # penalty contact
        self.sim_params = SimParams(
            dt=0.03, substeps=10, gravity=(0.0, 0.0, -9.81), contact_stiffness=6.0e4,
            contact_damping=2.0e3, friction_vel=0.1, plane_friction=0.99, max_velocity=200.0)
        self.dt = self.sim_params.dt
        m, dev = self.model, self.device
        self.sid = m.dof_id("steering_joint")
        self.rid = m.dof_id("rear_wheel_joint")
        self.pris_ids = tuple(m.dof_id(j) for j in _PRISMATIC_DOFS)
        self.arm_ids = {s: tuple(m.dof_id(j) for j in js) for s, js in _ARM_JOINTS.items()}
        # the hand sites (the fixed l/r_arm_end links merged into the wrists)
        self.hand_site = {s: m.sites[f"{s}_arm_end_link"] for s in "lr"}
        self.handle_body = {s: m.body_id(f"{s}_steering_handle_end") for s in "lr"}
        self._col0 = 6 * m.n_floating          # the floating root's jacobian columns
        pose = np.zeros(m.nj, np.float32)
        names = set(m.joint_names)
        for jn, v in JOINTS_POS.items():
            if jn in names:
                pose[m.dof_id(jn)] = v
        self._pose = torch.as_tensor(pose, device=dev)

    # ------------------------------------------------------------------
    def default_task_state(self) -> GogoroCombinedTaskState:
        z = torch.zeros(self.num_envs, device=self.device)
        pris = torch.zeros(self.num_envs, 5, device=self.device)
        return GogoroCombinedTaskState(z + 0.8, z, pris, z)

    def reset_draws(self, rng: EnvRandom) -> dict:
        return uniform_draws(rng, dict(speed_cmd=(0.6, 1.0, ()), pris=(-0.06, 0.06, (5,))))

    def reset_fn(self, rng: EnvRandom, params, task):
        return self.reset_from(self.reset_draws(rng), params)

    def reset_from(self, d: dict, params):
        """reset_idx (gogoro/gogoro.py:563-590): the riding pose with the
        prismatic offsets, zero velocities, spawn at z 0.1 rolled -0.3."""
        B = d["speed_cmd"].shape[0]
        dev = d["speed_cmd"].device
        joint_q = self._pose.expand(B, -1).clone()
        for k, dof in enumerate(self.pris_ids):
            joint_q[:, dof] = d["pris"][:, k]
        zero = torch.zeros(B, device=dev)
        root_pos = torch.tensor([0.0, 0.0, 0.1], device=dev).expand(B, 3)
        root_quat = Q.from_euler_xyz(zero - 0.3, zero, zero)
        q = torch.cat([root_pos, root_quat, joint_q], -1)
        qd = torch.zeros(B, self.model.nv, device=dev)
        return q, qd, params, GogoroCombinedTaskState(d["speed_cmd"], zero, d["pris"], zero)

    # ------------------------------------------------------------------
    def _hand_pos(self, frames, s):
        hb, hp, _ = self.hand_site[s]
        off = frames.pos.new_tensor(hp).expand(frames.pos.shape[0], 3)
        return frames.pos[:, hb] + Q.rotate(frames.quat[:, hb], off)

    def _ik_deltas(self, q, qd):
        """(u_l, u_r): (B, 7) DLS joint-position deltas moving each hand
        toward its handle end (control_ik, gogoro/gogoro.py:597-602); the
        orientation rows of the pose error are zero."""
        frames = forward_kinematics(self.model, q, qd)
        B = q.shape[0]
        out = {}
        for s in "lr":
            hb, hp, _ = self.hand_site[s]
            err = frames.pos[:, self.handle_body[s]] - self._hand_pos(frames, s)
            # the jacobian's rows are [angular; linear]
            dpose = torch.cat([torch.zeros_like(err), err], -1)
            J = point_jacobian(self.model, q, hb, hp, frames=frames)
            cols = torch.as_tensor([self._col0 + i for i in self.arm_ids[s]], device=q.device)
            Jarm = J[:, :, cols]                                   # (B, 6, 7)
            JJt = Jarm @ Jarm.transpose(1, 2) + self.ik_damping ** 2 * torch.eye(
                6, device=q.device).expand(B, 6, 6)
            out[s] = (Jarm.transpose(1, 2) @ torch.linalg.solve(JJt, dpose[..., None]))[..., 0]
        return out["l"], out["r"]

    def pre_physics(self, state, actions):
        """pre_physics_step (gogoro/gogoro.py:350-443)."""
        B, dev = actions.shape[0], actions.device
        t = state.task
        m = self.model
        a = actions[:, 0]
        prog = state.progress.to(torch.float32)
        ramp = torch.where(prog < 70.0, t.speed_cmd * ((prog - 20.0) / 70.0), t.speed_cmd)
        target_vel = torch.zeros(B, m.nj, device=dev)
        target_vel[:, self.rid] = ramp * 30.0 + 20.0
        tgt = self._pose.expand(B, -1).clone()
        tgt[:, self.sid] = a * self.action0_scale
        for k, dof in enumerate(self.pris_ids):
            tgt[:, dof] = t.prismatic[:, k]
        if self.use_ik:
            u_l, u_r = self._ik_deltas(state.q, state.qd)
            jq = state.q[:, 7:]
            for s, u in (("l", u_l), ("r", u_r)):
                ids = list(self.arm_ids[s])
                tgt[:, ids] = jq[:, ids] + u
        ctrl = Controls(tgt, target_vel, torch.zeros(B, m.nj, device=dev))
        wrench = torch.zeros(B, m.nb, 6, device=dev)
        return ctrl, wrench, dataclasses.replace(t, last_action=a)

    def post_physics(self, state, prev_task):
        """compute_observations / compute_gogoro_reward (gogoro/gogoro.py:612-676)."""
        t = prev_task
        roll, pitch, yaw = (Q.wrap_to_pi(x) for x in Q.to_euler_xyz(state.q[:, 3:7]))
        omega_b = state.qd[:, 0:3]
        v_w = state.qd[:, 3:6]
        speed = (torch.abs(v_w[:, 0]) + torch.abs(v_w[:, 1])) * 3.6
        delta_yaw = yaw - t.yaw_cmd
        obs = torch.cat([roll[:, None], pitch[:, None], yaw[:, None], delta_yaw[:, None],
                         speed[:, None] / 100.0, omega_b], -1)
        reward = -(roll ** 2) * 100.0
        fallen = (torch.abs(roll) > 1.0) | (torch.abs(pitch) > 0.1)
        metrics = dict(state.metrics)
        metrics["roll_abs"] = torch.abs(roll)
        metrics["pitch_abs"] = torch.abs(pitch)
        metrics["speed_kmh"] = speed
        if self.use_ik:
            metrics["hand_err"] = self._hand_err(state.q, state.qd)
        return obs, reward, fallen.to(torch.float32), t, metrics

    def _hand_err(self, q, qd):
        """(B,) the mean over both hands of the hand-to-handle distance."""
        frames = forward_kinematics(self.model, q, qd)
        errs = [torch.linalg.norm(self._hand_pos(frames, s)
                                  - frames.pos[:, self.handle_body[s]], dim=-1) for s in "lr"]
        return (errs[0] + errs[1]) / 2
