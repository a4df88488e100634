"""MA_OP3: two OP3 humanoids carrying a table (multi-agent). Port of
``thormang_isaacgym_tpu/tasks/ma_op3.py`` (the reference's ``tasks/MA_OP3.py``
and the multi-agent buffer shapes of ``tasks/base/multi_vec_task.py``).

Buffers: obs (B, 2, 88), rewards (B, 2), one done per env. The scene: two
PD-driven OP3s facing each other across a free-standing table, ``a0/`` at x
= -0.31, ``a1/`` at x = 0.30 turned by pi, ``table/`` at z = 0.30: three
floating roots, two of them articulated trees, and 75 actor pairs (the
kernel's box instance).

The reference task is unfinished (its pre_physics_step is ``pass``, its
post_physics_step computes no reward). The JAX package completes it, and the
port follows the JAX package line by line, including what it reproduces
from the reference on purpose:

- actions -> PD position targets around defaultJointAngles (kp 1000, kd
  200), scattered into the composed model's joint order (tree order, not
  the reference's DOF order: ``agent_dofs``)
- obs 88 = local linear velocity 3 + local angular velocity 3 + gravity
  projected with ``rotate`` (not its inverse, as the reference does) 3 +
  DOF positions 22 + DOF velocities 22 + the last actions 22 + the table's
  pose 7 and velocity 3 + the target 3
- per-agent reward: progress toward the goal + alive + torque rate + up +
  feet air time (the first contact read from the *old* air time; the last
  contacts store the unfiltered contact) + angular velocity z + no-fly +
  action rate + hip sync + table proximity + gripper hold; the heading and
  gripper terms are computed by the reference but left out of its sum, and
  so here. The shared objective (table up, height, progress) is added to
  both agents, and the sum clipped at 0 from below.
- resets: an agent fallen or too far from the table, the table tipped or
  dropped, only after the first step (``progress > 1``)
- the potentials: the previous and the current both take the new value
  (the reference's table bookkeeping, fixed in the JAX package to the
  agents' form)

The only random draw of a reset is the y command, uniform in [0, 10), from
the port's per-env EnvRandom stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom, Task
from thormang_isaacgym_tpu_torch.models.op3 import (
    BASE_Z, OP3_DOF_NAMES, TABLE_Z, load_op3, load_table, op3_default_dof,
)
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams

# reward scales (cfg/task/MA_OP3.yaml learn block), times dt (set_dt)
REW_SCALES = {
    "torque": -0.000025, "up_scale": 0.1, "air_time": 0.5, "no_fly": 0.5,
    "stand_scale": 0.0, "action_rate": -0.01, "syns_hip": -0.00025,
    "heading_scale": 1.0,
}
# the leg and gripper DOFs of the hip-sync penalty, in agent DOF order
_SYNS_IDX = np.array([2, 3, 4, 5, 6, 7, 11, 12, 13, 14, 15, 16, 17, 21])
# the agents' root poses (x, wxyz): facing each other across the table
_AGENT_ROOTS = ((-0.31, (1.0, 0.0, 0.0, 0.0)), (0.30, (0.0, 0.0, 0.0, 1.0)))


@dataclasses.dataclass(frozen=True)
class MAOP3TaskState:
    actions: torch.Tensor                # (B, 2, 22)
    last_actions: torch.Tensor           # (B, 2, 22)
    prev_torques: torch.Tensor           # (B, 2, 22)
    feet_air_time: torch.Tensor          # (B, 2, 2)
    last_contacts: torch.Tensor          # (B, 2, 2) bool as float
    potentials: torch.Tensor             # (B, 2)
    prev_potentials: torch.Tensor        # (B, 2)
    table_potentials: torch.Tensor       # (B,)
    prev_table_potentials: torch.Tensor  # (B,)
    commands: torch.Tensor               # (B, 3) x / y / yaw command


class MA_OP3(Task):
    num_agents = 2
    episode_length_s = 50.0
    max_episode_length = 3012            # episode_length_s / dt 0.0166
    clip_obs = 5.0
    action_scale = 1.0
    lin_vel_scale = 3.0
    ang_vel_scale = 0.25
    dof_pos_scale = 1.0
    dof_vel_scale = 0.01
    command_y_range = (0.0, 10.0)        # randomCommandVelocityRanges
    kp, kd = 1000.0, 200.0
    effort_limit = 4.1

    def __init__(self, num_envs: int = 8, seed: int = 42, device=None,
                 randomize: bool = False, **_):
        super().__init__(num_envs, seed, device)
        if randomize:
            raise NotImplementedError("domain randomization (randomize: true) is not ported yet")
        dev = self.device
        op3 = load_op3(self.kp, self.kd)
        table = load_table()
        scene = compose([
            (op3, (-0.31, 0.0, BASE_Z, 1.0, 0.0, 0.0, 0.0), "a0/"),
            (op3, (0.30, 0.0, BASE_Z, 0.0, 0.0, 0.0, 1.0), "a1/"),
            (table, (0.0, 0.0, TABLE_Z, 1.0, 0.0, 0.0, 0.0), "table/"),
        ], name="ma_op3")
        self.model = scene
        self.num_obs = 88
        self.num_actions = len(OP3_DOF_NAMES)

        # per-agent DOF and body maps, from the composed model's names
        self.agent_dofs = np.array([[scene.dof_id(f"a{a}/{n}") for n in OP3_DOF_NAMES]
                                    for a in range(2)], np.int64)
        default = np.stack([op3_default_dof(scene, f"a{a}/")[self.agent_dofs[a]]
                            for a in range(2)])           # (2, 22) in agent order
        self.feet = np.array([[scene.body_id(f"a{a}/{s}_ank_link") for s in ("l", "r")]
                              for a in range(2)], np.int64)
        self.grippers = np.array([[scene.body_id(f"a{a}/{s}_gr_link") for s in ("l", "r")]
                                  for a in range(2)], np.int64)
        # floating-root q and qd offsets, actor order (a0, a1, table)
        self.q_root = (0, 7, 14)
        self.qd_root = (0, 6, 12)
        self._dofs = torch.as_tensor(self.agent_dofs, device=dev)
        self.default_dof = torch.as_tensor(default, dtype=torch.float32, device=dev)
        self._feet = torch.as_tensor(self.feet.reshape(-1), device=dev)
        self._grippers = torch.as_tensor(self.grippers.reshape(-1), device=dev)
        self._syns = torch.as_tensor(_SYNS_IDX, device=dev)

        def vec(*v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        self.start_quat = torch.stack([vec(*q) for _, q in _AGENT_ROOTS])
        self.inv_start = Q.conj(self.start_quat)
        self.goal_pos = vec(0.0, -10.0, 0.0)
        self.targets = vec(0.0, 10.0, 0.0)
        self.gravity_vec = vec(0.0, 0.0, -1.0)
        self.vec0 = vec(1.0, 0.0, 0.0)
        self.vec1 = vec(0.0, 0.0, 1.0)
        jq = torch.zeros(scene.nj, device=dev)
        for a in range(2):
            jq[self._dofs[a]] = self.default_dof[a]
        roots = [vec(x, 0.0, BASE_Z, *q) for x, q in _AGENT_ROOTS]
        roots.append(vec(0.0, 0.0, TABLE_Z, 1.0, 0.0, 0.0, 0.0))
        self._q0 = torch.cat(roots + [jq])                   # (nq,) the reset pose

        self.sim_params = SimParams(
            dt=0.0166, substeps=3, gravity=(0.0, 0.0, -9.81),
            contact_stiffness=2.0e4, contact_damping=8.0e2,
            friction_vel=0.05, plane_friction=1.0)
        self.set_dt(self.sim_params.dt)

    def set_dt(self, dt: float) -> None:
        """The reward scales x dt and the episode length in control steps."""
        super().set_dt(dt)
        self.rew = {k: v * dt for k, v in REW_SCALES.items()}
        self.max_episode_length = int(self.episode_length_s / dt)

    # ------------------------------------------------------------------
    def _roots(self, q, qd):
        """Per-root (pos, quat, v_world, omega_world), stacked (B, 3, ...)."""
        pos = torch.stack([q[:, o:o + 3] for o in self.q_root], 1)
        quat = torch.stack([q[:, o + 3:o + 7] for o in self.q_root], 1)
        omega_b = torch.stack([qd[:, o:o + 3] for o in self.qd_root], 1)
        vel = torch.stack([qd[:, o + 3:o + 6] for o in self.qd_root], 1)
        return pos, quat, vel, Q.rotate(quat, omega_b)

    def _start_potentials(self, B, dev):
        """The agents' and the table's potentials at the reset pose."""
        base = torch.tensor([[-0.31, 0.0, BASE_Z], [0.30, 0.0, BASE_Z]], device=dev)
        to_goal = self.goal_pos[None] - base
        to_goal[:, 2] = 0.0
        pots = -torch.linalg.norm(to_goal, dim=-1) / self.dt
        to_tgt = self.targets - torch.tensor([0.0, 0.0, TABLE_Z], device=dev)
        to_tgt[2] = 0.0
        tpot = -torch.linalg.norm(to_tgt, dim=-1) / self.dt
        return pots.expand(B, 2).clone(), tpot.expand(B).clone()

    def default_task_state(self) -> MAOP3TaskState:
        B, dev = self.num_envs, self.device
        z2 = torch.zeros(B, 2, self.num_actions, device=dev)
        p = torch.full((B, 2), -1000.0 / self.dt, device=dev)
        tp = torch.full((B,), -1000.0 / self.dt, device=dev)
        return MAOP3TaskState(
            actions=z2, last_actions=z2, prev_torques=z2,
            feet_air_time=torch.zeros(B, 2, 2, device=dev),
            last_contacts=torch.zeros(B, 2, 2, device=dev),
            potentials=p, prev_potentials=p, table_potentials=tp, prev_table_potentials=tp,
            commands=torch.zeros(B, 3, device=dev))

    def reset_fn(self, rng: EnvRandom, params, task):
        """Both agents at their default pose, the table at rest, a new y
        command uniform in command_y_range."""
        cy = rng.uniform(1, *self.command_y_range)                  # (B, 1)
        B, dev = cy.shape[0], cy.device
        q = self._q0.expand(B, -1).clone()
        qd = torch.zeros(B, self.model.nv, device=dev)
        commands = torch.cat([torch.zeros_like(cy), cy, torch.zeros_like(cy)], -1)
        pots, tpot = self._start_potentials(B, dev)
        z2 = torch.zeros(B, 2, self.num_actions, device=dev)
        z22 = torch.zeros(B, 2, 2, device=dev)
        return q, qd, params, MAOP3TaskState(
            actions=z2, last_actions=z2, prev_torques=z2, feet_air_time=z22, last_contacts=z22,
            potentials=pots, prev_potentials=pots, table_potentials=tpot,
            prev_table_potentials=tpot, commands=commands)

    # ------------------------------------------------------------------
    def pre_physics(self, state, actions):
        B = actions.shape[0]
        targets = self.default_dof[None] + self.action_scale * actions
        full = actions.new_zeros(B, self.model.nj)
        for a in range(2):
            full[:, self._dofs[a]] = targets[:, a]
        z = torch.zeros_like(full)
        task = dataclasses.replace(state.task, last_actions=state.task.actions, actions=actions)
        return Controls(full, z, z), actions.new_zeros(B, self.model.nb, 6), task

    def post_physics(self, state, prev_task):
        t = prev_task
        B = state.q.shape[0]
        pos, quat, vel, omega = self._roots(state.q, state.qd)
        a_pos, a_quat, a_vel, a_omega = pos[:, :2], quat[:, :2], vel[:, :2], omega[:, :2]
        table_pos, table_quat, table_vel = pos[:, 2], quat[:, 2], vel[:, 2]
        jq = state.q[:, self.model.root_nq:]
        jqd = state.qd[:, self.model.root_nv:]
        dof_pos = torch.stack([jq[:, self._dofs[a]] for a in range(2)], 1)
        dof_vel = torch.stack([jqd[:, self._dofs[a]] for a in range(2)], 1)

        # per-agent observations
        lin_loc = Q.rotate_inv(a_quat, a_vel) * self.lin_vel_scale
        ang_loc_raw = Q.rotate_inv(a_quat, a_omega)
        proj_g = Q.rotate(a_quat, self.gravity_vec.expand(B, 2, 3))
        dof_scaled = (dof_pos - self.default_dof[None]) * self.dof_pos_scale
        table_pose = torch.cat([table_pos, table_quat], -1)
        obs = torch.cat([
            lin_loc, ang_loc_raw * self.ang_vel_scale, proj_g, dof_scaled,
            dof_vel * self.dof_vel_scale, t.actions,
            table_pose[:, None].expand(B, 2, 7), table_vel[:, None].expand(B, 2, 3),
            self.targets.expand(B, 2, 3)], -1)

        # potentials
        to_goal = self.goal_pos - a_pos
        to_goal[..., 2] = 0.0
        potentials = -torch.linalg.norm(to_goal, dim=-1) / self.dt
        to_tgt = self.targets - table_pos
        to_tgt[:, 2] = 0.0
        table_pot = -torch.linalg.norm(to_tgt, dim=-1) / self.dt

        # contacts
        feet_f = state.net_contact[:, self._feet].reshape(B, 2, 2, 3)
        grip_f = state.net_contact[:, self._grippers].reshape(B, 2, 2, 3)

        # feet air time: the first contact from the old air time
        contact = (feet_f[..., 2] > 1.1).to(torch.float32)
        contact_filt = torch.maximum(contact, t.last_contacts)
        first_contact = (t.feet_air_time > 0.0) * contact_filt
        air = t.feet_air_time + self.dt
        cmd_on = torch.linalg.norm(t.commands[:, :2], dim=-1) > 0.1
        rew_air = ((air - 0.5) * first_contact).sum(-1) * cmd_on[:, None] * self.rew["air_time"]
        air = air * (1.0 - contact_filt)

        # step, no-fly, gripper hold
        rew_step = torch.clamp(torch.linalg.norm(feet_f, dim=-1) - 450.0, min=0.0).sum(-1)
        single = (feet_f[..., 2] > 0.1).sum(-1) == 1
        rew_no_fly = single.to(torch.float32) * self.rew["no_fly"]
        grip_hold = (grip_f[..., 0, 0] > 0.1) & (grip_f[..., 1, 0] > 0.1)
        rew_grip_hold = grip_hold.to(torch.float32)

        # per-agent reward (the heading term is computed by the reference and
        # left out of its sum: not computed here)
        torso_quat = Q.mul(a_quat, self.inv_start[None])
        up_proj = Q.rotate(torso_quat, self.vec1.expand(B, 2, 3))[..., 2]
        rew_up = torch.where(up_proj > 0.95, torch.full_like(up_proj, self.rew["up_scale"]),
                             torch.zeros_like(up_proj))
        alive = 2.0
        progress = (potentials - t.potentials) * 5.0
        tq = torch.clamp(self.kp * ((self.default_dof[None] + self.action_scale * t.actions)
                                    - dof_pos) - self.kd * dof_vel,
                         -self.effort_limit, self.effort_limit)
        rew_torque = torch.abs(t.prev_torques - tq).sum(-1) * self.rew["torque"]
        syns = torch.abs(dof_pos[..., self._syns] - self.default_dof[None][..., self._syns]).sum(-1)
        rew_syns = syns * self.rew["syns_hip"]
        rew_action_rate = torch.square(t.last_actions - t.actions).sum(-1) * self.rew["action_rate"]
        rew_stand = torch.abs(dof_pos - self.default_dof[None]).sum(-1) * \
            (~cmd_on)[:, None] * self.rew["stand_scale"]
        rew_ang_z = torch.exp(-torch.square(self.targets[2] - ang_loc_raw[..., 2]) / 0.1) * 0.1
        dist_table = torch.linalg.norm(a_pos - table_pos[:, None], dim=-1)
        rew_dist = torch.exp(-dist_table / 0.32) * 0.5
        agent_rew = (progress + alive + rew_torque + rew_up + rew_air + rew_ang_z + rew_step
                     + rew_no_fly + rew_stand + rew_action_rate + rew_syns + rew_dist
                     + rew_grip_hold)

        # the shared objective
        t_up = Q.rotate(table_quat, self.vec1.expand(B, 3))[..., 2]
        obj_up = torch.where(t_up > 0.98, torch.full_like(t_up, 0.1), torch.zeros_like(t_up))
        obj_height = torch.square(table_pos[:, 2] - 0.29) * -0.001
        obj_dist = (table_pot - t.table_potentials) * 5.0
        reward = torch.clamp(agent_rew + (obj_up + obj_height + obj_dist)[:, None], min=0.0)

        # resets
        fallen = (up_proj < 0.90).any(-1)
        too_far = (dist_table > 0.40).any(-1)
        table_tipped = t_up < 0.90
        table_dropped = table_pos[:, 2] < 0.25
        done = (fallen | too_far | table_tipped | table_dropped) & (state.progress > 1)

        task = dataclasses.replace(
            t, prev_torques=tq, feet_air_time=air, last_contacts=contact,
            potentials=potentials, prev_potentials=potentials,
            table_potentials=table_pot, prev_table_potentials=table_pot)
        metrics = dict(state.metrics)
        metrics["table_height"] = table_pos[:, 2]
        metrics["grip_hold"] = rew_grip_hold.mean(-1)
        return obs, reward, done.to(torch.float32), task, metrics
