"""Scripted close-and-lift evaluation of a FactoryTaskNutBoltPick policy in
the PyTorch port: the reference's post-reach success protocol (close the
gripper, lift at the episode's end), after the trained reach.

Twin of scripts/eval_factory_lift.py, with its phases, seed and width:

- ``make("FactoryTaskNutBoltPick", num_envs=128, seed=3)`` (no task config,
  as JAX's script), the policy ``PPO(PPOConfig.from_rlgames(
  cfg/train/FactoryTaskNutBoltPickPPO.yaml))`` holding the checkpoint, a
  port or a JAX one (``runtime/checkpoint.py``);
- reach: 96 steps of ``act_deterministic``;
- align: 30 steps that turn the gripper's yaw onto the nut's nearest flat,
  the yaw error wrapped into [-45, 45) degrees (the square nut's symmetry)
  and sent as action 5, clip(error / 0.1, -1, 1);
- close: 60 steps of zero action with the gripper's target width 0;
- lift: 120 steps of action 2 = 0.25 (a gentle +z), the target still 0.
The episode clock is zeroed before the scripted phases and after each of
their steps, so no timeout resets an env inside them. Success: the nut
more than 3 x 2 x NUT_H above the table.

JAX traces a second env whose ``_gripper_target`` is 0; the port's task
reads the attribute at every step (``tasks/factory.py FactoryBase._torques``),
so one env and one state serve every phase and the attribute is set to 0
before the close.

Prints one JSON line with the JAX script's keys (checkpoint, num_envs,
reach_keypoint_dist, phases, nut_height_above_table_mean, lift_threshold_m,
success_rate) and the device, the kernel launches, the last launch's
geometry (``FusedStep.last_geometry``; null on the CPU) and the seconds.

Run: python scripts/eval_factory_lift_torch.py runs/factory_pick_r5/nn/best.ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TASK = "FactoryTaskNutBoltPick"
SEED = 3        # scripts/eval_factory_lift.py's env and reset seed
ALIGN_STEPS = 30
LIFT_ACTION = 0.25


def yaw(quat: torch.Tensor) -> torch.Tensor:
    """(B,) yaw about world z of the frame's x axis, of (B, 4) quaternions."""
    from thormang_isaacgym_tpu_torch.core import quat as Q
    x = Q.rotate(quat, quat.new_tensor([1.0, 0.0, 0.0]).expand(quat.shape[0], 3))
    return torch.atan2(x[:, 1], x[:, 0])


def wrap_quarter(angle: torch.Tensor) -> torch.Tensor:
    """`angle` wrapped into [-pi/4, pi/4): the square nut's symmetry."""
    return torch.remainder(angle + math.pi / 4, math.pi / 2) - math.pi / 4


def align_action(task, state) -> torch.Tensor:
    """(B, num_actions) zero but for action 5, the gripper's yaw rate onto
    the nut's nearest flat: clip(wrapped yaw error / 0.1, -1, 1)."""
    gq = task._eef(state.q, state.qd)[1]
    dyaw = wrap_quarter(yaw(state.q[:, task.qN + 3:task.qN + 7]) - yaw(gq))
    a = torch.zeros(state.q.shape[0], task.num_actions, device=state.q.device)
    a[:, 5] = torch.clamp(dyaw / 0.1, -1.0, 1.0)
    return a


def lift_threshold() -> float:
    from thormang_isaacgym_tpu_torch.tasks.factory import NUT_H
    return 3.0 * 2.0 * NUT_H


def lifted(nut_z: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the nut more than lift_threshold() above the table."""
    from thormang_isaacgym_tpu_torch.tasks.factory import TABLE_Z
    return nut_z - TABLE_Z > lift_threshold()


def _hold(state):
    """The state with its episode clock zeroed: no timeout reset fires."""
    return dataclasses.replace(state, progress=torch.zeros_like(state.progress))


def main(argv=None, *, num_envs: int = 128, reach: int = 96, align: int = ALIGN_STEPS,
         close: int = 60, lift: int = 120) -> dict:
    """Play the checkpoint named in `argv` through the four phases of
    `reach`, `align`, `close` and `lift` control steps at `num_envs` envs
    (default the reference's); print and return the JSON record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", nargs="?", default="runs/factory_pick_r5/nn/best.ckpt")
    ap.add_argument("--device", default=None, help="default cuda; cpu to run on the CPU")
    args = ap.parse_args(argv)

    import thormang_isaacgym_tpu_torch as tgt
    from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
    from thormang_isaacgym_tpu_torch.runtime.checkpoint import load_train_state
    from thormang_isaacgym_tpu_torch.tasks.factory import TABLE_Z
    from thormang_isaacgym_tpu_torch.utils.config import CFG_ROOT, load_yaml

    cfg = PPOConfig.from_rlgames(load_yaml(os.path.join(CFG_ROOT, "train", f"{TASK}PPO.yaml")))
    env = tgt.make(TASK, num_envs=num_envs, seed=SEED, device=args.device)
    task = env.task
    ppo = PPO(env, cfg, device=env.device)
    ts = load_train_state(args.checkpoint, ppo)
    t0 = time.perf_counter()
    launches0 = env.physics_step.launches
    state = env.reset(SEED)
    lift_a = torch.zeros(env.num_envs, env.num_actions, device=env.device)
    lift_a[:, 2] = LIFT_ACTION
    zero = torch.zeros_like(lift_a)
    with torch.no_grad():
        for _ in range(reach):
            state = env.step_fn(state, ppo.act_deterministic(ts, state.obs))
        kd_reach = float(state.metrics["keypoint_dist"].mean())
        state = _hold(state)
        for _ in range(align):
            state = _hold(env.step_fn(state, align_action(task, state)))
        open_target = task._gripper_target
        task._gripper_target = 0.0
        try:
            for _ in range(close):
                state = _hold(env.step_fn(state, zero))
            for _ in range(lift):
                state = _hold(env.step_fn(state, lift_a))
        finally:
            task._gripper_target = open_target
    nut_z = state.q[:, task.qN + 2]
    out = {
        "checkpoint": args.checkpoint, "num_envs": env.num_envs,
        "reach_keypoint_dist": round(kd_reach, 4),
        "phases": {"reach": reach, "close": close, "lift": lift},
        "nut_height_above_table_mean": round(float((nut_z - TABLE_Z).mean()), 4),
        "lift_threshold_m": round(lift_threshold(), 4),
        "success_rate": round(float(lifted(nut_z).float().mean()), 4),
        "align": align, "device": str(env.device),
        "kernel_launches": env.physics_step.launches - launches0,
        "kernel_geometry": env.physics_step.last_geometry,
        "seconds": round(time.perf_counter() - t0, 2),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
