#!/usr/bin/env python3
"""Deterministic play of a FactoryTaskNutBoltPick checkpoint in the PyTorch
port: one episode of 100 control steps at the YAML's 128 envs.

The checkpoint may be the port's or the JAX package's (``runtime/checkpoint.py``
reads both). The env is ``make("FactoryTaskNutBoltPick",
cfg=cfg/task/FactoryTaskNutBoltPick.yaml)``, the policy
``PPO(PPOConfig.from_rlgames(cfg/train/FactoryTaskNutBoltPickPPO.yaml))``
acting on its mean action (``act_deterministic``). Prints one JSON line: the
env mean of ``keypoint_dist`` (the sum of the 4 keypoint distances between
the fingertip frame and the nut's grasp frame, m) after the reset, after 96
steps (where ``scripts/eval_factory_lift.py`` reads the JAX package's reach
phase) and after 99 steps (the episode's last state, before the timeout
reset), the minimum over the episode, and the share of envs within 0.3 at
the end.

Run:  python3 scripts/play_factory_checkpoint.py runs/factory_pick_r5b/nn/last.ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TASK = "FactoryTaskNutBoltPick"
STEPS = 100     # the task's max_episode_length
SEED = 3        # scripts/eval_factory_lift.py's seed


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("--device", default=None, help="default: CUDA")
    args = ap.parse_args(argv)

    import thormang_isaacgym_tpu_torch as tgt
    from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
    from thormang_isaacgym_tpu_torch.runtime.checkpoint import load_train_state

    with open(os.path.join(ROOT, "cfg", "task", f"{TASK}.yaml")) as f:
        task_cfg = yaml.safe_load(f)
    with open(os.path.join(ROOT, "cfg", "train", f"{TASK}PPO.yaml")) as f:
        train_cfg = yaml.safe_load(f)
    env = tgt.make(TASK, seed=SEED, cfg=task_cfg, device=args.device)
    ppo = PPO(env, PPOConfig.from_rlgames(train_cfg), device=env.device)
    ts = load_train_state(args.checkpoint, ppo)
    t0 = time.perf_counter()
    state = env.reset(SEED)
    kd = [float(state.metrics["keypoint_dist"].mean())]
    with torch.no_grad():
        for _ in range(STEPS - 1):
            state = env.step_fn(state, ppo.act_deterministic(ts, state.obs))
            kd.append(float(state.metrics["keypoint_dist"].mean()))
    final = state.metrics["keypoint_dist"]
    out = dict(task=TASK, checkpoint=args.checkpoint, device=str(env.device), envs=env.num_envs,
               steps=STEPS, keypoint_dist_reset=kd[0],
               keypoint_dist_step96=kd[96] if len(kd) > 96 else None,
               keypoint_dist_final=kd[-1], keypoint_dist_min=min(kd),
               env_share_final_within_0_3=float((final < 0.3).float().mean()),
               env_max_final=float(final.max()), seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
