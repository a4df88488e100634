#!/usr/bin/env python3
"""Where one PPO train iteration of the PyTorch/CUDA port spends its time:
a task at its YAML's width (numEnvs: 4096, AllegroHand 16384),
cfg/task/<task>.yaml + cfg/train/<task>PPO.yaml (Ant by default), on one GPU.

Run from the repository root:
  python3 scripts/profile_torch_ant.py [--task AnymalTerrain|BallBalance|AllegroHand]

Prints JSON lines: the card (nvidia-smi name and power limit); host-clock
times, each closed by torch.cuda.synchronize(), of one rollout (horizon x
policy + env step), one whole train_iteration (their difference is GAE +
update) and one env step alone; then a torch.profiler window over one
iteration: device busy time (sum of CUDA kernel times on the one stream),
wall time, the device's idle share and the top kernels by device time.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import thormang_isaacgym_tpu_torch as tgt  # noqa: E402
from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="Ant")
    task = ap.parse_args().task
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "task": task}), flush=True)
    with open(os.path.join(ROOT, "cfg", "task", f"{task}.yaml")) as f:
        task_cfg = yaml.safe_load(f)
    with open(os.path.join(ROOT, "cfg", "train", f"{task}PPO.yaml")) as f:
        cfg = PPOConfig.from_rlgames(yaml.safe_load(f))
    B = int(task_cfg["env"]["numEnvs"])
    env = tgt.make(task, num_envs=B, seed=0, cfg=task_cfg, device="cuda")
    ppo = PPO(env, cfg, device="cuda")
    ts = ppo.init(0)
    state = env.reset(0)
    for _ in range(2):                                   # warm-up
        ts, state, _ = ppo.train_iteration(ts, state)
    torch.cuda.synchronize()

    # ---- host clock: a rollout alone, a whole iteration, env steps alone ----
    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    t0 = clock()
    state, _ = ppo.rollout(ts, state)
    t1 = clock()
    ts, state, _ = ppo.train_iteration(ts, state)
    t2 = clock()
    actions = torch.zeros(B, env.num_actions, device="cuda")
    for _ in range(20):
        state = env.step_fn(state, actions)
    t3 = clock()
    print(json.dumps({"rollout_s": t1 - t0, "iteration_s": t2 - t1,
                      "update_and_gae_s": (t2 - t1) - (t1 - t0),
                      "env_step_ms": (t3 - t2) / 20 * 1e3,
                      "iteration_env_steps_per_s": B * cfg.horizon_length / (t2 - t1)}),
          flush=True)

    # ---- profiler window over one full iteration ----
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        ts, state, _ = ppo.train_iteration(ts, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    if not rows:
        print(json.dumps({"profile": "key_averages() shows no device time"}), flush=True)
        return
    busy_s = sum(r[0] for r in rows) / 1e6
    print(json.dumps({"profile": {"wall_s": wall, "device_busy_s": busy_s,
                                  "device_idle_share": (1 - busy_s / wall) if wall else None,
                                  "kernels_launched": sum(r[2] for r in rows),
                                  "top": [{"name": k[:80], "device_ms": us / 1e3, "count": c}
                                          for us, k, c in rows[:12]]}}), flush=True)


if __name__ == "__main__":
    main()
