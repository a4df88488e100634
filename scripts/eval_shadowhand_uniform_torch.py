#!/usr/bin/env python3
"""ShadowHand evaluation in the PyTorch port on the reference task's goals:
``goal_curriculum=False`` (uniform random reorientation goals, success
tolerance 0.1). The port's twin of ``scripts/eval_shadowhand_uniform.py``.

The checkpoint may be the port's or the JAX package's (``runtime/checkpoint.py``
reads both); the policy is ``PPO(PPOConfig.from_rlgames(cfg/train/ShadowHandPPO.yaml))``
acting on its mean action (or sampling, ``--stochastic``). Every 100 steps it
records the env means of the consecutive-success EMA, the successes per
episode, rot_dist and goal_dist (rounded to 4 decimals, as the JAX script),
and prints the last row as one JSON line.

Run:  python3 scripts/eval_shadowhand_uniform_torch.py runs/sh_cur_r5j/nn/best.ckpt \\
          [--envs 2048] [--steps 1800] [--seed 5] [--device cpu] [--stochastic]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def summary_row(step: int, metrics: dict) -> dict:
    """The JAX script's row: the env means of the task's metrics."""
    def mean(k):
        return round(float(metrics[k].float().mean()), 4)
    return {"step": step, "cons_successes": mean("consecutive_successes"),
            "successes_mean": mean("successes"), "rot_dist_mean": mean("rot_dist"),
            "goal_dist_mean": mean("goal_dist")}


@torch.no_grad()
def run(env, ppo, ts, steps: int, seed: int, deterministic: bool = True) -> list:
    """`steps` control steps from ``env.reset(seed)``; a ``summary_row``
    every 100 steps. Sampled actions use ``ts.gen``."""
    state = env.reset(seed)
    hist = []
    for i in range(steps):
        if deterministic:
            a = ppo.act_deterministic(ts, state.obs)
        else:
            mu, log_std, _ = ppo._policy(ts, state.obs)
            a, _ = ppo._sample(ts, mu, log_std)
        state = env.step_fn(state, a)
        if i % 100 == 99:
            hist.append(summary_row(i + 1, state.metrics))
    return hist


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=1800)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default=None, help="default: CUDA")
    ap.add_argument("--stochastic", action="store_true")
    args = ap.parse_args(argv)
    if args.steps < 100:
        raise ValueError("--steps must be at least 100 (one row every 100 steps)")

    import thormang_isaacgym_tpu_torch as tgt
    from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
    from thormang_isaacgym_tpu_torch.runtime.checkpoint import load_train_state
    from thormang_isaacgym_tpu_torch.utils.config import CFG_ROOT, load_yaml

    cfg = PPOConfig.from_rlgames(load_yaml(os.path.join(CFG_ROOT, "train", "ShadowHandPPO.yaml")))
    env = tgt.make("ShadowHand", num_envs=args.envs, seed=args.seed, goal_curriculum=False,
                   device=args.device)
    ppo = PPO(env, cfg, device=env.device)
    ts = load_train_state(args.checkpoint, ppo)
    hist = run(env, ppo, ts, args.steps, args.seed, deterministic=not args.stochastic)
    out = {"checkpoint": args.checkpoint, "num_envs": args.envs, "steps": args.steps,
           "goal_curriculum": False, "deterministic": not args.stochastic,
           "device": str(env.device), "history": hist, "final": hist[-1]}
    print(json.dumps(out["final"]))
    return out


if __name__ == "__main__":
    main()
