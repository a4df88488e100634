"""Record the port's learning curves at the JAX package's parity specs and
hold each to JAX's pass rule; write PARITY_torch.json.

Twin of scripts/record_parity.py. The rows, floors, metrics, seeds and the
drawdown bound are JAX's own (``SPECS``, ``TPU_SPECS``, ``DRAWDOWN_FRAC``);
the training is the port's ``PPO.train``:

- ``make(task, num_envs=n, seed=7, stagger_episodes=True)`` with no task
  config, so each task class keeps its own dt and substeps, as JAX's
  recorder does;
- ``PPOConfig.from_rlgames`` of the row's train YAML, the minibatch capped
  at n x horizon, ``max_epochs`` = epochs, float32;
- ``train(epochs, seed=7, log_every=5)``; the curve is the row's metric at
  each logged epoch.

``--seeds 7,1,2`` trains each row once a seed: the row is the first seed's
run, and every run's verdict stands beside it under ``seed_runs``, the
spread of the curve over seeds (JAX's rows have seed 7).

A row passes when, in sign-adjusted space (``direction`` -1: the metric must
fall), its last point reaches the floor, its last point rose strictly above
its first, and it kept at least DRAWDOWN_FRAC of its peak where the peak
beat the floor (``passes``). A row whose task's asset is not in the
repository is recorded as skipped, never as passed.

The default lane is JAX's CPU lane (``SPECS``); ``--card`` runs the rows JAX
ran on its accelerator at training-like widths (``TPU_SPECS``). Both run on
CUDA unless ``--device cpu`` is given. Beside each row stand JAX's last,
peak and pass from PARITY_r05.json, which is read and never written.
Each row names its run (date, device, the card's name and power limit from
nvidia-smi, torch and CUDA versions); PARITY_torch.json keeps the rows of
the other lane, and of other tasks, from earlier runs.

Run: python scripts/record_parity_torch.py [--card] [--only TaskA,TaskB]
     [--seeds 7,1,2] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

DRAWDOWN_FRAC = 0.4
SEED = 7        # scripts/record_parity.py's env and train seed

# (task, train_yaml_name, num_envs, epochs, floor, metric, direction):
# scripts/record_parity.py's rows. metric None is reward_mean; direction +1
# the metric must rise above the floor, -1 fall below it.
SPECS = [
    ("Cartpole", "CartpolePPO", 64, 60, 0.75, None, 1),
    ("Ant", "AntPPO", 64, 60, 0.55, None, 1),
    ("Gogoro", "GogoroPPO", 64, 50, 0.4, None, 1),
    ("Humanoid", "HumanoidPPO", 64, 60, 0.5, None, 1),
    ("AnymalTerrain", "AnymalTerrainPPO", 128, 150, 0.004, "env/rew_lin_vel_xy", 1),
    ("BallBalance", "BallBalancePPO", 64, 60, 0.1, None, 1),
    ("Trifinger", "TrifingerPPO", 64, 80, 0.17, "env/finger_obj_dist", -1),
    ("FrankaCabinet", "FrankaCabinetPPO", 64, 120, 0.42, "env/grasp_dist", -1),
    ("AllegroHand", "AllegroHandPPO", 64, 80, 0.45, "env/rot_dist", -1),
]

# the rows that need training-like widths (JAX's --tpu lane)
TPU_SPECS = [
    ("Trifinger", "TrifingerPPO", 1024, 2000, 0.15, "env/finger_obj_dist", -1),
    ("FrankaCabinet", "FrankaCabinetPPO", 512, 300, 0.42, "env/grasp_dist", -1),
    ("AllegroHand", "AllegroHandPPO", 4096, 2000, 0.02, "env/consecutive_successes", 1),
]

JAX_RECORD = os.path.join(ROOT, "PARITY_r05.json")
OUT = os.path.join(ROOT, "PARITY_torch.json")


def passes(curve: list, floor: float, sgn: int) -> dict:
    """JAX's pass rule (scripts/record_parity.py) on `curve`, a list of
    (epoch, value): the last point at or past the floor, a strict move
    from the first, and the drawdown bound where the peak beat the floor,
    all in sign-adjusted space. Returns {passed, last, first, peak}."""
    last, first = curve[-1][1], curve[0][1]
    s_last, s_first, s_floor = sgn * last, sgn * first, sgn * floor
    s_peak = max(sgn * v for _, v in curve)
    dd_ok = s_peak <= s_floor or s_last >= DRAWDOWN_FRAC * s_peak or s_peak <= 0
    return dict(passed=bool(s_last >= s_floor and dd_ok and s_last > s_first),
                last=last, first=first, peak=sgn * s_peak)


def card() -> str | None:
    """nvidia-smi's "name, power limit" of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def ppo_config(train_yaml: str, envs: int, **overrides):
    """cfg/train/<train_yaml>.yaml's PPOConfig, the minibatch capped at
    envs x horizon, float32, and `overrides`."""
    from thormang_isaacgym_tpu_torch.learn.ppo import PPOConfig
    from thormang_isaacgym_tpu_torch.utils.config import CFG_ROOT, load_yaml
    cfg = PPOConfig.from_rlgames(load_yaml(os.path.join(CFG_ROOT, "train", f"{train_yaml}.yaml")))
    return dataclasses.replace(cfg, minibatch_size=min(cfg.minibatch_size,
                                                       envs * cfg.horizon_length),
                               mixed_precision=False, **overrides)


def jax_row(task: str) -> dict | None:
    """JAX's recorded row of `task` in PARITY_r05.json: its width, lane,
    last, peak and pass."""
    with open(JAX_RECORD) as f:
        row = json.load(f)["tasks"].get(task)
    if row is None:
        return None
    return dict(num_envs=row["num_envs"], epochs=row["epochs"], platform=row["platform"],
                last=row["last_reward_mean"], peak=row["peak"], passed=row["passed"])


def run_row(spec: tuple, device, lane: str = "cpu", seed: int = SEED) -> dict:
    """Train one row of SPECS or TPU_SPECS on `device` with `seed` and
    judge it. Returns the row's record; a task whose asset is missing comes
    back ``{"skipped": reason}``."""
    from thormang_isaacgym_tpu_torch.learn.ppo import PPO
    from thormang_isaacgym_tpu_torch.tasks import make

    task, yaml_name, n, epochs, floor, metric, sgn = spec
    metric = metric or "reward_mean"
    ref = jax_row(task)
    t0 = time.time()
    try:
        env = make(task, num_envs=n, seed=seed, stagger_episodes=True, device=device)
    except FileNotFoundError as e:
        # the missing file by name: the record holds no host's paths
        reason = re.sub(r"/\S*/([^/\s;]+)", r"\1", str(e))
        return dict(train_cfg=yaml_name, num_envs=n, epochs=epochs, lane=lane, metric=metric,
                    direction=sgn, floor=floor, skipped=f"asset missing: {reason}", jax=ref)
    cfg = ppo_config(yaml_name, n, max_epochs=epochs)
    launches0 = env.physics_step.launches
    _, _, hist = PPO(env, cfg, device=device).train(epochs, seed=seed, log_every=5)
    curve = [(h["epoch"], round(h[metric], 4)) for h in hist]
    verdict = passes(curve, floor, sgn)
    return dict(
        train_cfg=yaml_name, num_envs=n, epochs=epochs, lane=lane, seed=seed,
        platform=env.device.type, metric=metric, direction=sgn, curve=curve,
        lr_kl=[(h["epoch"], round(h["lr"], 6), round(h["kl"], 5)) for h in hist],
        last=round(verdict["last"], 4), first=round(verdict["first"], 4),
        peak=round(verdict["peak"], 4), floor=floor, passed=verdict["passed"],
        substeps=env.task.sim_params.substeps, dt=env.task.sim_params.dt,
        kernel_launches=env.physics_step.launches - launches0,
        wall_s=round(time.time() - t0, 1), jax=ref)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--card", action="store_true", help="the rows of TPU_SPECS")
    ap.add_argument("--only", default=None, help="comma-separated task names")
    ap.add_argument("--seeds", default=str(SEED),
                    help="comma-separated seeds, the row's first (default JAX's)")
    ap.add_argument("--device", default=None, help="default cuda; cpu to run on the CPU")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    from thormang_isaacgym_tpu_torch.engine.env import resolve_device
    device = resolve_device(args.device)
    lane = "card" if args.card else "cpu"
    only = set(args.only.split(",")) if args.only else None
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = {}
    for spec in TPU_SPECS if args.card else SPECS:
        if only and spec[0] not in only:
            continue
        runs = []
        for seed in seeds:
            runs.append(run_row(spec, device, lane, seed))
            print(spec[0], json.dumps({k: v for k, v in runs[-1].items()
                                       if k not in ("curve", "lr_kl")}), flush=True)
        rows[spec[0]] = row = runs[0]
        if len(seeds) > 1 and "skipped" not in row:
            row["seed_runs"] = [{k: r[k] for k in ("seed", "last", "first", "peak", "passed",
                                                   "wall_s", "curve")} for r in runs]
    import torch
    run = dict(recorded=time.strftime("%F"), device=str(device), card=card(),
               torch=torch.__version__, cuda=torch.version.cuda)
    out = {"schema": "parity_curve_torch_v1", "drawdown_frac": DRAWDOWN_FRAC, "lanes": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    out["lanes"].setdefault(lane, {}).update({task: dict(row, run=run) for task, row in rows.items()})
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", os.path.abspath(args.out), flush=True)
    return out


if __name__ == "__main__":
    main()
