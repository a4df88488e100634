#!/usr/bin/env python3
"""Time the fused CUDA kernel on Ant (its flat instance), BallBalance (its
pair instance, the round kinds and attractors), AllegroHand (its box
instance) or ShadowHand (the box instance with the tendon block) at the task
YAML's width (4096 envs; the hands 16384), from the port package found in a
given source tree, so two trees (a change and its parent) can be compared on
one card in one call.

    python3 scripts/time_flat_kernel.py [--tree DIR] [--task Ant|BallBalance|AllegroHand|ShadowHand] [--iters 300]

DIR is a checkout holding ``thormang_isaacgym_tpu_torch/`` (default: this
repository); its kernel is built there with nvcc. Prints one JSON line: the
tree, the card (nvidia-smi name and power limit), ms per control step (CUDA
events over `iters` launches after 30 of warm-up; the task YAML's sim block:
Ant dt 0.0166 s with 2 substeps and no torque rows, BallBalance dt 0.01 s
with 1 substep, its attractors and the lower legs' torque rows, as VecEnv
builds them, with the ball pressed into the tray; the hands dt 0.01667 s
with 2 substeps and the fingertips' torque rows, the cube pressed into the
palm and fingers as tests/test_torch_fused.py places it) and the ptxas
register and stack line of the instance. Run it for the two trees in turns
(parent, change, change, parent) to see the spread.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the instance's mangled name in either tree: the template <kHF, kPA> or,
# with the box instance, <kHF, kPA, kBX>
INSTANCE = {"Ant": ("kernelILb0ELb0EEEv", "kernelILb0ELb0ELb0EEEv"),
            "BallBalance": ("kernelILb0ELb1EEEv", "kernelILb0ELb1ELb0EEEv"),
            "AllegroHand": ("kernelILb0ELb1ELb1EEEv",),
            "ShadowHand": ("kernelILb0ELb1ELb1EEEv",)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--task", default="Ant", choices=sorted(INSTANCE))
    ap.add_argument("--iters", type=int, default=300)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from thormang_isaacgym_tpu_torch.ops import fused
    from thormang_isaacgym_tpu_torch.ops.sim import Controls
    from thormang_isaacgym_tpu_torch.tasks import apply_cfg_sim, get_task_class

    if not fused.__file__.startswith(tree):
        raise RuntimeError(f"imported {fused.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    import yaml
    with open(os.path.join(ROOT, "cfg", "task", f"{args.task}.yaml")) as f:
        cfg = yaml.safe_load(f)
    B, dev = int(cfg["env"]["numEnvs"]), torch.device("cuda")
    task = get_task_class(args.task)(num_envs=B, device=dev)
    apply_cfg_sim(task, cfg["sim"])
    m = task.model
    step = fused.build_fused_step_fn(m, task.sim_params,
                                     attractors=getattr(task, "attractors", None),
                                     need_torque=getattr(task, "net_torque_bodies", None) or False)
    rng = np.random.default_rng(1)
    if args.task == "Ant":
        q = np.zeros((B, m.nq), np.float32)
        q[:, 2] = task.spawn_z + rng.uniform(-0.1, 0.1, B)
        qr = rng.normal(size=(B, 4)) * 0.1 + [1.0, 0.0, 0.0, 0.0]
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        q[:, 7:] = task._init_jq + rng.uniform(-0.2, 0.2, (B, m.nj))
        qd = rng.normal(size=(B, m.nv)) * 0.5
        effort = rng.uniform(-15, 15, (B, m.nj))
    elif args.task in ("AllegroHand", "ShadowHand"):
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from test_torch_fused import allegro_contact_q, shadow_contact_q
        q = (shadow_contact_q if args.task == "ShadowHand" else allegro_contact_q)(m, rng, B)
        qd = rng.normal(size=(B, m.nv)) * 0.1
        effort = np.zeros((B, m.nj))
    else:
        from thormang_isaacgym_tpu_torch.tasks import ball_balance as bb
        # the bot at rest, the ball 0 to 1 cm into the tray top at a random point
        q = np.zeros((B, m.nq), np.float32)
        q[:, 2] = bb.TRAY_H
        q[:, 3] = q[:, 10] = 1.0
        q[:, 7:9] = rng.uniform(-0.25, 0.25, (B, 2))
        q[:, 9] = bb.TRAY_H + 0.5 * bb.TRAY_THICK + bb.BALL_R - rng.uniform(0.0, 0.01, B)
        qd = rng.normal(size=(B, m.nv)) * 0.3
        effort = np.zeros((B, m.nj))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    z = t(np.zeros((B, m.nj)))
    targets = z
    if args.task in ("AllegroHand", "ShadowHand"):
        lo, hi = m._defaults["dof_lower"], m._defaults["dof_upper"]
        targets = t(lo + (hi - lo) * rng.uniform(0.2, 0.8, (B, m.nj)))
    packed = step.pack(m.default_params(dev).batch(B), t(q), t(qd), Controls(targets, z, t(effort)),
                       t(np.zeros((B, m.nb, 6))))
    for _ in range(30):
        step.launch(packed)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.iters):
        step.launch(packed)
    end.record()
    torch.cuda.synchronize()
    log = fused.build_library().log.splitlines()
    at = [i for i, ln in enumerate(log) if "Compiling entry" in ln
          and any(n in ln for n in INSTANCE[args.task])]
    inst = [ln.strip() for ln in log[at[0]:at[0] + 4] if "stack" in ln or "registers" in ln] \
        if at else []
    print(json.dumps({"tree": os.path.relpath(tree, ROOT), "card": card, "task": args.task,
                      "envs": B, "iters": args.iters, "ms": start.elapsed_time(end) / args.iters,
                      "ptxas": inst}), flush=True)


if __name__ == "__main__":
    main()
