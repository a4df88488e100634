#!/usr/bin/env python3
"""Time the fused CUDA kernel's flat-ground instance on Ant at 4096 envs, from
the port package found in a given source tree, so two trees (a change and its
parent) can be compared on one card in one call.

    python3 scripts/time_flat_kernel.py [--tree DIR] [--iters 300]

DIR is a checkout holding ``thormang_isaacgym_tpu_torch/`` (default: this
repository); its kernel is built there with nvcc. Prints one JSON line: the
tree, the card (nvidia-smi name and power limit), ms per control step (CUDA
events over `iters` launches after 30 of warm-up; Ant.yaml's sim block: dt
0.0166 s, 2 substeps; no torque rows, as VecEnv builds it) and the ptxas
register and stack line of the flat instance. Run it for the two trees in
turns (parent, change, change, parent) to see the spread.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--iters", type=int, default=300)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from thormang_isaacgym_tpu_torch.ops import fused
    from thormang_isaacgym_tpu_torch.ops.sim import Controls
    from thormang_isaacgym_tpu_torch.tasks import apply_cfg_sim
    from thormang_isaacgym_tpu_torch.tasks.ant import Ant

    if not fused.__file__.startswith(tree):
        raise RuntimeError(f"imported {fused.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    import yaml
    B, dev = 4096, torch.device("cuda")
    task = Ant(num_envs=B, device=dev)
    with open(os.path.join(ROOT, "cfg", "task", "Ant.yaml")) as f:
        apply_cfg_sim(task, yaml.safe_load(f)["sim"])
    m = task.model
    step = fused.build_fused_step_fn(m, task.sim_params, need_torque=False)
    rng = np.random.default_rng(1)
    q = np.zeros((B, m.nq), np.float32)
    q[:, 2] = task.spawn_z + rng.uniform(-0.1, 0.1, B)
    qr = rng.normal(size=(B, 4)) * 0.1 + [1.0, 0.0, 0.0, 0.0]
    q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
    q[:, 7:] = task._init_jq + rng.uniform(-0.2, 0.2, (B, m.nj))
    qd = rng.normal(size=(B, m.nv)) * 0.5

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    z = t(np.zeros((B, m.nj)))
    packed = step.pack(m.default_params(dev).batch(B), t(q), t(qd),
                       Controls(z, z, t(rng.uniform(-15, 15, (B, m.nj)))),
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
    # the flat instance: fused_step_kernel<false> (one ground flag) or <false, false>
    log = fused.build_library().log.splitlines()
    at = [i for i, ln in enumerate(log) if "Compiling entry" in ln
          and ("kernelILb0EEEv" in ln or "kernelILb0ELb0EEEv" in ln)]
    flat = [ln.strip() for ln in log[at[0]:at[0] + 4] if "stack" in ln] if at else []
    print(json.dumps({"tree": os.path.relpath(tree, ROOT), "card": card, "task": "Ant", "envs": B,
                      "iters": args.iters, "ms": start.elapsed_time(end) / args.iters,
                      "ptxas_flat": flat[:1]}), flush=True)


if __name__ == "__main__":
    main()
