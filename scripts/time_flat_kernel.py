#!/usr/bin/env python3
"""Time the fused CUDA kernel on Ant (its flat instance), AnymalTerrain (its
heightfield instance), BallBalance (its pair instance, the round kinds and
attractors), AllegroHand (its box instance) or ShadowHand (the box instance
with the tendon block) at the task YAML's width (4096 envs; the hands
16384), from the port package found in a given source tree, so two trees (a
change and its parent) can be compared on one card in one call.

    python3 scripts/time_flat_kernel.py [--tree DIR] [--task Ant|AnymalTerrain|BallBalance|AllegroHand|ShadowHand]
        [--iters 300] [--envs N] [--split] [--stack] [--dump PATH]
    python3 scripts/time_flat_kernel.py --compare A.npy B.npy

DIR is a checkout holding ``thormang_isaacgym_tpu_torch/`` (default: this
repository); its kernel is built there with nvcc. Prints one JSON line:
the tree, the card (nvidia-smi name and power limit), ms per
control step (CUDA events over `iters` launches after 30 of warm-up; the
task YAML's sim block: Ant dt 0.0166 s with 2 substeps and no torque rows,
AnymalTerrain 4 substeps of 0.005 s over its terrain with the bases placed on
the grid, BallBalance dt 0.01 s with 1 substep, its attractors and the lower
legs' torque rows, as VecEnv builds them, with the ball pressed into the
tray; the hands dt 0.01667 s with 2 substeps and the fingertips' torque rows,
the cube pressed into the palm and fingers as tests/test_torch_fused.py
places it), the options' results and the ptxas register and stack line of
the instance. Run it for the two trees in turns (parent, change, change,
parent) to see the spread.

Options:
  --envs N   the width (default: the YAML's numEnvs).
  --split    also time the same inputs with the pair table cut out (header
             int 39 set to 0), with the ground candidates cut out (header
             int 7), and with both: copies of the model tables, the kernel's
             source untouched. The differences give the pair phase, the
             ground phase and the rest (tree sweeps, drives, tendons).
  --stack    device memory taken by the instance's first launch
             (torch.cuda.mem_get_info before and after): the local memory
             the CUDA runtime reserves for the per-thread stack frames.
  --dump P   save the kernel's output slab of one launch on the seeded
             inputs to P (.npy, (out_rows, envs) float32, with the row
             counts in P + ".json").
  --compare A B   the largest absolute difference between two dumps, per
             block of rows (q, qd, net force, torque), and whether they are
             equal bit for bit. Needs no card.
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
            "AnymalTerrain": ("kernelILb1ELb0EEEv", "kernelILb1ELb0ELb0EEEv"),
            "BallBalance": ("kernelILb0ELb1EEEv", "kernelILb0ELb1ELb0EEEv"),
            "AllegroHand": ("kernelILb0ELb1ELb1EEEv",),
            "ShadowHand": ("kernelILb0ELb1ELb1EEEv",)}
_HEADER = 48


def strip_tables(mi: np.ndarray, mf: np.ndarray, *, pairs: bool, ground: bool):
    """Copies of the kernel's (int, float) tables with the pair table
    (header int 39) and / or the ground contact candidates (header int 7)
    cut out and their counts set to 0; the other sections shift down, as
    ``kernel_tables`` would lay out a model without them. The floats per
    pair (either tree's layout) follow from the table's length."""
    nb, nj, nr, nc, npairs, na, nt = (int(mi[k]) for k in (0, 1, 2, 7, 39, 40, 42))
    cut_i, cut_f = [], []
    i_cand = _HEADER + nb + nj + nr                    # cand_body, cand_geom, cand_rim
    f_cand = _HEADER + 10 * nj + 7 * nr                # gpos, gquat, off, r
    i_pair = i_cand + 3 * nc + nb                      # after tq_slot
    f_pair = f_cand + 11 * nc
    n_terms = int(mi[i_pair + 6 * npairs + nb + na + nt])     # the tendon table's end
    pair_floats = (len(mf) - f_pair - 9 * na - 2 * nt - n_terms) // max(npairs, 1)
    if ground:
        cut_i.append((i_cand, 3 * nc))
        cut_f.append((f_cand, 11 * nc))
    if pairs:
        cut_i.append((i_pair, 6 * npairs))
        cut_f.append((f_pair, pair_floats * npairs))

    def cut(a, spans):
        keep = np.ones(len(a), bool)
        for start, n in spans:
            keep[start:start + n] = False
        return a[keep].copy()

    mi2, mf2 = cut(mi, cut_i), cut(mf, cut_f)
    if ground:
        mi2[7] = 0
    if pairs:
        mi2[39] = 0
    return mi2, mf2


def compare(a_path: str, b_path: str) -> dict:
    a, b = np.load(a_path), np.load(b_path)
    with open(a_path + ".json") as f:
        meta = json.load(f)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    nq, nv, nb = meta["nq"], meta["nv"], meta["nb"]
    blocks = dict(q=(0, nq), qd=(nq, nq + nv), net_force=(nq + nv, nq + nv + 3 * nb),
                  torque=(nq + nv + 3 * nb, a.shape[0]))
    out = {}
    for k, (lo, hi) in blocks.items():
        d = np.abs(a[lo:hi].astype(np.float64) - b[lo:hi].astype(np.float64))
        out[k] = float(np.nanmax(d)) if d.size else 0.0
    return dict(a=a_path, b=b_path, task=meta["task"], envs=a.shape[1], max_abs_diff=out,
                max_abs_diff_all=max(out.values()),
                bitwise_equal=bool(np.array_equal(a.view(np.uint32), b.view(np.uint32))),
                nan_count=[int(np.isnan(a).sum()), int(np.isnan(b).sum())])


def task_inputs(name, task, B, rng):
    """Seeded (q, qd, targets, effort) for `task`'s model (numpy)."""
    m = task.model
    z = np.zeros((B, m.nj))
    if name == "Ant":
        q = np.zeros((B, m.nq), np.float32)
        q[:, 2] = task.spawn_z + rng.uniform(-0.1, 0.1, B)
        qr = rng.normal(size=(B, 4)) * 0.1 + [1.0, 0.0, 0.0, 0.0]
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        q[:, 7:] = task._init_jq + rng.uniform(-0.2, 0.2, (B, m.nj))
        return q, rng.normal(size=(B, m.nv)) * 0.5, z, rng.uniform(-15, 15, (B, m.nj))
    if name in ("AllegroHand", "ShadowHand"):
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from test_torch_fused import allegro_contact_q, shadow_contact_q
        q = (shadow_contact_q if name == "ShadowHand" else allegro_contact_q)(m, rng, B)
        qd = rng.normal(size=(B, m.nv)) * 0.1
        lo, hi = m._defaults["dof_lower"], m._defaults["dof_upper"]
        return q, qd, lo + (hi - lo) * rng.uniform(0.2, 0.8, (B, m.nj)), z
    if name == "AnymalTerrain":
        # bases over tiles of every level and type, feet near the ground
        lev = rng.integers(0, task.num_levels, B)
        typ = rng.integers(0, task.num_types, B)
        o = task.grid.env_origins[lev, typ]
        q = np.zeros((B, m.nq), np.float32)
        q[:, 0:2] = o[:, 0:2] + rng.uniform(-0.5, 0.5, (B, 2))
        q[:, 2] = o[:, 2] + 0.53 + rng.uniform(-0.05, 0.05, B)
        qr = rng.normal(size=(B, 4)) * 0.05 + [1.0, 0.0, 0.0, 0.0]
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        dflt = task.default_dof_pos.cpu().numpy()
        q[:, 7:] = dflt + rng.uniform(-0.3, 0.3, (B, m.nj))
        qd = rng.normal(size=(B, m.nv)) * 0.5
        return q, qd, dflt + rng.normal(size=(B, m.nj)) * 0.2, z
    from thormang_isaacgym_tpu_torch.tasks import ball_balance as bb
    # the bot at rest, the ball 0 to 1 cm into the tray top at a random point
    q = np.zeros((B, m.nq), np.float32)
    q[:, 2] = bb.TRAY_H
    q[:, 3] = q[:, 10] = 1.0
    q[:, 7:9] = rng.uniform(-0.25, 0.25, (B, 2))
    q[:, 9] = bb.TRAY_H + 0.5 * bb.TRAY_THICK + bb.BALL_R - rng.uniform(0.0, 0.01, B)
    return q, rng.normal(size=(B, m.nv)) * 0.3, z, z


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--task", default="Ant", choices=sorted(INSTANCE))
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--envs", type=int, default=0)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--stack", action="store_true")
    ap.add_argument("--dump", default="")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)), flush=True)
        return
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
    B, dev = args.envs or int(cfg["env"]["numEnvs"]), torch.device("cuda")
    task = get_task_class(args.task)(num_envs=B, device=dev)
    apply_cfg_sim(task, cfg["sim"])
    m = task.model
    ground = task.ground_height_fn() if hasattr(task, "ground_height_fn") else 0.0
    step = fused.build_fused_step_fn(m, task.sim_params, ground=ground,
                                     attractors=getattr(task, "attractors", None),
                                     need_torque=getattr(task, "net_torque_bodies", None) or False)
    q, qd, targets, effort = task_inputs(args.task, task, B, np.random.default_rng(1))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    z = t(np.zeros((B, m.nj)))
    packed = step.pack(m.default_params(dev).batch(B), t(q), t(qd), Controls(t(targets), z, t(effort)),
                       t(np.zeros((B, m.nb, 6))))
    fused.load_library()
    stack = {}
    if args.stack:
        # the output's block is allocated and freed first, so the launch's own
        # torch.empty reuses it and the difference is the stack reservation alone
        buf = torch.empty(step.out_rows, B, device=dev)
        del buf
        torch.cuda.synchronize()
        free0 = torch.cuda.mem_get_info()[0]
        step.launch(packed)
        torch.cuda.synchronize()
        free1 = torch.cuda.mem_get_info()[0]
        stack = dict(first_launch_bytes=free0 - free1)
    if args.dump:
        out = step.launch(packed)
        torch.cuda.synchronize()
        np.save(args.dump, out.cpu().numpy())
        with open(args.dump + ".json", "w") as f:
            json.dump(dict(task=args.task, tree=os.path.relpath(tree, ROOT), nq=m.nq, nv=m.nv,
                           nb=m.nb), f)

    def time_ms() -> float:
        for _ in range(30):
            step.launch(packed)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            step.launch(packed)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    ms = {"as_is": time_ms()}
    if args.split:
        full = step._tables
        for key, kw in (("no_pairs", dict(pairs=True, ground=False)),
                        ("no_ground", dict(pairs=False, ground=True)),
                        ("neither", dict(pairs=True, ground=True))):
            step._tables = strip_tables(*full, **kw)
            step._dev_tables = {}
            ms[key] = time_ms()
        step._tables, step._dev_tables = full, {}
        ms["pair_phase"] = ms["as_is"] - ms["no_pairs"]
        ms["ground_phase"] = ms["as_is"] - ms["no_ground"]
    log = fused.build_library().log.splitlines()
    at = [i for i, ln in enumerate(log) if "Compiling entry" in ln
          and any(n in ln for n in INSTANCE[args.task])]
    inst = [ln.strip() for ln in log[at[0]:at[0] + 4] if "stack" in ln or "registers" in ln] \
        if at else []
    print(json.dumps({"tree": os.path.relpath(tree, ROOT), "card": card, "task": args.task,
                      "envs": B, "iters": args.iters, "ms": ms["as_is"],
                      **({"split_ms": ms} if args.split else {}), **stack,
                      "ptxas": inst}), flush=True)


if __name__ == "__main__":
    main()
