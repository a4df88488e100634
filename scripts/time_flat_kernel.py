#!/usr/bin/env python3
"""Time the fused CUDA kernel on Ant or Anymal (its flat instance),
HumanoidMJCF (the flat instance in its split layout: over the shared
budget; cfg/task/Humanoid.yaml; the local layout in a tree without it),
HumanoidAMP (the flat instance in its lean split layout: over the split
layout's budget too; the local layout in a tree without it),
AnymalTerrain (its heightfield instance), BallBalance (its pair instance,
the round kinds and attractors), the pair-capsule scene of chip_smoke.py
(the pair instance's sphere-capsule and capsule-capsule kinds, 4096 envs),
AllegroHand (its box instance), ShadowHand (the box instance with the
tendon block), FrankaCabinet, FrankaCubeStack, FactoryTaskNutBoltPick,
FactoryTaskNutBoltScrew, MA_OP3 or Trifinger (the box instance at
chip_smoke.py's widths: 4096, 8192, 128, 128, 4096 and 16384 envs, in the
contact states chip_smoke.py places them in, ``chip_smoke.random_inputs``)
at the task YAML's width (4096 envs; the hands 16384), from the port package
found in a
given source tree, so two trees (a change and its parent) can be compared on
one card in one call.

    python3 scripts/time_flat_kernel.py [--tree DIR] [--task Ant|Anymal|AnymalTerrain|BallBalance|PairCapsule|AllegroHand|ShadowHand|HumanoidMJCF|HumanoidAMP|FrankaCabinet|FrankaCubeStack|FactoryTaskNutBoltPick|FactoryTaskNutBoltScrew|MA_OP3|Trifinger]
        [--iters 300] [--envs N] [--block N [N ...]] [--local] [--lanes G [G ...]]
        [--split] [--stack] [--dump PATH]
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
places it; Anymal dt 0.02 s with 2 substeps on flat ground, placed as
AnymalTerrain is; HumanoidMJCF dt 0.0166 s with 2 substeps and the feet's
torque rows, standing at its spawn height with its joints and base tilted
and efforts of its motor gears; a tree without HumanoidMJCF cannot time it;
HumanoidAMP dt 0.0166 s with 2 substeps and the feet's torque rows (its
training step builds none), on the gait clip's states lowered onto the
ground as tests/test_torch_fused.py's ``amp_contact_state`` places them,
both soles down in half the envs, lying on the torso's capsule in an
eighth, PD targets near the joints),
the block size, layout and dynamic shared bytes of the launch,
the options' results and the ptxas register and stack line of the
instance. Run it for the two trees in turns (parent, change, change,
parent) to see the spread.

Options:
  --envs N   the width (default: the YAML's numEnvs).
  --block N [N ...]   the launch's block sizes (a tree whose wrapper has a
             ``block``): each is timed in turns, in the order given and
             then in reverse, under the wrapper's shared-memory budget
             rule; ``ms`` is the first one's first reading.
  --local    also time each block size with the budget set to 0, the
             local-memory route of a model over the budget (in turns with
             the layout the budget rule picks).
  --lanes G [G ...]   the box instance: each (G, block) of --lanes x
             --block is timed in turns as the forced geometry (G = 1 the
             local layout, else the wide layout with G lanes an env; block
             in threads), in the order given and then in reverse, and its
             outputs held bit for bit against the first's; without it the
             box instance's launches take ``pick_box_geometry``'s. --dump
             takes the first.
  --split    also time the same inputs with the pair table cut out (header
             int 39 set to 0), with the ground candidates cut out (header
             int 7), and with both: copies of the model tables, the kernel's
             source untouched. The differences give the pair phase, the
             ground phase and the rest (tree sweeps, drives, tendons). A
             model with tendons is also timed with the tendon loop cut out
             (header int 42 set to 0): the tendon block's own time, beside
             its bound (chip_smoke.py's OPS and peaks).
  --stack    device memory taken by the instance's first launch
             (torch.cuda.mem_get_info before and after): the local memory
             the CUDA runtime reserves for the per-thread stack frames.
  --dump P   save the kernel's output slab of one launch on the seeded
             inputs to P (.npy, (out_rows, envs) float32, with the row
             counts in P + ".json"), launched with the first --block
             size under the budget rule.
  --compare A B   the largest absolute difference between two dumps, per
             block of rows (q, qd, net force, torque), and whether they are
             equal bit for bit. Needs no card.
  --sass P   save ``cuobjdump -sass`` of the tree's kernel library to P.
  --compare-sass A B   per instance (its template flags, the layout last:
             0 local, 1 shared, 2 split, 3 lean split, 4 wide; a tree with a bool kSM flag gives 0
             or 1, one without it 0), whether two such files hold the same
             instructions, the function names aside. Needs no card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each task's instance (kHF, kPA, kBX)
INSTANCE = {"Ant": (0, 0, 0), "Anymal": (0, 0, 0), "AnymalTerrain": (1, 0, 0),
            "BallBalance": (0, 1, 0), "PairCapsule": (0, 1, 0), "AllegroHand": (0, 1, 1),
            "ShadowHand": (0, 1, 1), "HumanoidMJCF": (0, 0, 0), "HumanoidAMP": (0, 0, 0),
            "FrankaCabinet": (0, 1, 1), "FrankaCubeStack": (0, 1, 1),
            "FactoryTaskNutBoltPick": (0, 1, 1), "FactoryTaskNutBoltScrew": (0, 1, 1),
            "MA_OP3": (0, 1, 1), "Trifinger": (0, 1, 1)}
# the box instance's tasks at widths where its envs leave SMs idle, placed
# and driven as chip_smoke.py's phases place them
WIDE_TASKS = ("FrankaCabinet", "FrankaCubeStack", "FactoryTaskNutBoltPick",
              "FactoryTaskNutBoltScrew", "MA_OP3", "Trifinger")
_HEADER = 48
# the kernel's layouts by their codes (kLocal, kShared, kSplit, kSplitLean in
# csrc/fused_step.cu)
LAYOUT_CODES = {"local": 0, "shared": 1, "split": 2, "split_lean": 3, "wide": 4}
# the tasks whose cfg/task YAML carries another name (the port's tasks.CFG_NAMES;
# a parent tree may not have it)
CFG_NAMES = {"HumanoidMJCF": "Humanoid"}


def mangled(flags, layout: str) -> tuple:
    """The instance's mangled name in any tree: the template <kHF, kPA>,
    <kHF, kPA, kBX>, with the shared layout's flag <kHF, kPA, kBX, bool kSM>,
    or with the layout's code <kHF, kPA, kBX, int kLayout>."""
    def name(fl, last=""):
        return "kernelI" + "".join(f"Lb{int(f)}E" for f in fl) + last + "EEv"
    return (name(flags[:2]), name(flags), name((*flags, layout == "shared")),
            name(flags, f"Li{LAYOUT_CODES[layout]}E"))


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
    mi2[44], mi2[45] = len(mi2), len(mf2)       # the tables' lengths (unread by older trees)
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


def sass_instances(path: str) -> dict:
    """{template arguments: instruction lines} of a ``cuobjdump -sass``
    file, the layout last (a bool kSM as 0 or 1, the same codes as the int
    kLayout's local and shared; an instance without either counts as 0)."""
    out, key = {}, None
    for ln in open(path):
        if "Function :" in ln:
            args = re.search(r"kernelI((?:L[bi]\d+E)+)E", ln).group(1)
            key = "".join(re.findall(r"L[bi](\d+)E", args)).ljust(4, "0")
            out[key] = []
        elif key is not None and ln.strip():
            out[key].append(ln.strip())
    return out


def compare_sass(a_path: str, b_path: str) -> dict:
    a, b = sass_instances(a_path), sass_instances(b_path)
    return {"a": a_path, "b": b_path, "instances": {
        k: {"identical": a.get(k) == b.get(k), "lines": [len(a.get(k, [])), len(b.get(k, []))]}
        for k in sorted(set(a) | set(b))}}


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
    if name == "HumanoidMJCF":
        q = np.zeros((B, m.nq), np.float32)
        q[:, 2] = task.spawn_z + rng.uniform(-0.05, 0.05, B)
        qr = rng.normal(size=(B, 4)) * 0.1 + [1.0, 0.0, 0.0, 0.0]
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        lo, hi = m._defaults["dof_lower"], m._defaults["dof_upper"]
        q[:, 7:] = np.clip(task._init_jq + rng.uniform(-0.2, 0.2, (B, m.nj)), lo, hi)
        gears = task.motor_efforts.cpu().numpy()
        return q, rng.normal(size=(B, m.nv)) * 0.5, z, rng.uniform(-1, 1, (B, m.nj)) * gears
    if name == "HumanoidAMP":
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from test_torch_fused import amp_contact_state
        q, qd = amp_contact_state(task, rng, B)
        # as in training: PD targets near the joints, no effort
        return q, qd, q[:, 7:] + rng.normal(size=(B, m.nj)) * 0.05, z
    if name in ("AllegroHand", "ShadowHand"):
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from test_torch_fused import allegro_contact_q, shadow_contact_q
        q = (shadow_contact_q if name == "ShadowHand" else allegro_contact_q)(m, rng, B)
        qd = rng.normal(size=(B, m.nv)) * 0.1
        lo, hi = m._defaults["dof_lower"], m._defaults["dof_upper"]
        return q, qd, lo + (hi - lo) * rng.uniform(0.2, 0.8, (B, m.nj)), z
    if name in ("AnymalTerrain", "Anymal"):
        # bases over tiles of every level and type (Anymal: at the origin),
        # feet near the ground
        o = np.zeros((B, 3))
        if name == "AnymalTerrain":
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
    ap.add_argument("--block", type=int, nargs="+", default=[])
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--lanes", type=int, nargs="+", default=[])
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--stack", action="store_true")
    ap.add_argument("--dump", default="")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--sass", default="")
    ap.add_argument("--compare-sass", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)), flush=True)
        return
    if args.compare_sass:
        print(json.dumps(compare_sass(*args.compare_sass)), flush=True)
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
    dev = torch.device("cuda")
    if args.task == "PairCapsule":
        # chip_smoke.py's pair-capsule scene and inputs, at its width
        sys.path.insert(0, ROOT)
        import chip_smoke
        if args.envs not in (0, chip_smoke.B):
            raise ValueError(f"PairCapsule runs at {chip_smoke.B} envs")
        B, task = chip_smoke.B, chip_smoke.PairCapsule()
        m = task.model
        step = fused.build_fused_step_fn(m, task.sim_params)
        packed = step.pack(*chip_smoke.pair_capsule_inputs(m, np.random.default_rng(1), dev))
    elif args.task in WIDE_TASKS:
        # chip_smoke.py's task at its width and sim block, its contact state
        # and controls, the torque rows of the task's sensor bodies
        sys.path.insert(0, ROOT)
        import chip_smoke
        if args.envs:
            chip_smoke.ENVS[args.task] = args.envs
        task = chip_smoke._task(args.task, dev)
        B, m = task.num_envs, task.model
        step = fused.build_fused_step_fn(m, task.sim_params,
                                         need_torque=getattr(task, "net_torque_bodies", None) or False)
        packed = step.pack(*chip_smoke.random_inputs(task, np.random.default_rng(1), dev))
    else:
        import yaml
        with open(os.path.join(ROOT, "cfg", "task",
                               f"{CFG_NAMES.get(args.task, args.task)}.yaml")) as f:
            cfg = yaml.safe_load(f)
        B = args.envs or int(cfg["env"]["numEnvs"])
        task = get_task_class(args.task)(num_envs=B, device=dev)
        apply_cfg_sim(task, cfg["sim"])
        m = task.model
        ground = task.ground_height_fn() if hasattr(task, "ground_height_fn") else 0.0
        tq = getattr(task, "net_torque_bodies", None) or False
        if args.task == "HumanoidAMP":
            tq = tuple(m.body_id(f) for f in ("right_foot", "left_foot"))
        step = fused.build_fused_step_fn(m, task.sim_params, ground=ground,
                                         attractors=getattr(task, "attractors", None),
                                         need_torque=tq)
        q, qd, targets, effort = task_inputs(args.task, task, B, np.random.default_rng(1))

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        z = t(np.zeros((B, m.nj)))
        packed = step.pack(m.default_params(dev).batch(B), t(q), t(qd),
                           Controls(t(targets), z, t(effort)), t(np.zeros((B, m.nb, 6))))
    lib = fused.load_library()
    if args.sass:
        with open(args.sass, "w") as f:
            subprocess.run([os.path.join(os.path.dirname(fused._nvcc()), "cuobjdump"), "-sass",
                            lib._name], stdout=f, check=True)
    layouts = {}
    if args.lanes:
        # the box instance's geometries, forced in turns
        for blk in args.block or [128]:
            for g in args.lanes:
                layouts[f"{g}x{blk}"] = ("local" if g == 1 else "wide", g, blk)
        step.force_geometry = next(iter(layouts.values()))
    elif args.block or args.local:
        if not hasattr(step, "block"):
            raise RuntimeError(f"the wrapper in {tree} has no block size to set")
        budget = fused.SMEM_BUDGET
        for blk in args.block or [step.block]:
            layouts[str(blk)] = (blk, budget)
            if args.local:
                layouts[f"{blk}/local"] = (blk, 0)
        step.block, fused.SMEM_BUDGET = next(iter(layouts.values()))
    stack = {}
    if args.stack:
        sys.path.insert(0, ROOT)
        from chip_smoke import first_launch_bytes
        stack = dict(first_launch_bytes=first_launch_bytes(step, packed))
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

    def geometry() -> dict:
        """The launch's geometry: layout, lanes, block, shared bytes, blocks
        (a tree before the wide layout: its block and layout)."""
        if hasattr(step, "launch_geometry"):
            layout, lanes, block, smem = step.launch_geometry(B)
            return dict(layout=layout, lanes=lanes, block=block, smem_bytes=smem,
                        blocks=-(-B * lanes // block))
        block = getattr(step, "block", 128)
        smem = getattr(step, "smem_bytes", 0)
        return dict(layout=getattr(step, "layout", "shared" if smem else "local"), lanes=1,
                    block=block, smem_bytes=smem, blocks=-(-B // block))

    def set_layout(key):
        if args.lanes:
            step.force_geometry = layouts[key]
        else:
            step.block, fused.SMEM_BUDGET = layouts[key]

    turns, first = {}, None
    for key in [*layouts, *reversed(layouts)]:
        set_layout(key)
        if key not in turns:
            # its outputs on the seeded inputs against the first geometry's
            got = step.launch(packed).view(torch.int32).clone()
            first = got if first is None else first
            turns[key] = dict(geometry(), bitwise_equal_to_first=bool(torch.equal(got, first)), ms=[])
        turns[key]["ms"].append(time_ms())
    if layouts:
        set_layout(next(iter(layouts)))
    ms = {"as_is": next(iter(turns.values()))["ms"][0] if turns else time_ms()}
    tendon = {}
    if args.split:
        full = step._tables
        cuts = {key: strip_tables(*full, **kw) for key, kw in (
            ("no_pairs", dict(pairs=True, ground=False)),
            ("no_ground", dict(pairs=False, ground=True)),
            ("neither", dict(pairs=True, ground=True)))}
        if m.tendons:
            mi2 = full[0].copy()
            mi2[42] = 0                            # no tendon: the loop runs no iteration
            cuts["no_tendons"] = (mi2, full[1])
        for key, tables in cuts.items():
            step._tables, step._dev_tables = tables, {}
            ms[key] = time_ms()
        step._tables, step._dev_tables = full, {}
        ms["pair_phase"] = ms["as_is"] - ms["no_pairs"]
        ms["ground_phase"] = ms["as_is"] - ms["no_ground"]
        if m.tendons:
            sys.path.insert(0, ROOT)
            from chip_smoke import tendon_bound
            ms["tendon_block"] = ms["as_is"] - ms["no_tendons"]
            tendon = dict(tendon_bound=tendon_bound(m, step.n_steps, B))
    geo = geometry()
    log = fused.build_library().log.splitlines()

    def ptxas(layout: str) -> list:
        names = mangled(INSTANCE[args.task], layout)
        at = [i for i, ln in enumerate(log) if "Compiling entry" in ln
              and any(n in ln for n in names)]
        return [ln.strip() for ln in log[at[0]:at[0] + 4] if "stack" in ln or "registers" in ln] \
            if at else []

    inst = ptxas(geo["layout"])
    for turn in turns.values():
        turn["ptxas"] = ptxas(turn["layout"])
    print(json.dumps({"tree": os.path.relpath(tree, ROOT), "card": card, "task": args.task,
                      "envs": B, "iters": args.iters, "ms": ms["as_is"], **geo,
                      **({"layouts": turns} if turns else {}),
                      **({"split_ms": ms} if args.split else {}), **tendon, **stack,
                      "ptxas": inst}), flush=True)


if __name__ == "__main__":
    main()
