#!/usr/bin/env python3
"""Write a copy of the port package whose CUDA kernel leaves out, or adds,
named parts of the shared round-pair instance (``fused_step_kernel`` with
kPA and kSM in csrc/fused_step.cu), so that each part of its design can be
timed against the whole, on one card in one call:

    python3 scripts/kernel_variant.py --out DIR [--tree SRC] [--drop skip rows] [--add tables]
    python3 scripts/time_flat_kernel.py --tree DIR --task BallBalance

Parts it can leave out:
  skip    the warp-level skip of a ground or pair candidate out of contact in
          every env of the warp (the candidate's force block runs for all)
  rows    the staging of the env's input rows in shared memory (every
          substep reads them from the input slab)
Part it can add:
  tables  the copy of the model's two tables to the front of the block's
          shared memory, behind a barrier, as the instances without pairs
          do (the wrapper's shared bytes count them)

Every other instance compiles from the same source as in SRC (default: this
repository), and the variant computes the same outputs bit for bit (the
skip adds exact zeros; the rows and tables are the same words). Each edit
must match its file exactly once, or the script raises.
"""
from __future__ import annotations

import argparse
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "thormang_isaacgym_tpu_torch"
KERNEL = os.path.join("csrc", "fused_step.cu")
WRAPPER = os.path.join("ops", "fused.py")
PAIR_SM = "(kPA && kSM)"

DROP = {
    "skip": [
        (KERNEL, "if (kVote && phase == 1 && !((touch[c >> 5] >> (c & 31)) & 1u)) continue;",
         f"if (kVote && !{PAIR_SM} && phase == 1 && !((touch[c >> 5] >> (c & 31)) & 1u)) continue;"),
        (KERNEL, "if (kVote && !__any_sync(kFullWarp, !(depth <= 0.0f))) return;",
         f"if (kVote && !{PAIR_SM} && !__any_sync(kFullWarp, !(depth <= 0.0f))) return;"),
    ],
    "rows": [
        (KERNEL, "if (kSM) stage_rows(rows_s, in + b, rw.total, B);",
         f"if (kSM && !{PAIR_SM}) stage_rows(rows_s, in + b, rw.total, B);"),
        (KERNEL, "#define RD(r) (kSM ? rows_s[r] : in[(size_t)(r) * B + b])",
         f"#define RD(r) ((kSM && !{PAIR_SM}) ? rows_s[r] : in[(size_t)(r) * B + b])"),
    ],
}
ADD = {
    "tables": [
        (KERNEL, "constexpr bool kTables = kSM && !kPA;", "constexpr bool kTables = kSM;"),
        (WRAPPER, "tables=0 if self.pair_mode else len(mi) + len(mf),",
         "tables=len(mi) + len(mf),"),
    ],
}


def make_variant(src_tree: str, out: str, drop=(), add=()) -> str:
    """Copy src_tree's package to out (its build directory left behind) and
    apply the edits of each part in `drop` and `add`; returns the edited
    kernel source's path."""
    dst = os.path.join(out, PACKAGE)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(os.path.join(src_tree, PACKAGE), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for part in [*(DROP[p] for p in drop), *(ADD[p] for p in add)]:
        for rel, old, new in part:
            path = os.path.join(dst, rel)
            with open(path) as f:
                src = f.read()
            if src.count(old) != 1:
                raise ValueError(f"{old!r} found {src.count(old)} times in {path}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
    return os.path.join(dst, KERNEL)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out", required=True)
    ap.add_argument("--drop", nargs="+", choices=sorted(DROP), default=[])
    ap.add_argument("--add", nargs="+", choices=sorted(ADD), default=[])
    args = ap.parse_args()
    print(make_variant(os.path.abspath(args.tree), os.path.abspath(args.out), args.drop, args.add))


if __name__ == "__main__":
    main()
