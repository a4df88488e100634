#!/usr/bin/env python3
"""Write a copy of the port package whose CUDA kernel leaves out, or adds,
named parts of the shared round-pair instance (``fused_step_kernel`` with
kPA and kSM in csrc/fused_step.cu), or places the split layouts' state
otherwise, so that each part of a design can be timed against the whole, on
one card in one call:

    python3 scripts/kernel_variant.py --out DIR [--tree SRC] [--drop skip rows split_skip]
        [--add tables] [--place B|C|notables|rows|lean_rl]
    python3 scripts/time_flat_kernel.py --tree DIR --task BallBalance|HumanoidMJCF|HumanoidAMP

Parts it can leave out:
  skip    the warp-level skip of a ground or pair candidate out of contact in
          every env of the warp (the candidate's force block runs for all)
  rows    the staging of the env's input rows in shared memory (every
          substep reads them from the input slab)
  split_skip   the split instance's warp-level skip of a ground candidate
          out of contact in every env of the warp
Part it can add:
  tables  the copy of the model's two tables to the front of the block's
          shared memory, behind a barrier, as the instances without pairs
          do (the wrapper's shared bytes count them)
Other placements of the split layout (``kSplit``: the model's tables,
the sweep state and the candidates' kept state in shared memory, but the
articulated inertias IA, 21 words a body, in per-thread local memory, and
the input rows in device memory):
  B       IA in shared memory, the joint rotations Rl (9 words a joint)
          local, the tables in device memory
  C       IA in shared memory, the tables in device memory, the
          candidates' state recomputed in the contact's second pass: the
          sweep state alone in shared memory, no local array
  notables   the tables in device memory
  rows    the body rows (mass, com, inertia, gravity scale: 11 a body)
          staged in shared memory too, the other rows in device memory
Another placement of the lean split layout (``kSplitLean``: the split
layout's, but the candidates' state recomputed in the contact's second
pass instead of kept):
  lean_rl  the candidates' state kept in shared memory, the joint rotations
          Rl (9 words a joint) local, beside IA

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
DROP["split_skip"] = [
    (KERNEL, "if (kVote && phase == 1 && !((touch[c >> 5] >> (c & 31)) & 1u)) continue;",
     "if (kVote && kLayout != kSplit && phase == 1 && !((touch[c >> 5] >> (c & 31)) & 1u)) continue;"),
]
# the split layout's placement (csrc/fused_step.cu, ops/fused.py): the
# articulated inertias local, the tables and the candidates' kept state in
# shared memory, the input rows in device memory
IA_LOCAL = (KERNEL, "SymI (&IA)[MAXB] = kSM ? carve", "SymI (&IA)[MAXB] = kSW ? carve")
NO_TABLES = (KERNEL, "constexpr bool kTables = kSW && !kPA;", "constexpr bool kTables = kSM && !kPA;")
SPLIT_WORDS = (KERNEL, "  return (lane_words(nb, nj, nq, nv, nc, false, 0, 0) - 21 * nb) | 1;")
SPLIT_WORDS_PY = (WRAPPER, "    return (sweep_lane_words(nb, nj, nq, nv, nc) - 21 * nb) | 1")
SPLIT_TABLES_PY = (WRAPPER, "    return 4 * (tables + block * split_lane_words(nb, nj, nq, nv, nc))",
                   "    return 4 * block * split_lane_words(nb, nj, nq, nv, nc)")
PLACE = {
    "B": [
        IA_LOCAL, NO_TABLES, SPLIT_TABLES_PY,
        (KERNEL, "float (&Rl)[MAXB][9] = kSW ? carve", "float (&Rl)[MAXB][9] = kSM ? carve"),
        (*SPLIT_WORDS, "  return (lane_words(nb, nj, nq, nv, nc, false, 0, 0) - 9 * nj) | 1;"),
        (*SPLIT_WORDS_PY, "    return (sweep_lane_words(nb, nj, nq, nv, nc) - 9 * nj) | 1"),
    ],
    "C": [
        IA_LOCAL, NO_TABLES, SPLIT_TABLES_PY,
        (KERNEL, "constexpr bool kKept = kSW && kLayout != kSplitLean;", "constexpr bool kKept = kSM;"),
        (*SPLIT_WORDS, "  return lane_words(nb, nj, nq, nv, 0, false, 0, 0);"),
        (*SPLIT_WORDS_PY, "    return sweep_lane_words(nb, nj, nq, nv, 0)"),
    ],
    "notables": [NO_TABLES, SPLIT_TABLES_PY],
    "rows": [
        (KERNEL, "float* const rows_s = kSM ? carve<1, float>(sp, rw.total) : nullptr;",
         "float* const rows_s = kSM ? carve<1, float>(sp, rw.total)\n"
         "                           : kSW ? carve<1, float>(sp, 11 * nb) : nullptr;"),
        (KERNEL, "if (kSM) stage_rows(rows_s, in + b, rw.total, B);",
         "if (kSM) stage_rows(rows_s, in + b, rw.total, B);\n"
         "  else if (kSW) stage_rows(rows_s, in + (size_t)rw.mass * B + b, 11 * nb, B);"),
        (KERNEL, "#define RD(r) (kSM ? rows_s[r] : in[(size_t)(r) * B + b])",
         "#define RD(r) (kSM ? rows_s[r] : (kSW && (unsigned)((r) - rw.mass) < 11u * nb) "
         "? rows_s[(r) - rw.mass] : in[(size_t)(r) * B + b])"),
        (*SPLIT_WORDS, "  return (lane_words(nb, nj, nq, nv, nc, false, 11 * nb, 0) - 21 * nb) | 1;"),
        (*SPLIT_WORDS_PY, "    return (sweep_lane_words(nb, nj, nq, nv, nc, rows=11 * nb) - 21 * nb) | 1"),
    ],
}
# the lean split layout's other placement (``kSplitLean``: the split
# layout's without the candidates' kept state, recomputed in the contact's
# second pass): the kept state in shared memory and the joint rotations Rl
# local instead
PLACE["lean_rl"] = [
    (KERNEL, "constexpr bool kKept = kSW && kLayout != kSplitLean;", "constexpr bool kKept = kSW;"),
    (KERNEL, "float (&Rl)[MAXB][9] = kSW ? carve",
     "float (&Rl)[MAXB][9] = kSW && kLayout != kSplitLean ? carve"),
    (KERNEL, "  return split_lane_words(nb, nj, nq, nv, 0);",
     "  return (split_lane_words(nb, nj, nq, nv, nc) - 9 * nj) | 1;"),
    (WRAPPER, "    return split_lane_words(nb, nj, nq, nv, 0)",
     "    return (split_lane_words(nb, nj, nq, nv, nc) - 9 * nj) | 1"),
]
ADD = {
    "tables": [
        (KERNEL, "constexpr bool kTables = kSM && !kPA;", "constexpr bool kTables = kSM;"),
        (WRAPPER, "tables=0 if self.pair_mode else len(mi) + len(mf),",
         "tables=len(mi) + len(mf),"),
    ],
}


def make_variant(src_tree: str, out: str, drop=(), add=(), place=None) -> str:
    """Copy src_tree's package and assets to out (its build directory left behind) and
    apply the edits of each part in `drop` and `add` and of the placement
    `place`; returns the edited kernel source's path."""
    dst = os.path.join(out, PACKAGE)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(os.path.join(src_tree, PACKAGE), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    # the tasks' model files (HumanoidMJCF's MJCF), found beside the package
    shutil.copytree(os.path.join(src_tree, "assets"), os.path.join(out, "assets"), dirs_exist_ok=True)
    for part in [*(DROP[p] for p in drop), *(ADD[p] for p in add), *([PLACE[place]] if place else [])]:
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
    ap.add_argument("--place", choices=sorted(PLACE))
    args = ap.parse_args()
    print(make_variant(os.path.abspath(args.tree), os.path.abspath(args.out), args.drop, args.add,
                       args.place))


if __name__ == "__main__":
    main()
