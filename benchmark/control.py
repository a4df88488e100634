"""Readings of the numbers that decide ``correct``, on the card at a cell's
own size, to set and check their limits (``limits/<cell>.json``): the
program on many seeds (the lower readings), the control on the same seeds
(the reference in the precision one step below the cell's: TF32 for a
float32 learner, fp8 operands for a bf16 one, against the reference), a
witness of sound arithmetic in another order (every dense layer's product
summed from two halves, against the reference) on the same seeds, and each
planted fault (``harness/faults.py``) on a few seeds. One process per
cell; each reading is one JSON line, on standard output and in `--out`.

    python3 benchmark/control.py --workload shadowhand-ppo --seeds 11,12,13 \\
        --faults half_batch,skip_reset --fault-seeds 14,15,16 --seconds 10

The benchmark's own runs do not run this."""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
sys.path.insert(0, ROOT)


def control_kind(c: dict) -> str:
    conf = c["traffic"]["train_cfg"]["params"]["config"]
    return "fp8" if conf.get("mixed_precision") else "tf32"


def reading(c: dict, seed: int, device: str, fault: str | None, control: str | None,
            seconds: float = 0.0, witness: bool = False) -> dict:
    """One reading: set-up (with `fault` planted), `seconds` of iterations
    as the window runs them, the iteration after the window, and the
    numbers of the run, with the control's and the witness's learner
    numbers where asked."""
    import torch

    from benchmark.harness import cell, check

    t0 = time.perf_counter()
    env, ppo, ts, env_state, rec = cell.setup(c, seed, device, fault)
    if seconds > 0:
        ts, env_state, *_ = cell.window(ppo, ts, env_state, seconds, cell.FOLLOWED + 1, device)
    ts, env_state = cell.reset_iteration(env, ppo, ts, env_state, rec)
    del env, ppo, ts, env_state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    nums = check.numbers(rec, c, device, control=control, witness=witness)
    nums.pop("kernel_counts", None)
    return dict(cell=c["name"], seed=seed, fault=fault, seconds=time.perf_counter() - t0, **nums)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="iterations run as the window runs them before the reset iteration")
    a = ap.parse_args(argv)
    from benchmark.harness import spec

    c = spec.cell(a.workload)
    out = open(a.out, "a") if a.out else None
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    jobs = [(s, None) for s in ints(a.seeds)]
    jobs += [(s, f) for f in a.faults.split(",") if f for s in ints(a.fault_seeds)]
    for seed, fault in jobs:
        r = reading(c, seed, a.device, fault, None if fault else control_kind(c), a.seconds,
                    witness=not fault)
        line = json.dumps(r)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
