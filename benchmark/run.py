"""The benchmark of the PyTorch/CUDA port ``thormang_isaacgym_tpu_torch``: PPO
training throughput of one cell of ``BENCHMARK.json`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's numbers on standard error (the correctness checks last)
and one JSON result as the last line of standard output. Exits non-zero,
printing no result, without enough CUDA devices, without the port, or when
a forbidden package (JAX or the JAX package) was loaded."""
from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """This process's start on the wall clock (Linux: /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout; the
# port's own nvcc build directory is its package's _build, inside it too
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from benchmark.harness import cell, spec

    code, out = cell.run(spec.cell(a.workload), a.seed, a.seconds, bool(a.trace), T_START)
    if out is not None:
        print(json.dumps(out), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
