#!/usr/bin/env python3
"""What the fused kernel's 64-body cap costs: the kernel built from
csrc/fused_step.cu as it is (kMaxBodies = 64) against the same source built
with kMaxBodies = 16, on Ant at 4096 envs, in one process on one GPU.

Run from the repository root:  python3 scripts/time_kernel_cap.py

Prints JSON lines: the card (nvidia-smi name and power limit); ptxas' report
of the 16-body build; whether both builds give bit-equal outputs; then ms per
control step of each (CUDA events, 300 launches after 30 of warm-up), three
runs each, interleaved 16, 64, 64, 16, 16, 64. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from thormang_isaacgym_tpu_torch.ops import fused  # noqa: E402

CAP_LINE = "constexpr int kMaxBodies = 64;"


def build_cap16() -> ctypes.CDLL:
    src = open(fused.SOURCE).read()
    if CAP_LINE not in src:
        raise RuntimeError(f"{fused.SOURCE} does not hold {CAP_LINE!r}")
    os.makedirs(fused.BUILD_DIR, exist_ok=True)
    cu = os.path.join(fused.BUILD_DIR, "fused_step_cap16.cu")
    so = os.path.join(fused.BUILD_DIR, "libfused_step_cap16.so")
    with open(cu, "w") as f:
        f.write(src.replace(CAP_LINE, "constexpr int kMaxBodies = 16;"))
    res = subprocess.run([fused._nvcc(), *fused.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    print(json.dumps({"build": "kMaxBodies = 16", "ptxas": [
        ln.strip() for ln in (res.stdout + res.stderr).splitlines()
        if "registers" in ln or "stack frame" in ln]}), flush=True)
    lib = ctypes.CDLL(so)
    lib.fused_step_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.fused_step_launch.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = {64: fused.load_library(), 16: build_cap16()}
    dev = torch.device("cuda")
    task = cs._task("Ant", dev)
    step = fused.build_fused_step_fn(task.model, task.sim_params, need_torque=False)
    params, q, qd, ctrl, w = cs.random_inputs(task, np.random.default_rng(cs.SEED + 1), dev)
    packed = step.pack(params, q, qd, ctrl, w)
    mi, mf, _ = step._on(dev)

    def run(cap: int) -> torch.Tensor:
        out = torch.empty(step.out_rows, cs.B, device=dev)
        err = libs[cap].fused_step_launch(mi.data_ptr(), mf.data_ptr(), None, packed.data_ptr(),
                                          out.data_ptr(), cs.B, 0, step.block,
                                          fused.LAYOUTS.index(step.layout), step.smem_bytes, 1,
                                          torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    equal = torch.equal(run(16), run(64))
    print(json.dumps({"outputs_equal": bool(equal)}), flush=True)
    ms = {16: [], 64: []}
    for cap in (16, 64, 64, 16, 16, 64):
        ms[cap].append(cs._time_cuda(lambda: run(cap), iters=300, warmup=30))
    print(json.dumps({"model": "Ant", "envs": cs.B, "ms_cap16": ms[16], "ms_cap64": ms[64],
                      "mean_ms_cap16": sum(ms[16]) / 3, "mean_ms_cap64": sum(ms[64]) / 3}),
          flush=True)
    if not equal:
        raise AssertionError("the 16- and 64-body builds disagree")


if __name__ == "__main__":
    main()
