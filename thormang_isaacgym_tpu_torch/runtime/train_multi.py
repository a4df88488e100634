"""Multi-task training CLI. Port of ``thormang_isaacgym_tpu/runtime/train_multi.py``.

Usage:
  python -m thormang_isaacgym_tpu_torch.runtime.train_multi \\
      tasks=Ant,HumanoidMJCF num_envs=4096 max_iterations=200

Each task gets its reference train YAML (``cfg/train/<Task>PPO.yaml``, under
the reference's name of the task: HumanoidMJCF reads HumanoidPPO.yaml) and
its own policy and learner; every epoch steps all tasks
(``learn/multitask.MultiTaskPPO``). ``num_envs`` applies per task and caps
each task's minibatch at ``num_envs x horizon_length``; mixed precision is
off. The tasks are made without a task cfg, as in the JAX CLI, so each keeps
its class's own dt and substeps.

Arguments (``key=value``): tasks (default ``Gogoro,Humanoid``, the JAX CLI's,
whose URDFs need the reference's assets), num_envs (1024), max_iterations
(100), seed (42), experiment (``multi_<tasks>``), output_root (``runs``),
log_every (10), device (CUDA; raises where there is none), and the data-
parallel keys of ``runtime/train.py`` (``multi_host``, ``coordinator``,
``num_processes``, ``process_id``, or torchrun's environment): then
``num_envs`` is each task's global count, every task's learner is data
parallel over the ranks (``MultiTaskPPO(mesh=True)``, as the JAX CLI passes
``mesh=True`` over more than one device), and rank 0 alone writes.

Writes ``<output_root>/<experiment>/metrics.jsonl``: one row every
``log_every`` epochs and at the last, with each task's metrics under its
name, ``time``, ``env_steps_all_tasks`` and ``fps``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import yaml

from thormang_isaacgym_tpu_torch.learn.multitask import MultiTaskPPO
from thormang_isaacgym_tpu_torch.learn.ppo import PPOConfig
from thormang_isaacgym_tpu_torch.parallel.distributed import host_local_batch, maybe_initialize
from thormang_isaacgym_tpu_torch.tasks import cfg_name, make
from thormang_isaacgym_tpu_torch.utils.config import CFG_ROOT, load_yaml


def _kv(argv):
    out = {}
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            out[k] = v
    return out


def main(argv=None):
    args = _kv(sys.argv[1:] if argv is None else argv)
    task_names = args.get("tasks", "Gogoro,Humanoid").split(",")
    num_envs = int(args.get("num_envs", 1024))
    max_iter = int(args.get("max_iterations", 100))
    seed = int(args.get("seed", 42))
    exp = args.get("experiment", "multi_" + "_".join(task_names))
    dist_info = maybe_initialize({k: yaml.safe_load(v) for k, v in args.items()})
    device = dist_info["device"]
    use_mesh = dist_info["num_processes"] > 1
    writer = dist_info["process_id"] == 0

    envs, cfgs = {}, {}
    for name in task_names:
        yaml_path = os.path.join(CFG_ROOT, "train", f"{cfg_name(name)}PPO.yaml")
        cfg = PPOConfig.from_rlgames(load_yaml(yaml_path)) \
            if os.path.exists(yaml_path) else PPOConfig()
        cfg = dataclasses.replace(
            cfg, minibatch_size=min(cfg.minibatch_size, num_envs * cfg.horizon_length),
            mixed_precision=False)
        envs[name] = make(name, num_envs=host_local_batch(num_envs), seed=seed, device=device)
        cfgs[name] = cfg
    mt = MultiTaskPPO(envs, cfgs, mesh=True if use_mesh else None, device=device)

    run_dir = os.path.join(args.get("output_root", "runs"), exp)
    if writer:
        os.makedirs(run_dir, exist_ok=True)
    log_path = os.path.join(run_dir, "metrics.jsonl")
    t0 = time.time()
    print(f"multi-task: {task_names} x {num_envs} envs on {device}, "
          f"mesh={'%d ranks' % dist_info['num_processes'] if use_mesh else 'off'}", flush=True)

    def cb(epoch, tss, row):
        if not writer:
            return
        row = dict(row)
        row["time"] = round(time.time() - t0, 1)
        steps = sum((epoch + 1) * cfgs[n].horizon_length * num_envs for n in task_names)
        row["env_steps_all_tasks"] = steps
        row["fps"] = round(steps / max(row["time"], 1e-9), 1)
        with open(log_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)

    mt.train(max_iter, seed=seed, log_every=int(args.get("log_every", 10)), callback=cb)
    return 0


if __name__ == "__main__":
    rc = main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(rc)
