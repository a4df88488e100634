"""Record SCALING_torch.json: one PPO iteration at a fixed total env count,
on one rank and split over N ranks of the port's data parallelism.

Twin of scripts/record_scaling.py. The same PPO iteration at the same total
env count runs first in one process without a process group, then split
over N ranks of ``parallel/`` (``shard_ppo``: each rank steps its own share
of the envs, ``PPO.reduce`` all-reduces the gradients, losses and KL once a
minibatch). After one warm-up iteration each point times REPEATS blocks of
``--iters`` iterations, each block between two barriers, and records per
block the seconds an iteration takes (the slowest rank's) and each rank's
seconds inside ``PPO.reduce`` (from its gradients being ready on the device
to the mean's return, the wait for the other ranks included). A point's
``iter_s`` is the median block's; t1 / tN and the env-steps/s follow from
it, as JAX records them; the blocks' spread is kept. After the timed
iterations every rank's parameters must equal rank 0's
(``check_replicas``).

t1 / tN is not the collectives' overhead at fixed work. Each rank is a
process of its own, so the host-side dispatch runs in parallel; and, as in
JAX's recorder, the minibatch size (capped at the whole run's envs x
horizon) counts a rank's own transitions, so a rank whose batch fits one
minibatch takes fewer, wider Adam steps than the single process does. The
all-reduce's own cost is ``reduce_s`` and its share of an iteration
``reduce_share``.

Lanes:
- ``cpu``: Cartpole at 1024 envs in all, 1, 2, 4 and 8 gloo ranks on the
  CPU, the host's cores split evenly over the ranks; JAX's own setting
  (one process, 8 virtual devices on a small host).
- ``card`` (default): Ant at its published 4096 envs, 1 and 2 ranks on one
  CUDA card over gloo (NCCL refuses two ranks on one GPU). The two ranks'
  contexts time-slice the card: not a speed-up across cards.

Each lane is written under ``lanes`` in SCALING_torch.json with the host's
cores and the card's name and power limit (nvidia-smi); the other lane's
record is kept. SCALING_r04.json, JAX's record, is not touched.

Run: python scripts/record_scaling_torch.py [--lane cpu|card] [--iters 6]
     [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

from record_parity_torch import card, ppo_config  # noqa: E402

LANES = {
    "cpu": dict(task="Cartpole", envs=1024, ranks=(1, 2, 4, 8), device="cpu"),
    "card": dict(task="Ant", envs=4096, ranks=(1, 2), device="cuda"),
}
OUT = os.path.join(ROOT, "SCALING_torch.json")
SEED = 3        # scripts/record_scaling.py's env seed
REPEATS = 3     # timed blocks a point (default)


def worker(spec: dict) -> dict:
    """One rank of a point: `spec` holds rank, world, coordinator, device,
    task, envs (in all), iters, repeats and threads. Returns the rank's
    blocks (the seconds an iteration takes and those inside PPO.reduce,
    each block's mean), kernel launches (the warm-up's included) and
    replica check."""
    import torch
    import torch.distributed as dist

    from thormang_isaacgym_tpu_torch.engine.env import resolve_device
    from thormang_isaacgym_tpu_torch.learn.ppo import PPO
    from thormang_isaacgym_tpu_torch.tasks import make

    device = resolve_device(spec["device"])
    if device.type == "cpu":
        torch.set_num_threads(spec["threads"])
    world = spec["world"]
    group = None
    if world > 1:
        from thormang_isaacgym_tpu_torch.parallel.distributed import maybe_initialize
        from thormang_isaacgym_tpu_torch.parallel.mesh import make_mesh
        info = maybe_initialize(dict(multi_host=True, coordinator=spec["coordinator"],
                                     num_processes=world, process_id=spec["rank"],
                                     # a card: the CLI's, cuda:(rank % cards)
                                     device=None if device.type == "cuda" else spec["device"]))
        device = info["device"]
        group = make_mesh()
    env = make(spec["task"], num_envs=spec["envs"] // world, seed=SEED, device=device)
    ppo = PPO(env, ppo_config(f"{spec['task']}PPO", spec["envs"]), device=device)
    if group is not None:
        from thormang_isaacgym_tpu_torch.parallel.mesh import shard_ppo
        train_iter, init_fn = shard_ppo(ppo, group)
        ts, env_state = init_fn(0)
    else:
        train_iter, ts, env_state = ppo.train_iteration, ppo.init(0), env.reset(0)

    def barrier():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if group is not None:
            dist.barrier(group)

    ts, env_state, _ = train_iter(ts, env_state)           # warm-up
    in_reduce = [0.0]
    if group is not None:
        reduce = ppo.reduce

        def timed_reduce(grads, aux):
            if device.type == "cuda":
                torch.cuda.synchronize(device)           # the gradients are ready
            t = time.perf_counter()
            out = reduce(grads, aux)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            in_reduce[0] += time.perf_counter() - t
            return out
        ppo.reduce = timed_reduce
    blocks = []
    for _ in range(spec["repeats"]):
        barrier()
        t0, r0 = time.perf_counter(), in_reduce[0]
        for _ in range(spec["iters"]):
            ts, env_state, metrics = train_iter(ts, env_state)
        barrier()
        blocks.append(dict(iter_s=(time.perf_counter() - t0) / spec["iters"],
                           reduce_s=(in_reduce[0] - r0) / spec["iters"]))
    out = dict(rank=spec["rank"], blocks=blocks, launches=env.physics_step.launches,
               kl=float(metrics["kl"]), replicas_equal=None, backend=None)
    if group is not None:
        from thormang_isaacgym_tpu_torch.parallel.mesh import check_replicas
        check_replicas(ts, group)            # raises unless rank 0's parameters
        out.update(replicas_equal=True, backend=dist.get_backend(group))
        dist.destroy_process_group()
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_point(task: str, envs: int, world: int, device: str, iters: int, repeats: int,
              timeout: float = 1800) -> list:
    """`world` rank processes of one point; their records, by rank. Raises
    unless every rank exits 0."""
    threads = max(1, (os.cpu_count() or 1) // world)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", json.dumps(dict(
            rank=r, world=world, coordinator=coord, device=device, task=task, envs=envs,
            iters=iters, repeats=repeats, threads=threads))],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{world} ranks: rank {r} exited {p.returncode}:\n"
                               f"{out[-2000:]}\n{err[-4000:]}")
    return [dict(json.loads(out.strip().splitlines()[-1]), threads=threads) for out, _ in outs]


def record(task: str, envs: int, ranks, device: str, iters: int, repeats: int) -> dict:
    """The lane's record: one point for each rank count, the first
    unsharded."""
    horizon = ppo_config(f"{task}PPO", envs).horizon_length
    points = []
    t1 = None
    for world in ranks:
        t_point = time.perf_counter()
        recs = run_point(task, envs, world, device, iters, repeats)
        blocks = [max(r["blocks"][i]["iter_s"] for r in recs) for i in range(repeats)]
        iter_s = statistics.median(blocks)
        t1 = t1 or dict(iter_s=iter_s, blocks=blocks)
        reduce_s = [statistics.median(b["reduce_s"] for b in r["blocks"]) for r in recs]
        points.append(dict(
            ranks=world, sharded=world > 1, iter_s=iter_s, iter_s_blocks=blocks,
            env_steps_per_s=envs * horizon / iter_s, envs_per_rank=envs // world,
            threads_per_rank=recs[0]["threads"] if device == "cpu" else None,
            backend=recs[0]["backend"], replicas_equal=recs[0]["replicas_equal"],
            launches_by_rank=[r["launches"] for r in recs],
            reduce_s_by_rank=reduce_s, reduce_share_by_rank=[r / iter_s for r in reduce_s],
            efficiency_t1_over_tn=t1["iter_s"] / iter_s,
            efficiency_range=[min(t1["blocks"]) / max(blocks), max(t1["blocks"]) / min(blocks)],
            wall_s=time.perf_counter() - t_point))
        print(json.dumps(points[-1]), flush=True)
    effs = [p["efficiency_t1_over_tn"] for p in points if p["sharded"]]
    return dict(task=task, num_envs_total=envs, horizon=horizon, iters=iters, repeats=repeats,
                device=device, host_cpu_cores=os.cpu_count(), card=card(), points=points,
                efficiency_min=min(effs) if effs else None)


def main(argv=None, *, envs: int | None = None, ranks=None, repeats: int = REPEATS) -> dict:
    """Record the lane named in `argv` at `envs` envs in all over each of
    `ranks` (default the lane's), `repeats` timed blocks a point, and
    write it; returns the whole file."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--lane", choices=sorted(LANES), default="card")
    ap.add_argument("--iters", type=int, default=6, help="timed iterations in each block")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if args.worker:
        res = worker(json.loads(args.worker))
        print(json.dumps(res), flush=True)
        return res
    lane = LANES[args.lane]
    if lane["device"] == "cuda":
        from thormang_isaacgym_tpu_torch.engine.env import resolve_device
        resolve_device("cuda")                      # raises without a card
    rec = record(lane["task"], envs or lane["envs"], ranks or lane["ranks"], lane["device"],
                 args.iters, repeats)
    import torch
    rec.update(recorded=time.strftime("%F"), torch=torch.__version__, cuda=torch.version.cuda,
               note=("t1 / tN at a fixed total env count: more processes dispatch in parallel "
                     "and a rank's smaller batch takes fewer Adam steps, so it is not the "
                     "collectives' overhead; that is reduce_s. "
                     + ("The ranks time-slice one card over gloo: not a speed-up across cards."
                        if lane["device"] == "cuda" else
                        "The gloo ranks share the host's cores, as JAX's virtual devices on "
                        "one host.")))
    out = {"schema": "scaling_torch_v1", "lanes": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    out["lanes"][args.lane] = rec
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", os.path.abspath(args.out), flush=True)
    return out


if __name__ == "__main__":
    main()
