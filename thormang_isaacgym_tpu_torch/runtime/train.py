"""Train / play CLI. Port of ``thormang_isaacgym_tpu/runtime/train.py`` (the
reference's ``train.py``).

Usage:
  python -m thormang_isaacgym_tpu_torch.runtime.train task=Cartpole max_iterations=50
  python -m thormang_isaacgym_tpu_torch.runtime.train task=HumanoidMJCF train=HumanoidPPO
  python -m thormang_isaacgym_tpu_torch.runtime.train task=HumanoidAMP train=HumanoidAMPPPO
  python -m thormang_isaacgym_tpu_torch.runtime.train task=Cartpole test=true \\
      checkpoint=runs/Cartpole/nn/last.ckpt
  python -m thormang_isaacgym_tpu_torch.runtime.train task=Cartpole device=cpu max_iterations=3
  python -m thormang_isaacgym_tpu_torch.runtime.train task=Ant test=true \
      checkpoint=runs/Ant/nn/last.ckpt capture_video=true      # videos/eval.gif
  python -m thormang_isaacgym_tpu_torch.runtime.train task=Ant multi_host=true \
      coordinator=127.0.0.1:29500 num_processes=2 process_id=<rank>
  torchrun --nproc_per_node=2 -m thormang_isaacgym_tpu_torch.runtime.train task=Ant

Config composition (``utils/config.py``) -> env -> the learner the JAX CLI
dispatches (``algo: amp_continuous`` AMPPPO, ``ma_ppo`` or a task of more
than one agent MAPPO, else PPO) -> checkpoints under
``<output_root>/<experiment>/nn/`` and the config under
``<output_root>/<experiment>/config.yaml``, ``metrics.jsonl`` every 10
epochs (and the last), TensorBoard scalars under ``summaries/``: the JAX
CLI's run layout. ``device=`` picks the device; without it the run is on
CUDA, and raises where there is none. ``checkpoint=`` takes a port or a JAX
checkpoint. Each logged row also holds ``time/<span>_ms``: the host ms an
iteration of each span of ``PHASES`` (``utils/trace.py``), averaged over the
iterations since the last row. ``profile_epoch=N`` traces epochs N..N+2 with
``torch.profiler`` at the tracer's ``annotate`` level, and writes the Chrome
trace, the spans above their kernels, to ``profile/trace.json`` and each
span's host self ms, kernels, device ms and device idle ms to
``profile/spans.json`` (``trace.profile_table``).

Data parallel (``parallel/``): with ``multi_host=true`` and its keys, or
under torchrun, one process per rank; ``num_envs`` is the run's global count
and each rank steps ``num_envs / ranks`` of them; ``env_steps`` and ``fps``
count global steps. Rank 0 alone writes the run directory (config,
metrics, TensorBoard, checkpoints, wandb); before each logging epoch's
checkpoints every rank's parameters are held to rank 0's
(``parallel/mesh.py check_replicas``), and a difference raises.

Play (``test=true``): ``capture_video=true`` writes env 0's evaluation as
``videos/eval.gif`` (``runtime/replay.py``), ``headless=false`` serves the
live viewer (``runtime/viewer.py``) while playing; ESC there ends the play.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch
import yaml

from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
from thormang_isaacgym_tpu_torch.parallel.distributed import host_local_batch, maybe_initialize
from thormang_isaacgym_tpu_torch.runtime.checkpoint import load_train_state, save_train_state
from thormang_isaacgym_tpu_torch.tasks import make
from thormang_isaacgym_tpu_torch.utils import trace
from thormang_isaacgym_tpu_torch.utils.config import load_config

# the spans whose host ms an iteration each logged row holds, as time/<span>_ms
PHASES = ("ppo.rollout", "ppo.policy", "env.step", "fused.step", "ppo.gae", "ppo.batch",
          "ppo.loss", "ppo.backward", "ppo.adam", "ppo.reduce")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg = load_config(argv)
    dist_info = maybe_initialize(cfg)
    device = dist_info["device"]
    rank, world = dist_info["process_id"], dist_info["num_processes"]
    if dist_info["initialized"]:
        print(f"data parallel: rank {rank}/{world} on {device} over {dist_info['backend']}")
    elif device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        device = torch.device("cuda:0")
        print(f"{torch.cuda.device_count()} CUDA devices visible: training on cuda:0 "
              "(launch one process per card for data-parallel training)")

    task_name = cfg["task_name"]
    num_envs = int(cfg.get("num_envs") or cfg["task"].get("env", {}).get("numEnvs", 4096))
    seed = int(cfg.get("seed", 42))
    env = make(task_name, num_envs=host_local_batch(num_envs), seed=seed,
               cfg=cfg.get("task") or None, device=device)
    # the learner, as the JAX CLI dispatches: amp_continuous takes AMP;
    # ma_ppo, or a task with more than one agent, the parameter-shared
    # multi-agent PPO
    algo = (cfg.get("train") or {}).get("params", {}).get("algo", {}).get("name")
    if algo == "amp_continuous":
        from thormang_isaacgym_tpu_torch.learn.amp import AMPConfig, AMPPPO
        ppo_cls, cfg_cls = AMPPPO, AMPConfig
    elif algo == "ma_ppo" or getattr(env.task, "num_agents", 1) > 1:
        from thormang_isaacgym_tpu_torch.learn.ma import MAPPO
        ppo_cls, cfg_cls = MAPPO, PPOConfig
    else:
        ppo_cls, cfg_cls = PPO, PPOConfig
    ppo_cfg = cfg_cls.from_rlgames(cfg["train"]) if cfg["train"] else cfg_cls()
    ppo = ppo_cls(env, ppo_cfg, device=device)

    exp_name = cfg.get("experiment") or task_name
    run_dir = os.path.join(cfg.get("output_root", "runs"), exp_name)
    writer = rank == 0
    if writer:
        os.makedirs(os.path.join(run_dir, "nn"), exist_ok=True)
        with open(os.path.join(run_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)

    group = None
    if world > 1:
        from thormang_isaacgym_tpu_torch.parallel.mesh import check_replicas, make_mesh, shard_ppo
        group = make_mesh()
        train_iter, init_fn = shard_ppo(ppo, group)
        ts, env_state = init_fn(seed)
    else:
        train_iter = ppo.train_iteration
        ts, env_state = ppo.init(seed), None
    ckpt = cfg.get("checkpoint")
    if ckpt:
        ts = load_train_state(ckpt, ppo)
        print(f"restored checkpoint {ckpt}")
    if cfg.get("test"):
        video = None
        if cfg.get("capture_video") and writer:
            os.makedirs(os.path.join(run_dir, "videos"), exist_ok=True)
            video = os.path.join(run_dir, "videos", "eval.gif")
        return play(env, ppo, ts, episodes=int(cfg.get("test_episodes", 3)), video=video,
                    live=not cfg.get("headless", True) and writer)

    wandb_run = None
    if cfg.get("wandb_activate") and writer:
        from thormang_isaacgym_tpu_torch.runtime.wandb_lite import init as _wb_init
        wandb_run = _wb_init(
            project=cfg.get("wandb_project", "thormang_isaacgym_tpu"),
            group=cfg.get("wandb_group", ""), entity=cfg.get("wandb_entity"),
            name=f"{cfg.get('wandb_name', exp_name)}_{time.strftime('%d-%H-%M-%S')}",
            config=cfg, dir=run_dir)

    from thormang_isaacgym_tpu_torch.runtime.tb import SummaryWriter
    tb = SummaryWriter(os.path.join(run_dir, "summaries")) if writer else None
    if env_state is None:
        env_state = env.reset(seed)
    max_iter = int(cfg.get("max_iterations", 1000))
    profile_at = int(cfg.get("profile_epoch", -1))
    prof = level = None
    best_reward = -float("inf")
    t_start = time.time()
    seen = max((r.index for r in trace.iterations()), default=-1)
    logf = open(os.path.join(run_dir, "metrics.jsonl"), "a") if writer else None
    try:
        for epoch in range(max_iter):
            if epoch == profile_at:
                level = trace.set_level("annotate")
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])])
                prof.start()
            ts, env_state, metrics = train_iter(ts, env_state)
            if prof is not None and epoch == profile_at + 2:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.stop()
                trace.set_level(level)
                done, prof = prof, None
                os.makedirs(os.path.join(run_dir, "profile"), exist_ok=True)
                done.export_chrome_trace(os.path.join(run_dir, "profile", "trace.json"))
                table = trace.profile_table(trace.profiler_events(done))
                with open(os.path.join(run_dir, "profile", "spans.json"), "w") as f:
                    json.dump(table, f, indent=1)
                print(f"profile trace and spans written to {run_dir}/profile")
            if epoch % 10 == 0 or epoch == max_iter - 1:
                if group is not None:
                    check_replicas(ts, group)
                if writer:
                    recs = [r for r in trace.iterations() if r.index > seen]
                    seen = recs[-1].index if recs else seen
                    row = _row(metrics, env_state, epoch, t_start,
                               ppo.cfg.horizon_length * num_envs)
                    if recs:
                        row.update({f"time/{k}_ms": sum(r.total_ms(k) for r in recs) / len(recs)
                                    for k in PHASES})
                    best_reward = _log(row, logf, tb, wandb_run, run_dir, ts, best_reward)
            if epoch % 50 == 0 and writer:
                save_train_state(os.path.join(run_dir, "nn", "last.ckpt"), ts)
    finally:
        if logf is not None:
            logf.close()
        if prof is not None:
            prof.stop()
            trace.set_level(level)
    if writer:
        save_train_state(os.path.join(run_dir, "nn", "last.ckpt"), ts)
        tb.close()
        if wandb_run is not None:
            wandb_run.finish()
        print(f"done: best reward_mean {best_reward:.3f}; checkpoints in {run_dir}/nn")
    # every rank's own count of fused-kernel launches (0 on the CPU)
    print(json.dumps({"rank": rank, "kernel_launches": env.physics_step.launches}), flush=True)
    return ts


def _row(metrics: dict, env_state, epoch: int, t_start: float, steps_per_epoch: int) -> dict:
    """The logged row of `epoch`: the learner's metrics, the env's episode
    metrics (env-mean), the epoch, the wall time and the run's global env
    steps and rate."""
    m = {k: float(v) for k, v in metrics.items()}
    for mk, mv in (env_state.metrics or {}).items():
        m[f"env/{mk}"] = float(mv.float().mean())
    m["epoch"] = epoch
    m["time"] = round(time.time() - t_start, 1)
    m["env_steps"] = (epoch + 1) * steps_per_epoch
    m["fps"] = round(m["env_steps"] / max(m["time"], 1e-9), 1)
    return m


def _log(m: dict, logf, tb, wandb_run, run_dir: str, ts, best_reward: float) -> float:
    """Print and write row `m`; save best.ckpt when its reward_mean is the
    best so far. Returns the best reward."""
    print(json.dumps(m))
    logf.write(json.dumps(m) + "\n")
    logf.flush()
    tb.add_scalars(m, m["epoch"])
    tb.flush()
    if wandb_run is not None:
        wandb_run.log(m, step=m["epoch"])
    if m["reward_mean"] > best_reward:
        best_reward = m["reward_mean"]
        save_train_state(os.path.join(run_dir, "nn", "best.ckpt"), ts)
    return best_reward


@torch.no_grad()
def play(env, ppo, ts, episodes=3, video=None, live=False):
    """Deterministic policy evaluation (the reference's test=True path): the
    mean return of the first ``episodes x num_envs`` finished episodes.
    `video`: a GIF path for env 0's first 300 states (``runtime/replay.py``);
    `live`: serve the live viewer (``runtime/viewer.py``) while playing, ESC
    there ends the play. An LSTM policy or a multi-agent task raises
    NotImplementedError: the JAX package plays neither."""
    if ppo.is_rnn:
        raise NotImplementedError("play of an LSTM policy: the JAX package's deterministic "
                                  "action passes no carry, so there is no play to port")
    if getattr(env.task, "num_agents", 1) > 1:
        raise NotImplementedError("play of a multi-agent task: the JAX package's play adds the "
                                  "(B, A) reward into a (B,) return and raises, so there is no "
                                  "play to port")
    state = env.reset(0)
    dev = env.device
    returns = torch.zeros(env.num_envs, device=dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    count = steps = 0
    viewer = logger = None
    if live:
        from thormang_isaacgym_tpu_torch.runtime.viewer import LiveViewer
        viewer = LiveViewer(env)
    if video:
        from thormang_isaacgym_tpu_torch.runtime.replay import StateLogger
        logger = StateLogger(env.task.model, dt=getattr(env.task.sim_params, "dt", 1 / 30))
    try:
        for _ in range(env.task.max_episode_length * episodes):
            state = env.step_fn(state, ppo.act_deterministic(ts, state.obs))
            steps += 1
            if viewer is not None:
                from thormang_isaacgym_tpu_torch.runtime.viewer import ViewerClosed
                try:
                    viewer.render(state)
                except ViewerClosed:
                    break
            if logger is not None and len(logger) < 300:
                logger.add(state.q[0].cpu().numpy())
            returns += state.reward
            finished = state.done > 0.5
            total += returns[finished].sum()
            count += int(finished.sum())
            returns = torch.where(finished, torch.zeros_like(returns), returns)
            if count >= episodes * env.num_envs:
                break
    finally:
        if viewer is not None:
            viewer.close()
    mean_ret = float(total) / max(count, 1)
    if logger is not None and len(logger):
        from thormang_isaacgym_tpu_torch.runtime.replay import render_video
        render_video(logger, video, every=2)
        print(f"video written to {video}")
    print(json.dumps({"play_mean_return": mean_ret, "episodes": count, "steps": steps,
                      "kernel_launches": env.physics_step.launches}))
    return mean_ret


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
