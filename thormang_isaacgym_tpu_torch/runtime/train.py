"""Train / play CLI. Port of ``thormang_isaacgym_tpu/runtime/train.py`` (the
reference's ``train.py``).

Usage:
  python -m thormang_isaacgym_tpu_torch.runtime.train task=Cartpole max_iterations=50
  python -m thormang_isaacgym_tpu_torch.runtime.train task=HumanoidMJCF train=HumanoidPPO
  python -m thormang_isaacgym_tpu_torch.runtime.train task=HumanoidAMP train=HumanoidAMPPPO
  python -m thormang_isaacgym_tpu_torch.runtime.train task=Cartpole test=true \\
      checkpoint=runs/Cartpole/nn/last.ckpt
  python -m thormang_isaacgym_tpu_torch.runtime.train task=Cartpole device=cpu max_iterations=3

Config composition (``utils/config.py``) -> env -> the learner the JAX CLI
dispatches (``algo: amp_continuous`` AMPPPO, ``ma_ppo`` or a task of more
than one agent MAPPO, else PPO) -> checkpoints under
``<output_root>/<experiment>/nn/`` and the config under
``<output_root>/<experiment>/config.yaml``, ``metrics.jsonl`` every 10
epochs (and the last), TensorBoard scalars under ``summaries/``: the JAX
CLI's run layout. ``device=`` picks the device; without it the run is on
CUDA, and raises where there is none. ``checkpoint=`` takes a port or a JAX
checkpoint. ``profile_epoch=N`` writes a ``torch.profiler`` Chrome trace of
epochs N..N+2 to ``profile/``.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch
import yaml

from thormang_isaacgym_tpu_torch.engine.env import resolve_device
from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
from thormang_isaacgym_tpu_torch.runtime.checkpoint import load_train_state, save_train_state
from thormang_isaacgym_tpu_torch.tasks import make
from thormang_isaacgym_tpu_torch.utils.config import load_config


def _check_ported(cfg: dict) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.get("capture_video"):
        raise NotImplementedError("capture_video (runtime/replay.py) is not ported yet: ROADMAP A12")
    if not cfg.get("headless", True):
        raise NotImplementedError("the live viewer (headless=false, runtime/viewer.py) is not "
                                  "ported yet: ROADMAP A12")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg = load_config(argv)
    _check_ported(cfg)
    device = resolve_device(cfg.get("device"))
    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        device = torch.device("cuda:0")
        print(f"{torch.cuda.device_count()} CUDA devices visible: training on cuda:0 "
              "(data-parallel training is ROADMAP A11)")

    task_name = cfg["task_name"]
    num_envs = cfg.get("num_envs") or cfg["task"].get("env", {}).get("numEnvs", 4096)
    seed = int(cfg.get("seed", 42))
    env = make(task_name, num_envs=int(num_envs), seed=seed, cfg=cfg.get("task") or None,
               device=device)
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
    os.makedirs(os.path.join(run_dir, "nn"), exist_ok=True)
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)

    ts = ppo.init(seed)
    ckpt = cfg.get("checkpoint")
    if ckpt:
        ts = load_train_state(ckpt, ppo)
        print(f"restored checkpoint {ckpt}")
    if cfg.get("test"):
        return play(env, ppo, ts, episodes=int(cfg.get("test_episodes", 3)))

    wandb_run = None
    if cfg.get("wandb_activate"):
        from thormang_isaacgym_tpu_torch.runtime.wandb_lite import init as _wb_init
        wandb_run = _wb_init(
            project=cfg.get("wandb_project", "thormang_isaacgym_tpu"),
            group=cfg.get("wandb_group", ""), entity=cfg.get("wandb_entity"),
            name=f"{cfg.get('wandb_name', exp_name)}_{time.strftime('%d-%H-%M-%S')}",
            config=cfg, dir=run_dir)

    from thormang_isaacgym_tpu_torch.runtime.tb import SummaryWriter
    tb = SummaryWriter(os.path.join(run_dir, "summaries"))
    env_state = env.reset(seed)
    max_iter = int(cfg.get("max_iterations", 1000))
    profile_at = int(cfg.get("profile_epoch", -1))
    prof = None
    best_reward = -float("inf")
    t_start = time.time()
    with open(os.path.join(run_dir, "metrics.jsonl"), "a") as logf:
        for epoch in range(max_iter):
            if epoch == profile_at:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])])
                prof.start()
            ts, env_state, metrics = ppo.train_iteration(ts, env_state)
            if prof is not None and epoch == profile_at + 2:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.stop()
                os.makedirs(os.path.join(run_dir, "profile"), exist_ok=True)
                prof.export_chrome_trace(os.path.join(run_dir, "profile", "trace.json"))
                prof = None
                print(f"profile trace written to {run_dir}/profile")
            if epoch % 10 == 0 or epoch == max_iter - 1:
                m = {k: float(v) for k, v in metrics.items()}
                for mk, mv in (env_state.metrics or {}).items():
                    m[f"env/{mk}"] = float(mv.float().mean())
                m["epoch"] = epoch
                m["time"] = round(time.time() - t_start, 1)
                m["env_steps"] = (epoch + 1) * ppo.cfg.horizon_length * env.num_envs
                m["fps"] = round(m["env_steps"] / max(m["time"], 1e-9), 1)
                print(json.dumps(m))
                logf.write(json.dumps(m) + "\n")
                logf.flush()
                tb.add_scalars(m, epoch)
                tb.flush()
                if wandb_run is not None:
                    wandb_run.log(m, step=epoch)
                if m["reward_mean"] > best_reward:
                    best_reward = m["reward_mean"]
                    save_train_state(os.path.join(run_dir, "nn", "best.ckpt"), ts)
            if epoch % 50 == 0:
                save_train_state(os.path.join(run_dir, "nn", "last.ckpt"), ts)
    if prof is not None:
        prof.stop()
    save_train_state(os.path.join(run_dir, "nn", "last.ckpt"), ts)
    tb.close()
    if wandb_run is not None:
        wandb_run.finish()
    print(f"done: best reward_mean {best_reward:.3f}; checkpoints in {run_dir}/nn")
    return ts


@torch.no_grad()
def play(env, ppo, ts, episodes=3):
    """Deterministic policy evaluation (the reference's test=True path): the
    mean return of the first ``episodes x num_envs`` finished episodes. An
    LSTM policy or a multi-agent task raises NotImplementedError: the JAX
    package plays neither."""
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
    count = 0
    for _ in range(env.task.max_episode_length * episodes):
        state = env.step_fn(state, ppo.act_deterministic(ts, state.obs))
        returns += state.reward
        finished = state.done > 0.5
        total += returns[finished].sum()
        count += int(finished.sum())
        returns = torch.where(finished, torch.zeros_like(returns), returns)
        if count >= episodes * env.num_envs:
            break
    mean_ret = float(total) / max(count, 1)
    print(json.dumps({"play_mean_return": mean_ret, "episodes": count}))
    return mean_ret


if __name__ == "__main__":
    main()
