"""The port's multi-task learner (learn/multitask.py) and its CLI
(runtime/train_multi.py), against the JAX package's.

- One ``MultiTaskPPO.train_iteration`` over Cartpole and Ant at 8 envs
  (narrow networks) equals each task's own ``PPO.train_iteration``, run
  alone from the same per-task seeds (``task_seeds``), bit for bit: the
  weights, the Adam state, the normalizers, the metrics and the env state.
  The seeds differ between the tasks and with the run's seed.
- ``mesh`` other than None raises, naming ROADMAP A11.
- ``train_multi.main`` on the CPU (Cartpole and Ant, 8 envs, 2 iterations,
  a row every iteration) writes the JAX CLI's rows: ``epoch``, each task's
  metrics under its name, ``time``, ``env_steps_all_tasks`` (sum over the
  tasks of (epoch + 1) x horizon x num_envs) and ``fps``; each task's
  PPOConfig is the JAX CLI's (its <Task>PPO.yaml, the minibatch capped at
  num_envs x horizon, mixed precision off).
- A task the port does not have yet (the JAX CLI's default ``Gogoro``)
  raises, naming its ROADMAP item.
"""
import dataclasses
import json
import math
import os

import pytest
import torch

from thormang_isaacgym_tpu.learn.ppo import PPOConfig as JPPOConfig
from thormang_isaacgym_tpu.utils.config import load_yaml as jax_load_yaml
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.learn import multitask
from thormang_isaacgym_tpu_torch.learn.multitask import MultiTaskPPO, task_seeds
from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
from thormang_isaacgym_tpu_torch.runtime import train_multi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("Cartpole", "Ant")
N = 8


def _cfg():
    return PPOConfig(units=(32, 16), horizon_length=4, minibatch_size=16, mini_epochs=2,
                     normalize_input=True, normalize_value=True, value_bootstrap=True,
                     mixed_precision=False)


def _envs():
    return {n: tgt.make(n, num_envs=N, seed=0, device="cpu") for n in TASKS}


def _same(a, b, what):
    assert torch.equal(a, b), what


def test_train_iteration_equals_each_task_alone():
    mt = MultiTaskPPO(_envs(), {n: _cfg() for n in TASKS}, device="cpu")
    assert mt.names == sorted(TASKS)
    tss, ess = mt.init(7)
    tss, ess, mets = mt.train_iteration(tss, ess)
    seeds = [task_seeds(7, i) for i in range(len(TASKS))]
    assert len({s for pair in seeds for s in pair} | {7}) == 5
    for i, name in enumerate(mt.names):
        env = tgt.make(name, num_envs=N, seed=0, device="cpu")
        ppo = PPO(env, _cfg(), device="cpu")
        init_seed, env_seed = seeds[i]
        ts, es, m = ppo.train_iteration(ppo.init(init_seed), env.reset(env_seed))
        for p, q in zip(tss[name].parameters(), ts.parameters(), strict=True):
            _same(p, q, f"{name} weights")
        for p, q in zip(tss[name].adam_v, ts.adam_v, strict=True):
            _same(p, q, f"{name} adam")
        for r in ("obs_rms", "value_rms"):
            for f in ("mean", "var", "count"):
                _same(getattr(getattr(tss[name], r), f), getattr(getattr(ts, r), f), f"{name} {r}")
        assert mets[name].keys() == m.keys()
        for k in m:
            _same(mets[name][k], m[k], f"{name} {k}")
        _same(ess[name].q, es.q, f"{name} q")
        assert tss[name].epoch == ts.epoch == 1


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        MultiTaskPPO(_envs(), {n: _cfg() for n in TASKS}, mesh=True, device="cpu")
    with pytest.raises(ValueError, match="same"):
        MultiTaskPPO(_envs(), {"Ant": _cfg()}, device="cpu")


def test_train_multi_writes_the_jax_rows(tmp_path, monkeypatch):
    seen = {}
    real = multitask.MultiTaskPPO

    def spy(envs, cfgs, **kw):
        seen.update(cfgs)
        return real(envs, cfgs, **kw)

    monkeypatch.setattr(train_multi, "MultiTaskPPO", spy)
    rc = train_multi.main([f"tasks={','.join(TASKS)}", f"num_envs={N}", "max_iterations=2",
                           "log_every=1", "device=cpu", f"output_root={tmp_path}",
                           "experiment=mt"])
    assert rc == 0
    # the JAX CLI's config: the task's <Task>PPO.yaml, the minibatch capped, float32
    for name in TASKS:
        y = jax_load_yaml(os.path.join(ROOT, "cfg", "train", f"{name}PPO.yaml"))
        jcfg = JPPOConfig.from_rlgames(y)
        jcfg = dataclasses.replace(jcfg, minibatch_size=min(jcfg.minibatch_size,
                                                            N * jcfg.horizon_length),
                                   mixed_precision=False)
        assert dataclasses.asdict(seen[name]) == dataclasses.asdict(jcfg)
        assert seen[name].minibatch_size == N * jcfg.horizon_length
    rows = [json.loads(line) for line in (tmp_path / "mt" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    for r in rows:
        assert set(r) == {"epoch", *TASKS, "time", "env_steps_all_tasks", "fps"}
        assert r["env_steps_all_tasks"] == sum((r["epoch"] + 1) * seen[n].horizon_length * N
                                               for n in TASKS)
        assert r["fps"] == round(r["env_steps_all_tasks"] / max(r["time"], 1e-9), 1)
        for n in TASKS:
            assert set(r[n]) == {"reward_mean", "episode_return_mean", "episode_done_frac", "kl",
                                 "a_loss", "v_loss", "entropy", "lr"}
            assert all(math.isfinite(v) for v in r[n].values()), (n, r[n])


def test_unported_task_raises(tmp_path):
    with pytest.raises(KeyError, match="not yet ported: ROADMAP A9"):
        train_multi.main(["tasks=Gogoro", "num_envs=8", "device=cpu", f"output_root={tmp_path}"])
    with pytest.raises(KeyError, match="'Gogoro' is not yet ported"):            # the default list
        train_multi.main(["num_envs=8", "device=cpu", f"output_root={tmp_path}"])
    assert not any(tmp_path.iterdir())
