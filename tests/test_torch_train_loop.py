"""``PPO.train``, the host loop of the port's learners, against a hand-run
loop and against the JAX package's ``PPO.train``.

- On Cartpole (8 envs, narrow units, float32): ``train(3, log_every=1)``
  gives the same parameters, Adam moments, normalisers, env state and
  metrics, bit for bit, as ``init(seed)`` + ``env.reset(seed)`` + three
  ``train_iteration`` calls.
- The history's rows: on deterministic stand-in envs (obs, rewards, dones,
  metrics and AMP windows a function of the step count alone), the port's
  PPO, MAPPO and AMPPPO train 5 epochs with ``log_every`` 2; the rows come
  at JAX's epochs (``epoch % log_every == 0`` or the last: 0, 2, 4) with
  the key set of JAX's rows, which JAX's ``PPO.train`` builds from its
  ``train_iteration``'s metrics (their names read with ``jax.eval_shape``,
  which traces and compiles nothing), ``env/<name>`` for each env-state
  metric, and ``epoch``. The callback sees every row, and the env
  metrics' rows are the env-means of the last state's (rtol 1e-6: a
  float32 mean). Cartpole's rows hold JAX's iteration metrics and
  ``epoch``: neither package's Cartpole has env metrics.
- ``stagger_episodes``: the port's initial episode phases cover JAX's range,
  [0, max_episode_length - 2].
"""
import dataclasses
from types import SimpleNamespace
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu.learn import amp as jamp
from thormang_isaacgym_tpu.learn import ma as jma
from thormang_isaacgym_tpu.learn import ppo as jppo
from thormang_isaacgym_tpu_torch.learn import amp as tamp
from thormang_isaacgym_tpu_torch.learn import ma as tma
from thormang_isaacgym_tpu_torch.learn import ppo as tppo

B, A, O, ACT, W, T = 8, 2, 6, 3, 4, 4


class Stub(NamedTuple):
    """What a rollout and ``train`` read of an env state, and the step
    count that drives the stand-in env."""
    obs: Any
    reward: Any
    done: Any
    timeout: Any
    last_episode_return: Any
    t: Any
    task: Any
    metrics: Any
    states: Any = None


class AmpTask(NamedTuple):
    amp_obs: Any


def _state(xp, t, agents):
    """Env e is done where (t + e) % 3 == 0, a timeout where it is done and
    e is even; the metric "dist" is a sine of (t, e)."""
    f32 = jnp.float32 if xp is jnp else torch.float32
    lead = (B, agents) if agents > 1 else (B,)
    e = xp.arange(B)
    obs = xp.sin(0.37 * xp.arange(B * agents * O).reshape(lead + (O,)) + 0.9 * t) * 2.0
    reward = xp.cos(0.21 * xp.arange(B * agents).reshape(lead) + 1.3 * t)
    done = ((t + e) % 3 == 0) * 1.0
    timeout = done * ((e % 2) == 0)
    amp = xp.cos(0.11 * xp.arange(B * 2 * W).reshape(B, 2 * W) - 0.7 * t)
    c = (lambda x: x.astype(f32)) if xp is jnp else (lambda x: x.to(f32))
    ret = reward.mean(-1) if agents > 1 else reward
    return Stub(c(obs), c(reward), c(done), c(timeout), c(ret), t, AmpTask(c(amp)),
                {"dist": c(xp.sin(0.5 * e + 0.3 * t))})


def _envs(agents=1, amp=False):
    demo = np.cos(0.05 * np.arange(4096 * 2 * W).reshape(4096, 2 * W)).astype(np.float32)

    def env(xp, **kw):
        task = SimpleNamespace(num_states=0, num_agents=agents, num_amp_obs=2 * W,
                               fetch_amp_obs_demo=lambda key, n: xp.asarray(demo[:n]))
        return SimpleNamespace(num_obs=O, num_actions=ACT, num_envs=B, task=task,
                               reset=lambda key: _state(xp, 0, agents),
                               step_fn=lambda s, a: _state(xp, s.t + 1, agents), **kw)
    return env(jnp), env(torch, device="cpu")


def _learners(kind):
    import os
    import yaml
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = dict(ppo="AntPPO", ma="MA_OP3PPO", amp="HumanoidAMPPPO")[kind]
    with open(os.path.join(root, "cfg", "train", f"{name}.yaml")) as f:
        y = yaml.safe_load(f)
    kw = dict(mixed_precision=False, units=(16, 8), horizon_length=T, minibatch_size=T * B,
              mini_epochs=2)
    jenv, tenv = _envs(agents=A if kind == "ma" else 1, amp=kind == "amp")
    if kind == "amp":
        kw.update(disc_units=(8,), amp_replay_buffer_size=T * B)
        jc, tc = (dataclasses.replace(m.AMPConfig.from_rlgames(y), **kw) for m in (jamp, tamp))
        return jamp.AMPPPO(jenv, jc), tamp.AMPPPO(tenv, tc, device="cpu")
    jc, tc = (dataclasses.replace(m.PPOConfig.from_rlgames(y), **kw) for m in (jppo, tppo))
    if kind == "ma":
        return jma.MAPPO(jenv, jc), tma.MAPPO(tenv, tc, device="cpu")
    return jppo.PPO(jenv, jc), tppo.PPO(tenv, tc, device="cpu")


def _jax_keys(kind):
    """The keys of JAX's history rows for `kind`'s learner on its stand-in
    env, as JAX's ``PPO.train`` builds a row: its ``train_iteration``'s
    metrics (shapes only, ``jax.eval_shape``), ``env/<name>`` for each
    env-state metric, and ``epoch``."""
    jl = _learners(kind)[0]
    key = jax.random.key(3)
    es = jl.env.reset(key)
    metrics = jax.eval_shape(jl.train_iteration, jax.eval_shape(jl.init, key), es, key)[2]
    return sorted(set(metrics) | {f"env/{k}" for k in es.metrics} | {"epoch"})


@pytest.mark.parametrize("kind", ["ppo", "ma", "amp"])
def test_history_rows_match_jax(kind):
    tp = _learners(kind)[1]
    seen = []
    _, es, hist = tp.train(5, seed=3, log_every=2,
                           callback=lambda epoch, ts, row: seen.append((epoch, ts.epoch, row)))
    assert [r["epoch"] for r in hist] == [0, 2, 4]
    assert [sorted(r) for r in hist] == [_jax_keys(kind)] * 3
    assert "env/dist" in hist[0]
    assert [(e, n, r) for e, n, r in seen] == [(r["epoch"], r["epoch"] + 1, r) for r in hist]
    assert hist[-1]["env/dist"] == pytest.approx(float(es.metrics["dist"].mean()), rel=1e-6)
    assert all(isinstance(v, float) for r in hist for k, v in r.items() if k != "epoch")


def test_train_is_init_reset_and_iterations_bit_for_bit():
    env = tgt.make("Cartpole", num_envs=8, seed=0, device="cpu")
    cfg = dataclasses.replace(tppo.PPOConfig(), units=(32, 32), horizon_length=4,
                              minibatch_size=16, mini_epochs=2, mixed_precision=False)
    ppo = tppo.PPO(env, cfg, device="cpu")
    ts, es, hist = ppo.train(3, seed=5, log_every=1)
    ts2, es2 = ppo.init(5), env.reset(5)
    rows = []
    for _ in range(3):
        ts2, es2, m = ppo.train_iteration(ts2, es2)
        rows.append({k: float(v) for k, v in m.items()})
    for a, b in zip(ts.parameters() + ts.adam_m + ts.adam_v, ts2.parameters() + ts2.adam_m
                    + ts2.adam_v):
        assert torch.equal(a, b)
    for r in ("obs_rms", "value_rms"):
        for fld in ("mean", "var", "count"):
            assert torch.equal(getattr(getattr(ts, r), fld), getattr(getattr(ts2, r), fld))
    assert (ts.epoch, ts.adam_step, float(ts.lr)) == (ts2.epoch, ts2.adam_step, float(ts2.lr))
    assert torch.equal(ts.gen.get_state(), ts2.gen.get_state())
    for f in ("q", "qd", "obs", "reward", "done", "timeout", "progress", "episode",
              "episode_return", "last_episode_return"):
        assert torch.equal(getattr(es, f), getattr(es2, f)), f
    assert hist == [dict(r, epoch=i) for i, r in enumerate(rows)]
    # JAX's iteration metrics and epoch: Cartpole has no env metrics
    assert set(hist[0]) == set(_jax_keys("ppo")) - {"env/dist"}


def test_stagger_covers_jax_range():
    env = tgt.make("Cartpole", num_envs=4096, seed=0, device="cpu", stagger_episodes=True)
    p = env.reset(7).progress
    hi = int(env.task.max_episode_length) - 2        # jax.random.randint(0, L - 1)
    assert (int(p.min()), int(p.max())) == (0, hi)
