"""Port parity for learn/ma.py (MAPPO: one policy shared over the agent
axis) against the JAX package's MAPPO, on stand-in envs of 2 agents and
identical numpy inputs (float32, mixed_precision=False; rtol = atol = 1e-5,
gradients atol = rtol = 1e-4, tests/test_torch_ppo.py's tolerances). Weights
come across with parity/convert.py.

- The rollout on a deterministic stand-in env (obs, rewards, dones and
  timeouts a function of the step count alone): the per-env done and
  timeout broadcast onto the agent axis, (T, B, A); obs, rewards, values,
  mu and log_std equal JAX's.
- GAE over (T, B, A) with dones and timeouts in mid-horizon, the value
  bootstrap on.
- The batch: (T B, A, ...), and a minibatch counts env transitions (T B =
  32, minibatch_size 16: two minibatches of (16, 2, ...)).
- ``_loss`` and its gradients on one (mb, A) minibatch.
- One ``train_iteration`` on the same trajectory in both packages (one
  minibatch of all env transitions, one mini-epoch): the losses, the KL, the
  learning rate, and obs_rms and value_rms over every agent.
- The rules: PPO raises for a task of 2 agents and names MAPPO; MAPPO
  raises for a single-agent task, an LSTM config and an asymmetric one.
"""
import dataclasses
import os
from typing import NamedTuple
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from thormang_isaacgym_tpu.learn import ma as jma
from thormang_isaacgym_tpu.learn import ppo as jppo
from thormang_isaacgym_tpu.learn.normalize import rms_update as jrms_update
from thormang_isaacgym_tpu_torch.learn import ma as tma
from thormang_isaacgym_tpu_torch.learn import ppo as tppo
from thormang_isaacgym_tpu_torch.parity import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)
T, B, A, O, ACT = 4, 8, 2, 12, 5


class StubState(NamedTuple):
    """The env state fields a rollout and a train iteration read, and the
    step count that drives the stand-in env."""
    obs: object
    reward: object
    done: object
    timeout: object
    last_episode_return: object
    t: object
    states: object = None


def _signals(xp, t):
    """obs (B, A, O), reward (B, A), done and timeout (B,) at step count t:
    env e is done where (t + e) % 3 == 0, a timeout where it is done and e
    is even."""
    e = xp.arange(B)
    o = xp.arange(B * A * O).reshape(B, A, O)
    obs = xp.sin(0.37 * o + 0.9 * t) * 2.0
    reward = xp.cos(0.21 * xp.arange(B * A).reshape(B, A) + 1.3 * t)
    done = ((t + e) % 3 == 0) * 1.0
    timeout = done * ((e % 2) == 0)
    return obs, reward, done, timeout


def _state(xp, t):
    obs, reward, done, timeout = _signals(xp, t)
    f = (lambda x: x.astype(jnp.float32)) if xp is jnp else (lambda x: x.to(torch.float32))
    return StubState(f(obs), f(reward), f(done), f(timeout), f(reward.mean(-1)), t)


def _envs(num_agents=A, n_states=0):
    """The JAX and port stand-in envs: the widths the learners read and a
    deterministic step_fn."""
    task = SimpleNamespace(num_states=n_states, num_agents=num_agents)
    jenv = SimpleNamespace(num_obs=O, num_actions=ACT, num_envs=B, task=task,
                           step_fn=lambda s, a: _state(jnp, s.t + 1))
    tenv = SimpleNamespace(num_obs=O, num_actions=ACT, num_envs=B, task=task, device="cpu",
                           step_fn=lambda s, a: _state(torch, s.t + 1))
    return jenv, tenv


def _cfgs(**kw):
    """(JAX config, port config) of cfg/train/MA_OP3PPO.yaml in float32,
    narrow, with `kw`."""
    with open(os.path.join(ROOT, "cfg", "train", "MA_OP3PPO.yaml")) as f:
        y = yaml.safe_load(f)
    kw = dict(mixed_precision=False, units=(32, 16), horizon_length=T, **kw)
    return (dataclasses.replace(jma.PPOConfig.from_rlgames(y), **kw),
            dataclasses.replace(tppo.PPOConfig.from_rlgames(y), **kw))


def _pair(jcfg, tcfg, seed=0):
    """JAX MAPPO, its init (normalizers moved off identity), port MAPPO and
    the port TrainState carried across."""
    jenv, tenv = _envs()
    jp, tp = jma.MAPPO(jenv, jcfg), tma.MAPPO(tenv, tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    jts = jp.init(jax.random.key(seed))
    f32 = jnp.float32
    jts = dataclasses.replace(
        jts, obs_rms=jrms_update(jts.obs_rms, jnp.asarray(rng.normal(size=(64, O)) * 2 + 1, f32)),
        value_rms=jrms_update(jts.value_rms, jnp.asarray(rng.normal(size=64) * 3, f32)))
    return jp, jts, tp, convert.train_state(tp, jax.tree.map(np.asarray, jts))


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), err_msg=msg, **tol)


def test_from_rlgames_of_ma_op3ppo_matches_jax():
    with open(os.path.join(ROOT, "cfg", "train", "MA_OP3PPO.yaml")) as f:
        y = yaml.safe_load(f)
    tcfg = tppo.PPOConfig.from_rlgames(y)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jppo.PPOConfig.from_rlgames(y))
    assert (tcfg.units, tcfg.horizon_length, tcfg.minibatch_size, tcfg.mini_epochs) == \
        ((256, 128, 64), 24, 16384, 5)


def test_rollout_broadcasts_done_and_timeout():
    jcfg, tcfg = _cfgs()
    jp, jts, tp, ts = _pair(jcfg, tcfg)
    jend, jtraj = jax.jit(jp.rollout)(jts, _state(jnp, jnp.asarray(0)), jax.random.key(1))
    end, traj = tp.rollout(ts, _state(torch, torch.tensor(0)))
    assert int(end.t) == int(jend.t) == T
    for k in ("obs", "action", "logp", "value", "mu", "log_std", "reward", "done", "timeout"):
        assert tuple(traj[k].shape) == tuple(jtraj[k].shape), k
    assert tuple(traj["done"].shape) == (T, B, A) and tuple(traj["action"].shape) == (T, B, A, ACT)
    for k in ("obs", "reward", "done", "timeout", "value", "mu", "log_std"):
        _close(traj[k], jtraj[k], msg=k)
    # the env's per-env done on both agents, a mid-horizon done and a timeout among them
    done = np.stack([_signals(np, t)[2] for t in range(1, T + 1)])
    np.testing.assert_array_equal(traj["done"].numpy(), np.repeat(done[..., None], A, -1))
    assert done[1:-1].any() and traj["timeout"].numpy().any()
    # the logp of the port's own actions under its own policy
    _close(traj["logp"], tppo.gaussian_logprob(traj["mu"], traj["log_std"], traj["action"]))


def _traj(rng):
    """A seeded (T, B, A) trajectory with the stand-in env's dones."""
    f = np.float32
    mu = rng.normal(size=(T, B, A, ACT)).astype(f)
    log_std = np.full((T, B, A, ACT), -0.3, f)
    done = np.stack([np.repeat(_signals(np, t)[2][:, None], A, -1) for t in range(1, T + 1)])
    timeout = np.stack([np.repeat(_signals(np, t)[3][:, None], A, -1) for t in range(1, T + 1)])
    return dict(obs=(rng.normal(size=(T, B, A, O)) * 2).astype(f),
                action=(mu + np.exp(log_std) * rng.normal(size=mu.shape)).astype(f),
                logp=(rng.normal(size=(T, B, A)) - 8).astype(f),
                value=rng.normal(size=(T, B, A)).astype(f),
                mu=(mu + 0.05 * rng.normal(size=mu.shape)).astype(f), log_std=log_std,
                reward=rng.normal(size=(T, B, A)).astype(f),
                done=done.astype(f), timeout=timeout.astype(f))


def test_gae_over_the_agent_axis_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, jts, tp, _ = _pair(jcfg, tcfg)
    assert tcfg.value_bootstrap
    traj = _traj(np.random.default_rng(2))
    assert traj["done"][1:-1].any() and traj["timeout"].any()
    last = np.random.default_rng(3).normal(size=(B, A)).astype(np.float32)
    jadv, jret = jp.compute_gae(jts, {k: jnp.asarray(v) for k, v in traj.items()}, jnp.asarray(last))
    adv, ret = tp.compute_gae({k: _t(v) for k, v in traj.items()}, _t(last))
    assert tuple(adv.shape) == (T, B, A)
    _close(adv, jadv, msg="advantages")
    _close(ret, jret, msg="returns")


def test_batch_counts_env_transitions(monkeypatch):
    """T B = 32 env transitions and minibatch_size 16: each mini-epoch two
    minibatches of 16 env transitions with both agents."""
    _, tcfg = _cfgs(minibatch_size=16, mini_epochs=2)
    _, tenv = _envs()
    tp = tma.MAPPO(tenv, tcfg, device="cpu")
    ts = tp.init(0)
    traj = {k: _t(v) for k, v in _traj(np.random.default_rng(4)).items()}
    batch = tp.make_batch(traj, *tp.compute_gae(traj, torch.zeros(B, A)))
    assert tuple(batch["obs"].shape) == (T * B, A, O) and tuple(batch["adv"].shape) == (T * B, A)
    np.testing.assert_array_equal(batch["obs"][B + 3].numpy(), traj["obs"][1, 3].numpy())
    shapes = []
    loss = tp._loss
    monkeypatch.setattr(tp, "_loss", lambda ts_, b: (shapes.append(tuple(b["obs"].shape)),
                                                     loss(ts_, b))[1])
    end = _state(torch, torch.tensor(T))
    monkeypatch.setattr(tp, "rollout", lambda ts_, es: (end, traj))
    tp.train_iteration(ts, end)
    assert shapes == [(16, A, O)] * 4


def test_loss_and_grads_on_one_minibatch_match_jax():
    jcfg, tcfg = _cfgs()
    jp, jts, tp, ts = _pair(jcfg, tcfg)
    rng = np.random.default_rng(5)
    traj = _traj(rng)
    batch = {k: v.reshape((-1,) + v.shape[2:]) for k, v in traj.items()
             if k not in ("reward", "done", "timeout")}
    batch["adv"] = rng.normal(size=(T * B, A)).astype(np.float32)
    batch["ret"] = rng.normal(size=(T * B, A)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jg = jax.value_and_grad(jp._loss, has_aux=True)(jts.params, jts, jb)
    loss, aux = tp._loss(ts, {k: _t(v) for k, v in batch.items()})
    _close(loss, jloss)
    for k in jaux:
        _close(aux[k], jaux[k], msg=k)
    grads = tp.grads(loss, ts.parameters())
    want = convert._flat_like_torch(ts.model, jax.tree.map(np.asarray, jg))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _close(g, w, GTOL)


def test_train_iteration_matches_jax(monkeypatch):
    """One minibatch of all T B env transitions and one mini-epoch, so the
    update is independent of the permutation."""
    jcfg, tcfg = _cfgs(minibatch_size=T * B, mini_epochs=1)
    jp, jts, tp, ts = _pair(jcfg, tcfg)
    traj = _traj(np.random.default_rng(6))
    end = _signals(np, T)
    jend = StubState(*(jnp.asarray(x, jnp.float32) for x in end),
                     jnp.asarray(end[1].mean(-1), jnp.float32), T)
    tend = StubState(*(torch.as_tensor(x, dtype=torch.float32) for x in end),
                     torch.as_tensor(end[1].mean(-1), dtype=torch.float32), T)
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    monkeypatch.setattr(jp, "rollout", lambda ts_, es, key: (jend, jtraj))
    jts2, _, jm = jp.train_iteration(jts, jend, jax.random.key(0))
    monkeypatch.setattr(tp, "rollout", lambda ts_, es: (tend, {k: _t(v) for k, v in traj.items()}))
    count0 = float(ts.obs_rms.count)
    ts2, _, m = tp.train_iteration(ts, tend)
    for k in ("a_loss", "v_loss", "entropy", "kl", "lr", "reward_mean", "episode_done_frac"):
        _close(m[k], jm[k], msg=k)
    for r in ("obs_rms", "value_rms"):
        for fld in ("mean", "var", "count"):
            _close(getattr(getattr(ts2, r), fld), getattr(getattr(jts2, r), fld), msg=f"{r}.{fld}")
    # the normalizers took every agent's sample
    assert float(ts2.obs_rms.count) == pytest.approx(count0 + T * B * A)
    # the updated weights
    jflat = convert._flat_like_torch(ts2.model, jax.tree.map(np.asarray, jts2.params))
    for g, w in zip(ts2.parameters(), jflat):
        _close(g, w, GTOL)


def test_who_may_use_which_learner():
    _, tcfg = _cfgs()
    _, tenv = _envs()
    with pytest.raises(ValueError, match="MAPPO"):
        tppo.PPO(tenv, tcfg, device="cpu")
    _, one = _envs(num_agents=1)
    with pytest.raises(ValueError, match="single-agent"):
        tma.MAPPO(one, tcfg, device="cpu")
    _, lstm = _cfgs(rnn_units=8, seq_len=2)
    with pytest.raises(NotImplementedError, match="LSTM"):
        tma.MAPPO(tenv, lstm, device="cpu")
    _, asym = _envs(n_states=6)
    with pytest.raises(NotImplementedError, match="asymmetric"):
        tma.MAPPO(asym, tcfg, device="cpu")
    # the shared policy's deterministic action on (B, A, O) obs
    tp = tma.MAPPO(tenv, tcfg, device="cpu")
    assert tuple(tp.act_deterministic(tp.init(0), torch.zeros(B, A, O)).shape) == (B, A, ACT)
