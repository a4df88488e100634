"""Port parity for learn/sac.py: the twin critic and the squashed actor on
converted weights, the squashed sample, and one train iteration against the
JAX package's on a stand-in env (collection into the ring, then the
gradient steps), with the JAX package's draws (threefry, rebuilt from its
key structure) fed to the port's ``noise`` and ``indices``. Tolerances:
forwards and the sample atol 1e-5 / rtol 1e-5; after the gradient steps
losses and alpha rtol 1e-4, parameters and Adam moments atol 2e-5 / rtol
1e-4 (float32: the two packages sum the matmuls' gradients in different
orders); the ring and the env's obs atol 1e-5.

The two libraries' float32 tanh differ by an ulp, which log(1 - a^2)
amplifies as the action saturates (1 - a^2 near its 1e-6 clip: up to 0.1 in
the log-probability). The sample test holds a and 1 - a^2 at the ulp level
and the log-probability tightly where 1 - a^2 > 1e-3; the iteration test
starts from a JAX init whose log_std head is scaled down (std about 0.2), so
its actions stay unsaturated and the comparison sees the algorithm."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu.learn import sac as jsac
from thormang_isaacgym_tpu_torch.learn import sac
from thormang_isaacgym_tpu_torch.parity import convert

B, O, A = 16, 6, 3
CFG = dict(units=(32, 32), batch_size=64, replay_buffer_size=96, steps_per_iteration=4,
           grad_steps=2, num_seed_steps=1)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol, err_msg=msg)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JStandIn:
    obs: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    timeout: jnp.ndarray
    last_episode_return: jnp.ndarray
    t: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class StandIn:
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    timeout: torch.Tensor
    last_episode_return: torch.Tensor
    t: torch.Tensor


_rng = np.random.default_rng(3)
W = _rng.normal(size=(O, O)).astype(np.float32) * 0.5
U = _rng.normal(size=(A, O)).astype(np.float32)
C = _rng.normal(size=O).astype(np.float32)
OBS0 = _rng.normal(size=(B, O)).astype(np.float32)
IDS = np.arange(B, dtype=np.float32)


class _Env:
    """A deterministic stand-in env: obs' = tanh(obs W + a U), reward c.obs
    - |a|^2, done every third step of an env and a timeout every sixth."""
    num_envs, num_obs, num_actions = B, O, A

    def __init__(self, xp, cls):
        self.xp, self.cls = xp, cls
        self.W, self.U, self.C, self.ids = (xp(x) for x in (W, U, C, IDS))

    def step_fn(self, s, a):
        t = s.t + 1.0
        obs = (jnp if self.cls is JStandIn else torch).tanh(s.obs @ self.W + a @ self.U)
        reward = (s.obs * self.C).sum(-1) - (a * a).sum(-1)
        phase = (t + self.ids) % 6.0
        done = ((phase % 3.0) == 0.0) * 1.0
        timeout = (phase == 0.0) * 1.0
        return self.cls(obs=obs, reward=reward, done=done, timeout=timeout,
                        last_episode_return=s.last_episode_return + reward, t=t)

    def reset(self):
        z = self.xp(np.zeros(B, np.float32))
        return self.cls(obs=self.xp(OBS0), reward=z, done=z, timeout=z,
                        last_episode_return=z, t=z)


def _pair(unsaturated=False, **kw):
    """JAX and port SAC on the stand-in env from the same JAX init; with
    `unsaturated` the log_std head's kernel x 0.05 and bias 0 (log_std
    about -1.5)."""
    cfg = {**CFG, **kw}
    jenv = _Env(jnp.asarray, JStandIn)
    tenv = _Env(torch.as_tensor, StandIn)
    tenv.device = torch.device("cpu")
    js = jsac.SAC(jenv, jsac.SACConfig(**cfg))
    ts = sac.SAC(tenv, sac.SACConfig(**cfg), device="cpu")
    jts = jax.jit(js.init)(jax.random.key(0))
    if unsaturated:
        params = jax.tree.map(lambda x: x, dict(jts.actor_params))
        params["params"] = dict(params["params"])
        head = params["params"]["log_std"]
        params["params"]["log_std"] = {"kernel": head["kernel"] * 0.05,
                                       "bias": jnp.zeros_like(head["bias"])}
        jts = dataclasses.replace(jts, actor_params=params)
    return js, jts, ts, convert.sac_train_state(ts, jax.tree.map(np.asarray, jts))


def test_config_matches_jax():
    assert dataclasses.asdict(sac.SACConfig()) == dataclasses.asdict(jsac.SACConfig())


def test_networks_match_jax_on_converted_weights():
    js, jts, tsac, ts = _pair()
    obs = np.random.default_rng(0).normal(size=(10, O)).astype(np.float32)
    act = np.random.default_rng(1).uniform(-1, 1, (10, A)).astype(np.float32)
    mu, ls = jax.jit(js.actor.apply)(jts.actor_params, obs)
    q1, q2 = jax.jit(js.critic.apply)(jts.critic_params, obs, act)
    with torch.no_grad():
        tmu, tls = ts.actor(torch.as_tensor(obs))
        tq1, tq2 = ts.critic(torch.as_tensor(obs), torch.as_tensor(act))
        tq1t, _ = ts.target_critic(torch.as_tensor(obs), torch.as_tensor(act))
    for got, want in ((tmu, mu), (tls, ls), (tq1, q1), (tq2, q2), (tq1t, q1)):
        _close(got, want)
    assert float(tls.min()) >= -5.0 and float(tls.max()) <= 2.0
    assert tsac.slots == js.slots == 6 and float(ts.log_alpha) == 0.0
    assert ts.buffer_bytes == 6 * B * (2 * O + A + 2) * 4


def test_squashed_sample_matches_jax():
    rng = np.random.default_rng(2)
    mu = rng.normal(size=(50, A)).astype(np.float32) * 3
    ls = rng.uniform(-5, 2, (50, A)).astype(np.float32)
    key = jax.random.key(7)
    a, logp = jsac._squashed_sample(key, jnp.asarray(mu), jnp.asarray(ls))
    eps = torch.as_tensor(np.asarray(jax.random.normal(key, mu.shape)))
    ta, tlogp = sac.squashed_sample(torch.as_tensor(mu), torch.as_tensor(ls), eps)
    _close(ta, a, atol=2.4e-7, rtol=0)
    _close(1 - ta ** 2, 1 - jnp.asarray(a) ** 2, atol=4.8e-7, rtol=0)
    open_ = _np(1 - ta ** 2) > 1e-3
    assert open_.sum() >= 10
    _close(_np(tlogp)[open_.all(-1)], np.asarray(logp)[open_.all(-1)], atol=1e-4)
    # saturated actions: 1 - a^2 clipped at 1e-6
    assert float(ta.abs().max()) == 1.0 and torch.isfinite(tlogp).all()


def _jax_draws(keys, cfg, plan):
    """The JAX train_iteration's draws under each of `keys`, one jit for
    all: the collection's action noise, then, where the iteration updates,
    per gradient step (slot, env) indices and the two noises. `plan` holds
    (n_valid, update) per iteration."""
    arrays = jax.jit(lambda ks: [_jax_draw_arrays(k, cfg, *p) for k, p in zip(ks, plan)])(keys)
    return [([torch.as_tensor(np.array(x)) for x in noise],
             [tuple(torch.as_tensor(np.array(x), dtype=torch.int64) for x in i) for i in idx])
            for noise, idx in arrays]


def _jax_draw_arrays(key, cfg, n_valid, update):
    key, k_col = jax.random.split(key)
    noise, idx = [], []
    for _ in range(cfg["steps_per_iteration"]):
        k_col, k_act = jax.random.split(k_col)
        noise.append(jax.random.normal(k_act, (B, A)))
    if update:
        for k in jax.random.split(key, cfg["grad_steps"]):
            k1, k2, k3, k4 = jax.random.split(k, 4)
            idx.append((jax.random.randint(k1, (cfg["batch_size"],), 0, n_valid),
                        jax.random.randint(k2, (cfg["batch_size"],), 0, B)))
            noise += [jax.random.normal(k3, (cfg["batch_size"], A)),
                      jax.random.normal(k4, (cfg["batch_size"], A))]
    return noise, idx


def _feed(monkeypatch, tsac, noise, idx):
    noise, idx = iter(noise), iter(idx)

    def take_noise(ts, shape):
        x = next(noise)
        assert tuple(x.shape) == tuple(shape)
        return x

    monkeypatch.setattr(tsac, "noise", take_noise)
    monkeypatch.setattr(tsac, "indices", lambda ts, n_valid: next(idx))


def _compare_states(ts, jts):
    j = jax.tree.map(np.asarray, jts)
    for module, tree, opt, jopt in ((ts.actor, j.actor_params, ts.actor_opt, j.actor_opt),
                                    (ts.critic, j.critic_params, ts.critic_opt, j.critic_opt),
                                    (ts.target_critic, j.target_critic_params, None, None)):
        for p, w in zip(module.parameters(), convert.sac_flat(module, tree)):
            _close(p, w, atol=2e-5, rtol=1e-4)
        if opt is not None:
            adam = convert._find_adam(jopt)
            assert opt.count == int(adam.count)
            for m, w in zip(opt.m, convert.sac_flat(module, adam.mu)):
                _close(m, w, atol=2e-6, rtol=1e-4)
    _close(ts.log_alpha, j.log_alpha, atol=1e-6, rtol=1e-5)
    assert ts.alpha_opt.count == int(convert._find_adam(j.alpha_opt).count)
    for k, v in ts.buffer.items():
        _close(v, j.buffer[k], atol=1e-5, rtol=1e-5, msg=k)
    assert (ts.buffer_pos, ts.buffer_full, ts.step) == \
        (int(j.buffer_pos), bool(j.buffer_full), int(j.step))


def test_train_iteration_matches_jax(monkeypatch):
    """A seed iteration (collection only) then an updating one that wraps
    the ring of 6 slots (positions 4, 5, 0, 1): the ring, its position and
    flag, the losses, alpha, the actor, critic and target parameters, and
    each Adam's first moments and count."""
    js, jts, tsac, ts = _pair(unsaturated=True)
    jstate = js.env.reset()
    tstate = tsac.env.reset()
    it = jax.jit(js.train_iteration)
    keys = [jax.random.key(10), jax.random.key(11)]
    draws = _jax_draws(keys, CFG, ((1, False), (6, True)))
    for key, (noise, idx) in zip(keys, draws):
        jts, jstate, jm = it(jts, jstate, key)
        _feed(monkeypatch, tsac, noise, idx)
        ts, tstate, m = tsac.train_iteration(ts, tstate)
        assert sorted(m) == sorted(jm)
        for k in jm:
            _close(m[k], jm[k], atol=1e-5, rtol=1e-4, msg=k)
        _close(tstate.obs, jstate.obs, atol=1e-5)
        _compare_states(ts, jts)
    assert float(m["critic_loss"]) > 0 and float(m["alpha"]) != 1.0
    assert ts.buffer_full and ts.buffer_pos == 8


def test_seed_steps_only_collect():
    """num_seed_steps iterations collect only: zero losses, alpha at its
    initial value, the networks untouched; the next iteration updates."""
    _, _, tsac, ts = _pair(num_seed_steps=2)
    before = [p.clone() for p in ts.actor.parameters()]
    state = tsac.env.reset()
    for i in range(3):
        ts, state, m = tsac.train_iteration(ts, state)
        if i < 2:
            assert float(m["critic_loss"]) == 0.0 == float(m["actor_loss"])
            assert float(m["alpha"]) == 1.0 and ts.actor_opt.count == 0
            assert all(torch.equal(a, b) for a, b in zip(before, ts.actor.parameters()))
    assert ts.actor_opt.count == ts.critic_opt.count == ts.alpha_opt.count == CFG["grad_steps"]
    assert float(m["critic_loss"]) > 0.0 and float(m["alpha"]) != 1.0
    assert ts.step == 3 and ts.buffer_pos == 12


def test_sac_iteration_runs_on_cartpole():
    """JAX tests/test_sac.py's run on the port: Cartpole at 16 envs, three
    iterations stay finite."""
    env = tgt.make("Cartpole", num_envs=16, seed=0, device="cpu")
    s = sac.SAC(env, sac.SACConfig(units=(32, 32), batch_size=256, replay_buffer_size=4096,
                                   steps_per_iteration=8, grad_steps=4, num_seed_steps=1),
                device="cpu")
    ts, _, hist = s.train(3, seed=0, log_every=1)
    assert len(hist) == 3 and all(np.isfinite(v) for h in hist for v in h.values())
    assert ts.step == 3 and ts.buffer_pos == 24 and s.slots == 256
    with pytest.raises(ValueError):
        sac.SAC(env, sac.SACConfig(), device="meta")
