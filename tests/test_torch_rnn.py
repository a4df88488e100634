"""Port parity for the LSTM policy, the asymmetric critic and the sigma head
of learn/networks.py and learn/ppo.py, against the JAX package on identical
numpy inputs (float32, mixed_precision=False; rtol = atol = 1e-5, gradients
atol = rtol = 1e-4, tests/test_torch_ppo.py's tolerances). Weights come
across with parity/convert.py.

- ``ActorCriticRNN`` forward from a non-zero carry: the flags of
  cfg/train/AnymalTerrainPPO_LSTM.yaml (LSTM 256 after a 512 trunk,
  concat_input) and ShadowHandPPOAsymmLSTM.yaml (LSTM 1024 before a 512 relu
  MLP, layer_norm), at their widths, plus two LSTM layers and the
  state-dependent sigma head, as cases of one test; the MLP's sigma head.
- ``ValueNet`` forward and ``_loss`` with privileged states (the actor's
  unused value head gets zero gradients, as under optax).
- ``_loss_rnn`` and its gradients on one sequence minibatch with dones in
  mid-sequence, symmetric and asymmetric.
- One ``train_iteration`` on a seeded trajectory (its stored carries made
  by the JAX network): one minibatch, so its losses are independent of the
  permutation; the losses, the KL, the learning rate and the three
  normalizers after the update. The port's rollout stores the input carry
  of each step, masked by the previous step's done.
- ``from_rlgames`` of the two LSTM YAMLs and TrifingerPPO.yaml; PPO builds
  for each on its task; an LSTM policy's play raises.
"""
import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from thormang_isaacgym_tpu.learn import ppo as jppo
from thormang_isaacgym_tpu.learn.normalize import rms_update as jrms_update
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.learn import ppo as tppo
from thormang_isaacgym_tpu_torch.parity import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)


def _train_yaml(name):
    with open(os.path.join(ROOT, "cfg", "train", f"{name}.yaml")) as f:
        return yaml.safe_load(f)


def _cfgs(name, **kw):
    """(JAX config, port config) of cfg/train/<name>.yaml in float32, with `kw`."""
    y = _train_yaml(name)
    kw = dict(mixed_precision=False, **kw)
    return (dataclasses.replace(jppo.PPOConfig.from_rlgames(y), **kw),
            dataclasses.replace(tppo.PPOConfig.from_rlgames(y), **kw))


def _envs(n_obs, n_act, n_states=0, B=8):
    """Stand-in envs of the widths the learner reads (the JAX and port PPO
    read no more of an env before a rollout)."""
    task = SimpleNamespace(num_states=n_states, num_agents=1)
    jenv = SimpleNamespace(num_obs=n_obs, num_actions=n_act, num_envs=B, task=task)
    return jenv, SimpleNamespace(**vars(jenv), device="cpu")


def _pair(jcfg, tcfg, n_obs, n_act, n_states=0, seed=0):
    """JAX PPO, its init (normalizers moved off identity), port PPO and the
    port TrainState carried across."""
    jenv, tenv = _envs(n_obs, n_act, n_states)
    jp, tp = jppo.PPO(jenv, jcfg), tppo.PPO(tenv, tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    jts = jp.init(jax.random.key(seed))
    f32 = jnp.float32
    jts = dataclasses.replace(
        jts, obs_rms=jrms_update(jts.obs_rms, jnp.asarray(rng.normal(size=(64, n_obs)) * 2 + 1, f32)),
        value_rms=jrms_update(jts.value_rms, jnp.asarray(rng.normal(size=64) * 3, f32)),
        states_rms=jrms_update(jts.states_rms, jnp.asarray(
            rng.normal(size=(64, max(n_states, 1))) * 2 - 1, f32)))
    return jp, jts, tp, convert.train_state(tp, jax.tree.map(np.asarray, jts))


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), err_msg=msg, **tol)


def _carry(rng, layers, B, H):
    return rng.normal(size=(layers, 2, B, H)).astype(np.float32) * 0.5


FORWARD = {
    "anymal_lstm": ("AnymalTerrainPPO_LSTM", {}, 188, 12, 0),
    "shadow_asymm_lstm": ("ShadowHandPPOAsymmLSTM", {}, 211, 20, 211),
    "two_layers": ("AnymalTerrainPPO_LSTM", dict(rnn_layers=2, units=(64,), rnn_units=32), 188, 12, 0),
    "sigma_head": ("ShadowHandPPOAsymmLSTM", dict(fixed_sigma=False, units=(64,), rnn_units=32),
                   211, 20, 211),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_rnn_forward_matches_jax(case):
    name, kw, n_obs, n_act, n_states = FORWARD[case]
    jcfg, tcfg = _cfgs(name, **kw)
    jp, jts, tp, ts = _pair(jcfg, tcfg, n_obs, n_act, n_states)
    assert tp.is_rnn and tp.asymmetric == (n_states > 0) and ts.model.rnn_layers == tcfg.rnn_layers
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(16, n_obs)).astype(np.float32)
    carry = _carry(rng, tcfg.rnn_layers, 16, tcfg.rnn_units)
    p = jts.params["ac"] if n_states else jts.params
    jc = tuple((jnp.asarray(carry[k, 0]), jnp.asarray(carry[k, 1])) for k in range(tcfg.rnn_layers))
    jmu, jls, jv, jnew = jp.network.apply(p, jnp.asarray(obs), jc)
    with torch.no_grad():
        mu, ls, v, new = ts.model(_t(obs), _t(carry))
    for g, w, k in ((mu, jmu, "mu"), (ls, jls, "log_std"), (v, jv, "value")):
        _close(g, w, msg=k)
    _close(new, np.stack([np.stack(x) for x in jnew]), msg="carry")
    if not tcfg.fixed_sigma:
        assert float(ls.std()) > 0.0                       # state-dependent


def test_mlp_sigma_head_matches_jax():
    """The MLP's state-dependent sigma head (fixed_sigma: false): forward,
    loss and gradients."""
    jcfg, tcfg = _cfgs("TrifingerPPO", fixed_sigma=False, units=(32, 16))
    jp, jts, tp, ts = _pair(jcfg, tcfg, 41, 9)
    assert ts.model.log_std is None and ts.model.sigma is not None
    batch = _batch(np.random.default_rng(2), 48, 41, 9)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for g, w in zip(ts.model(_t(batch["obs"])), jp.network.apply(jts.params, jb["obs"])):
        _close(g, w)
    (jloss, jaux), jg = jax.value_and_grad(jp._loss, has_aux=True)(jts.params, jts, jb)
    loss, aux = tp._loss(ts, {k: _t(v) for k, v in batch.items()})
    _close(loss, jloss)
    for k in jaux:
        _close(aux[k], jaux[k], msg=k)
    grads = tp.grads(loss, ts.parameters())
    for g, w in zip(grads, convert._flat_like_torch(ts.model, jax.tree.map(np.asarray, jg))):
        _close(g, w, GTOL)


def _batch(rng, n, n_obs, n_act, n_states=0, lead=()):
    f = np.float32
    shape = lead + (n,) if lead else (n,)
    mu = rng.normal(size=shape + (n_act,)).astype(f)
    log_std = np.full(shape + (n_act,), -0.3, f)
    out = dict(obs=rng.normal(size=shape + (n_obs,)).astype(f) * 2,
               action=(mu + np.exp(log_std) * rng.normal(size=mu.shape)).astype(f),
               logp=rng.normal(size=shape).astype(f) - 8, value=rng.normal(size=shape).astype(f),
               mu=mu + 0.05 * rng.normal(size=mu.shape).astype(f), log_std=log_std,
               adv=rng.normal(size=shape).astype(f), ret=rng.normal(size=shape).astype(f))
    if n_states:
        out["states"] = rng.normal(size=shape + (n_states,)).astype(f) * 2
    return out


def test_value_net_and_loss_with_states_match_jax():
    """TrifingerPPO.yaml's network (256-256-128-128 elu) on Trifinger's 41
    obs and 113 privileged states: the central value net, the policy's
    value from the normalised states, ``_loss`` and its gradients (the
    actor's own value head: zero)."""
    jcfg, tcfg = _cfgs("TrifingerPPO", horizon_length=6, minibatch_size=48)
    jp, jts, tp, ts = _pair(jcfg, tcfg, 41, 9, 113)
    assert ts.value_net is not None and ts.value_net.cv[0].weight.shape == (256, 113)
    assert tuple(ts.states_rms.mean.shape) == (113,) and float(ts.states_rms.count) > 1.0
    batch = _batch(np.random.default_rng(3), 48, 41, 9, 113)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        v = ts.value_net(_t(batch["states"]))
    _close(v, jp.value_net.apply(jts.params["cv"], jb["states"]))
    for g, w in zip(tp._policy(ts, _t(batch["obs"]), _t(batch["states"])),
                    jp._policy(jts, jb["obs"], jb["states"])):
        _close(g, w)
    (jloss, jaux), jg = jax.value_and_grad(jp._loss, has_aux=True)(jts.params, jts, jb)
    loss, aux = tp._loss(ts, {k: _t(v) for k, v in batch.items()})
    _close(loss, jloss)
    for k in jaux:
        _close(aux[k], jaux[k], msg=k)
    grads = tp.grads(loss, ts.parameters())
    want = convert._flat_like_torch(ts.model, jax.tree.map(np.asarray, jg), ts.value_net)
    assert len(grads) == len(want) == len(ts.adam_m)
    for g, w in zip(grads, want):
        _close(g, w, GTOL)
    head = [i for i, p in enumerate(ts.parameters()) if p is ts.model.value.weight]
    assert float(grads[head[0]].abs().max()) == 0.0


LOSS_RNN = {"anymal_lstm": ("AnymalTerrainPPO_LSTM", 188, 12, 0),
            "shadow_asymm_lstm": ("ShadowHandPPOAsymmLSTM", 211, 20, 211)}


@pytest.mark.parametrize("case", sorted(LOSS_RNN))
def test_loss_rnn_and_grads_match_jax(case):
    """One minibatch of 6 sequences of 4 steps from stored carries, with a
    done in mid-sequence in every other sequence (the carry zeroed after
    it), at narrow widths (trunk 48, LSTM 24)."""
    name, n_obs, n_act, n_states = LOSS_RNN[case]
    jcfg, tcfg = _cfgs(name, units=(48,), rnn_units=24, seq_len=4)
    jp, jts, tp, ts = _pair(jcfg, tcfg, n_obs, n_act, n_states)
    rng = np.random.default_rng(4)
    S, L = 6, 4
    batch = _batch(rng, L, n_obs, n_act, n_states, lead=(S,))
    done = np.zeros((S, L), np.float32)
    done[0::2, 1] = 1.0
    done[3, 2] = 1.0
    batch["done"] = done
    batch["carry"] = np.moveaxis(_carry(rng, 1, S, 24), 2, 0)      # (S, layers, 2, H)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jg = jax.value_and_grad(jp._loss_rnn, has_aux=True)(jts.params, jts, jb)
    loss, aux = tp._loss_rnn(ts, {k: _t(v) for k, v in batch.items()})
    _close(loss, jloss)
    for k in jaux:
        _close(aux[k], jaux[k], msg=k)
    grads = tp.grads(loss, ts.parameters())
    for g, w in zip(grads, convert._flat_like_torch(ts.model, jax.tree.map(np.asarray, jg),
                                                    ts.value_net)):
        _close(g, w, GTOL)
    # the carry after a done is zero: the loss is not that of the unmasked carry
    no_done = dict(batch, done=np.zeros_like(done))
    other, _ = tp._loss_rnn(ts, {k: _t(v) for k, v in no_done.items()})
    assert abs(float(other) - float(loss)) > 1e-6


def _jax_carries(jp, p, jts, obs, done, layers, H):
    """The input carry of each step as the JAX rollout makes it: from zero,
    masked by the previous step's done; and the last carry."""
    T, B = done.shape
    c = tuple((jnp.zeros((B, H)), jnp.zeros((B, H))) for _ in range(layers))
    prev = np.zeros(B, np.float32)
    stored = []
    for t in range(T):
        m = jnp.asarray(1.0 - prev)[:, None]
        c = jax.tree.map(lambda x: x * m, c)
        stored.append(np.stack([np.stack([np.asarray(a) for a in pair]) for pair in c]))
        x = jppo.rms_normalize(jts.obs_rms, jnp.asarray(obs[t])) if jp.cfg.normalize_input \
            else jnp.asarray(obs[t])
        _, _, _, c = jp.network.apply(p, x, c)
        prev = done[t]
    return np.stack(stored), c


def test_train_iteration_sequence_layout_matches_jax(monkeypatch):
    """One train_iteration of ShadowHandPPOAsymmLSTM's learner (narrow:
    trunk 48, LSTM 24; horizon 8, seq_len 4, 8 envs, one minibatch of all
    16 sequences, one mini-epoch) on the same seeded trajectory in both
    packages, its carries stored as the JAX rollout stores them: the
    sequence layout and the stored carries at each sequence start feed
    the losses."""
    T, B, L = 8, 8, 4
    jcfg, tcfg = _cfgs("ShadowHandPPOAsymmLSTM", units=(48,), rnn_units=24, horizon_length=T,
                       seq_len=L, minibatch_size=T * B, mini_epochs=1)
    jp, jts, tp, ts = _pair(jcfg, tcfg, 211, 20, 211)
    rng = np.random.default_rng(5)
    f = np.float32
    traj = _batch(rng, B, 211, 20, 211, lead=(T,))
    for k in ("adv", "ret"):
        traj.pop(k)
    traj.update(reward=rng.normal(size=(T, B)).astype(f),
                done=(rng.uniform(size=(T, B)) < 0.2).astype(f),
                timeout=(rng.uniform(size=(T, B)) < 0.1).astype(f))
    assert traj["done"][1:L - 1].any()                    # dones inside a sequence
    carries, last = _jax_carries(jp, jts.params["ac"], jts, traj["obs"], traj["done"], 1, 24)
    traj["carry"] = carries                                # (T, layers, 2, B, H)
    end = dict(obs=rng.normal(size=(B, 211)).astype(f), states=rng.normal(size=(B, 211)).astype(f),
               done=traj["done"][-1], last_episode_return=rng.normal(size=B).astype(f))
    jend = SimpleNamespace(**{k: jnp.asarray(v) for k, v in end.items()})
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    monkeypatch.setattr(jp, "rollout_rnn", lambda ts_, es, key: (jend, jtraj, last))
    jts2, _, jm = jp.train_iteration(jts, jend, jax.random.key(0))
    tend = SimpleNamespace(**{k: _t(v) for k, v in end.items()})
    ttraj = {k: _t(v) for k, v in traj.items()}
    tlast = _t(np.stack([np.stack([np.asarray(a) for a in pair]) for pair in last]))
    monkeypatch.setattr(tp, "rollout_rnn", lambda ts_, es: (tend, ttraj, tlast))
    ts2, _, m = tp.train_iteration(ts, tend)
    for k in ("a_loss", "v_loss", "entropy", "kl", "lr"):
        _close(m[k], jm[k], msg=k)
    for r in ("obs_rms", "value_rms", "states_rms"):
        for fld in ("mean", "var", "count"):
            _close(getattr(getattr(ts2, r), fld), getattr(getattr(jts2, r), fld), msg=f"{r}.{fld}")
    batch = tp.make_batch(ttraj, *tp.compute_gae(ttraj, torch.zeros(B)))
    assert tuple(batch["obs"].shape) == (T // L * B, L, 211)
    assert tuple(batch["carry"].shape) == (T // L * B, 1, 2, 24)
    # sequence s = chunk x B + env starts at step chunk x L with that step's carry
    s = B + 3
    np.testing.assert_array_equal(batch["carry"][s].numpy(), carries[L, :, :, 3])
    np.testing.assert_array_equal(batch["obs"][s].numpy(), traj["obs"][L:2 * L, 3])


def test_states_rms_moves_only_with_normalize_input(monkeypatch):
    """states_rms is updated from the batch's states with normalize_input
    only, as in JAX."""
    for flag in (True, False):
        jcfg, tcfg = _cfgs("TrifingerPPO", units=(16,), horizon_length=4, minibatch_size=32,
                           mini_epochs=1, normalize_input=flag)
        _, _, tp, ts = _pair(jcfg, tcfg, 41, 9, 113)
        before = ts.states_rms.count.clone()
        rng = np.random.default_rng(6)
        traj = {k: _t(v) for k, v in _batch(rng, 8, 41, 9, 113, lead=(4,)).items()
                if k not in ("adv", "ret")}
        traj.update(reward=torch.zeros(4, 8), done=torch.zeros(4, 8), timeout=torch.zeros(4, 8))
        end = SimpleNamespace(obs=torch.zeros(8, 41), states=torch.zeros(8, 113),
                              done=torch.zeros(8), last_episode_return=torch.zeros(8))
        monkeypatch.setattr(tp, "rollout", lambda ts_, es: (end, traj))
        ts, _, _ = tp.train_iteration(ts, end)
        assert (float(ts.states_rms.count) > float(before)) == flag


def test_rollout_stores_masked_input_carries():
    """The port's LSTM rollout on Cartpole (16 envs, 8 steps, half the envs
    timing out at step 3): each step's stored carry is the JAX network's
    carry of the step before, masked by its done."""
    env = tgt.make("Cartpole", num_envs=16, seed=0, device="cpu")
    jcfg, tcfg = _cfgs("AnymalTerrainPPO_LSTM", units=(16,), rnn_units=8, horizon_length=8,
                       minibatch_size=128)
    jenv, _ = _envs(env.num_obs, env.num_actions)
    jp = jppo.PPO(jenv, jcfg)
    jts = jp.init(jax.random.key(3))
    tp = tppo.PPO(env, tcfg, device="cpu")
    ts = convert.train_state(tp, jax.tree.map(np.asarray, jts))
    state = env.reset(0)
    progress = torch.where(torch.arange(16) % 2 == 0, torch.full((16,), env.task.max_episode_length - 4),
                           state.progress)
    state = dataclasses.replace(state, progress=progress)
    _, traj, last = tp.rollout_rnn(ts, state)
    done = traj["done"].numpy()
    assert done[2, 0::2].all() and done.sum(0)[1::2].max() < done.shape[0]
    want, jlast = _jax_carries(jp, jts.params, jts, traj["obs"].numpy(), done, 1, 8)
    _close(traj["carry"], want)
    _close(last, np.stack([np.stack([np.asarray(a) for a in p]) for p in jlast]))
    assert float(np.abs(want[3, :, :, 0::2]).max()) == 0.0     # zeroed after the timeout
    assert float(np.abs(want[3, :, :, 1::2]).max()) > 0.0


@pytest.mark.parametrize("name", ["AnymalTerrainPPO_LSTM", "ShadowHandPPOAsymmLSTM", "TrifingerPPO"])
def test_from_rlgames_matches_jax(name):
    y = _train_yaml(name)
    jcfg, tcfg = jppo.PPOConfig.from_rlgames(y), tppo.PPOConfig.from_rlgames(y)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if name == "AnymalTerrainPPO_LSTM":
        assert (tcfg.rnn_units, tcfg.rnn_concat_input, tcfg.separate, tcfg.seq_len,
                tcfg.mixed_precision, tcfg.horizon_length) == (256, True, True, 4, True, 24)
    elif name == "ShadowHandPPOAsymmLSTM":
        assert (tcfg.rnn_units, tcfg.rnn_before_mlp, tcfg.rnn_layer_norm, tcfg.seq_len,
                tcfg.activation, tcfg.units) == (1024, True, True, 4, "relu", (512,))
    else:
        assert tcfg.rnn_units == 0 and tcfg.units == (256, 256, 128, 128)


def test_ppo_builds_for_the_lstm_and_asymmetric_yamls():
    """PPO(env, PPOConfig.from_rlgames(...)) on AnymalTerrain with
    AnymalTerrainPPO_LSTM.yaml, asymmetric ShadowHand with
    ShadowHandPPOAsymmLSTM.yaml and Trifinger with TrifingerPPO.yaml; an
    LSTM policy's deterministic play raises, and a horizon that is not a
    multiple of seq_len raises."""
    envs = {"AnymalTerrainPPO_LSTM": tgt.make("AnymalTerrain", num_envs=2, seed=0, device="cpu",
                                              num_levels=2, num_types=4),
            "ShadowHandPPOAsymmLSTM": tgt.make("ShadowHand", num_envs=2, seed=0, device="cpu",
                                               asymmetric_obs=True),
            "TrifingerPPO": tgt.make("Trifinger", num_envs=2, seed=0, device="cpu")}
    for name, env in envs.items():
        ppo = tppo.PPO(env, tppo.PPOConfig.from_rlgames(_train_yaml(name)), device="cpu")
        ts = ppo.init(0)
        assert ppo.asymmetric == (name != "AnymalTerrainPPO_LSTM")
        assert ppo.is_rnn == ("LSTM" in name)
        assert (ts.value_net is not None) == ppo.asymmetric
        if ppo.is_rnn:
            with pytest.raises(NotImplementedError, match="LSTM"):
                ppo.act_deterministic(ts, torch.zeros(2, env.num_obs))
    with pytest.raises(ValueError, match="multiple of seq_len"):
        tppo.PPO(envs["AnymalTerrainPPO_LSTM"], dataclasses.replace(
            tppo.PPOConfig.from_rlgames(_train_yaml("AnymalTerrainPPO_LSTM")), horizon_length=6),
            device="cpu")
