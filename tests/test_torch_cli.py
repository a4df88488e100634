"""The port's training CLI (runtime/train.py), its checkpoints
(runtime/checkpoint.py) and config composition (utils/config.py).

- ``main`` with Cartpole, 64 envs, 3 iterations on the CPU writes the JAX
  CLI's run layout: config.yaml, metrics.jsonl (epochs 0 and 2, the JAX
  keys plus fps), TensorBoard events under summaries/, nn/best.ckpt and
  nn/last.ckpt; ``test=true`` on its last.ckpt prints a finite
  ``play_mean_return``.
- A checkpoint saved after 2 iterations, loaded, and run one more iteration
  gives the uninterrupted run's weights, Adam state, lr, normalizers and
  metrics bit for bit.
- A JAX checkpoint (JAX ``save_train_state`` of a JAX ``PPO.init`` on
  runs/Cartpole/config.yaml's train block, and runs/Cartpole/nn/best.ckpt,
  a trained one) loads into the port and gives JAX's deterministic actions
  and values on the same observations at atol 1e-5 (float32, both
  unmixed); one of another network raises JAX's mismatch message.
- The asymmetric critic and the LSTM policy: JAX checkpoints of a
  TrifingerPPO init (its value net and states normalizer) and of an
  AnymalTerrainPPO_LSTM init, narrow, load into the port and give JAX's
  actions and values (the LSTM's from a non-zero carry) at atol 1e-5; a
  port checkpoint of each after 2 iterations, restored, runs one more
  iteration bit for bit as the uninterrupted run; a JAX checkpoint of an
  LSTM or asymmetric network loaded into another network raises. An LSTM
  policy's play raises NotImplementedError.
- MA_OP3 (MA_OP3PPO.yaml, algo ma_ppo: the multi-agent learner) trains one
  iteration through the CLI at 2 envs on the CPU, narrow, and writes a
  finite reward_mean; ``test=true`` on its last.ckpt raises: the JAX play
  of a multi-agent task raises on its (B, A) reward. A JAX MAPPO
  checkpoint loads into the port and gives JAX's actions and values on
  (B, 2, 88) obs at atol 1e-5.
- Guards: no CUDA and no ``device=`` raises (it does not train on the CPU);
  ``amp_continuous``, ``capture_video=true`` and ``headless=false`` raise
  NotImplementedError naming their ROADMAP items.
"""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.learn import ppo as jppo
from thormang_isaacgym_tpu.learn.normalize import rms_update as jrms_update
from thormang_isaacgym_tpu.runtime.checkpoint import load_train_state as jax_load_train_state
from thormang_isaacgym_tpu.runtime.checkpoint import save_train_state as jax_save_train_state
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.learn import ppo as tppo
from thormang_isaacgym_tpu_torch.runtime import train
from thormang_isaacgym_tpu_torch.runtime.checkpoint import load_train_state, save_train_state
from thormang_isaacgym_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_CFG = os.path.join(ROOT, "runs", "Cartpole", "config.yaml")
JAX_BEST = os.path.join(ROOT, "runs", "Cartpole", "nn", "best.ckpt")


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    ts = train.main(["task=Cartpole", "num_envs=64", "max_iterations=3", "device=cpu",
                     f"output_root={out}"])
    return out, ts


def test_main_writes_the_run_layout(cli_run):
    out, ts = cli_run
    run = out / "Cartpole"
    for f in ("config.yaml", "metrics.jsonl", "nn/best.ckpt", "nn/last.ckpt"):
        assert (run / f).is_file(), f
    assert any(p.name.startswith("events.out.tfevents.") for p in (run / "summaries").iterdir())
    cfg = yaml.safe_load((run / "config.yaml").read_text())
    assert cfg["task_name"] == "Cartpole" and cfg["device"] == "cpu" and cfg["num_envs"] == 64
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 2]
    for k in ("reward_mean", "episode_return_mean", "episode_done_frac", "kl", "a_loss",
              "v_loss", "entropy", "lr", "time", "env_steps", "fps"):
        assert all(math.isfinite(r[k]) for r in rows), k
    assert rows[-1]["env_steps"] == 3 * 16 * 64 and ts.epoch == 3


def test_play_of_last_checkpoint(cli_run, capsys):
    out, _ = cli_run
    capsys.readouterr()
    ret = train.main(["task=Cartpole", "num_envs=64", "device=cpu", f"output_root={out}",
                      "test=true", "test_episodes=1",
                      f"checkpoint={out / 'Cartpole' / 'nn' / 'last.ckpt'}"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert math.isfinite(line["play_mean_return"]) and line["play_mean_return"] == ret
    assert line["episodes"] >= 64


def _small_ppo():
    env = tgt.make("Cartpole", num_envs=16, seed=0, device="cpu")
    return tppo.PPO(env, tppo.PPOConfig(horizon_length=8, minibatch_size=64, mini_epochs=2,
                                        units=(32, 32), mixed_precision=False,
                                        normalize_input=True, normalize_value=True),
                    device="cpu")


def test_restore_then_one_iteration_equals_uninterrupted(tmp_path):
    ppo = _small_ppo()
    ts, state = ppo.init(0), ppo.env.reset(0)
    for _ in range(2):
        ts, state, _ = ppo.train_iteration(ts, state)
    path = str(tmp_path / "nn" / "mid.ckpt")
    save_train_state(path, ts)
    restored = load_train_state(path, ppo)
    ts, _, m_a = ppo.train_iteration(ts, state)
    restored, _, m_b = ppo.train_iteration(restored, state)
    for a, b in zip(ts.model.state_dict().values(), restored.model.state_dict().values()):
        assert torch.equal(a, b)
    for xs, ys in ((ts.adam_m, restored.adam_m), (ts.adam_v, restored.adam_v)):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    assert (ts.adam_step, ts.epoch) == (restored.adam_step, restored.epoch) == (12, 3)
    assert torch.equal(ts.lr, restored.lr)
    for r in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            assert torch.equal(getattr(getattr(ts, r), f), getattr(getattr(restored, r), f))
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k


def _assert_same_train_state(ts, restored):
    for mod in ("model", "value_net"):
        a, b = getattr(ts, mod), getattr(restored, mod)
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a.state_dict().values(), b.state_dict().values()):
                assert torch.equal(x, y)
    assert len(ts.adam_m) == len(ts.parameters()) == len(restored.adam_m)
    for xs, ys in ((ts.adam_m, restored.adam_m), (ts.adam_v, restored.adam_v)):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    assert (ts.adam_step, ts.epoch) == (restored.adam_step, restored.epoch)
    assert torch.equal(ts.lr, restored.lr)
    for r in ("obs_rms", "value_rms", "states_rms"):
        for f in ("mean", "var", "count"):
            assert torch.equal(getattr(getattr(ts, r), f), getattr(getattr(restored, r), f))


# narrow networks of the published asymmetric and LSTM configurations
NEW_NETS = {
    "Trifinger": ("TrifingerPPO", dict(units=(32, 16)), {}),
    "AnymalTerrain": ("AnymalTerrainPPO_LSTM", dict(units=(32,), rnn_units=16),
                      dict(num_levels=2, num_types=4)),
}


def _train_yaml(name):
    with open(os.path.join(ROOT, "cfg", "train", f"{name}.yaml")) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module", params=sorted(NEW_NETS))
def new_net(request):
    """(task, JAX PPO, port PPO) of NEW_NETS[task] at 4 envs, float32,
    horizon 4, one mini-epoch."""
    task = request.param
    train, net, kw = NEW_NETS[task]
    small = dict(net, horizon_length=4, minibatch_size=16, mini_epochs=1, mixed_precision=False)
    y = _train_yaml(train)
    jcfg = dataclasses.replace(jppo.PPOConfig.from_rlgames(y), **small)
    tcfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(y), **small)
    jp = jppo.PPO(tgx.make(task, num_envs=4, seed=0, **kw), jcfg)
    tp = tppo.PPO(tgt.make(task, num_envs=4, seed=0, device="cpu", **kw), tcfg, device="cpu")
    return task, jp, tp


def test_jax_checkpoint_of_the_new_networks_loads_into_the_port(new_net, tmp_path):
    task, jp, tp = new_net
    jts = jp.init(jax.random.key(7))
    rng = np.random.default_rng(0)
    f = np.float32
    jts = dataclasses.replace(
        jts, obs_rms=jrms_update(jts.obs_rms, jnp.asarray(rng.normal(size=(32, tp.env.num_obs)), f)),
        states_rms=jrms_update(jts.states_rms, jnp.asarray(
            rng.normal(size=(32, max(tp.num_states, 1))) * 2, f)))
    path = str(tmp_path / "jax_init.ckpt")
    jax_save_train_state(path, jts)
    ts = load_train_state(path, tp)
    assert (ts.value_net is not None) == (task == "Trifinger") == tp.asymmetric
    assert ts.model.__class__.__name__ == ("ActorCriticRNN" if tp.is_rnn else "ActorCritic")
    for r in ("obs_rms", "states_rms"):
        np.testing.assert_array_equal(getattr(ts, r).mean.numpy(), np.asarray(getattr(jts, r).mean))
    obs = rng.normal(size=(8, tp.env.num_obs)).astype(f)
    states = rng.normal(size=(8, max(tp.num_states, 1))).astype(f)[:, :tp.num_states]
    if tp.is_rnn:
        carry = (rng.normal(size=(1, 2, 8, 16)) * 0.5).astype(f)
        want = jp._policy_rnn(jts, jnp.asarray(obs), ((jnp.asarray(carry[0, 0]), jnp.asarray(carry[0, 1])),))
        got = tp._policy_rnn(ts, torch.as_tensor(obs), torch.as_tensor(carry))
        want = (*want[:3], np.stack([np.stack(x) for x in want[3]]))
    else:
        want = jp._policy(jts, jnp.asarray(obs), jnp.asarray(states))
        got = tp._policy(ts, torch.as_tensor(obs), torch.as_tensor(states))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_restore_of_the_new_networks_then_one_iteration_equals_uninterrupted(new_net, tmp_path):
    _, _, tp = new_net
    ts, state = tp.init(0), tp.env.reset(0)
    for _ in range(2):
        ts, state, _ = tp.train_iteration(ts, state)
    path = str(tmp_path / "nn" / "mid.ckpt")
    save_train_state(path, ts)
    restored = load_train_state(path, tp)
    _assert_same_train_state(ts, restored)
    ts, _, m_a = tp.train_iteration(ts, state)
    restored, _, m_b = tp.train_iteration(restored, state)
    _assert_same_train_state(ts, restored)
    assert ts.epoch == 3
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k


@pytest.mark.parametrize("saved, loaded", [("AnymalTerrain", "mlp"), ("Trifinger", "symmetric")])
def test_jax_checkpoint_of_a_new_network_into_another_raises(saved, loaded, tmp_path):
    """A JAX LSTM checkpoint into the port's MLP of the same task, and a JAX
    asymmetric one into a task without privileged states of the same obs
    width (Trifinger with asymmetric_obs false)."""
    train, net, kw = NEW_NETS[saved]
    y = _train_yaml(train)
    jcfg = dataclasses.replace(jppo.PPOConfig.from_rlgames(y), **net, mixed_precision=False)
    jp = jppo.PPO(tgx.make(saved, num_envs=4, seed=0, **kw), jcfg)
    path = str(tmp_path / "other.ckpt")
    jax_save_train_state(path, jp.init(jax.random.key(0)))
    tcfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(y), **net, mixed_precision=False)
    if loaded == "mlp":
        tcfg = dataclasses.replace(tcfg, rnn_units=0)
    else:
        kw = dict(kw, asymmetric_obs=False)
    tp = tppo.PPO(tgt.make(saved, num_envs=4, seed=0, device="cpu", **kw), tcfg, device="cpu")
    with pytest.raises(ValueError, match="config/model mismatch"):
        load_train_state(path, tp)


def test_play_of_an_lstm_policy_raises():
    cfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(_train_yaml("AnymalTerrainPPO_LSTM")),
                              units=(16,), rnn_units=8)
    tp = tppo.PPO(tgt.make("Cartpole", num_envs=4, seed=0, device="cpu"), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="LSTM"):
        train.play(tp.env, tp, tp.init(0), episodes=1)


def _run_train_cfg():
    with open(RUN_CFG) as f:
        return yaml.safe_load(f)["train"]


@pytest.fixture(scope="module")
def jax_cartpole():
    """JAX and port Cartpole PPOs on runs/Cartpole/config.yaml's train block."""
    cfg = _run_train_cfg()
    jp = jppo.PPO(tgx.make("Cartpole", num_envs=64, seed=0), jppo.PPOConfig.from_rlgames(cfg))
    tp = tppo.PPO(tgt.make("Cartpole", num_envs=64, seed=0, device="cpu"),
                  tppo.PPOConfig.from_rlgames(cfg), device="cpu")
    assert not jp.cfg.mixed_precision and tp.cfg.units == tuple(jp.cfg.units)
    return jp, tp


def _same_policy(jp, jts, tp, ts):
    obs = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32) * 2.0
    ja = np.asarray(jp.act_deterministic(jts, jnp.asarray(obs)))
    _, _, jv = jp._policy(jts, jnp.asarray(obs))
    ta = tp.act_deterministic(ts, torch.as_tensor(obs))
    _, _, tv = tp._policy(ts, torch.as_tensor(obs))
    np.testing.assert_allclose(ta.numpy(), ja, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)


def test_jax_init_checkpoint_loads_into_the_port(jax_cartpole, tmp_path):
    jp, tp = jax_cartpole
    jts = jp.init(jax.random.key(7))
    path = str(tmp_path / "jax_init.ckpt")
    jax_save_train_state(path, jts)
    ts = load_train_state(path, tp)
    _same_policy(jp, jts, tp, ts)
    assert ts.epoch == 0 and ts.adam_step == 0 and float(ts.lr) == pytest.approx(1e-4)


def test_tracked_jax_checkpoint_loads_into_the_port(jax_cartpole):
    jp, tp = jax_cartpole
    jts = jax_load_train_state(JAX_BEST, jp.init(jax.random.key(0)))
    ts = load_train_state(JAX_BEST, tp)
    assert ts.epoch == int(jts.epoch) and ts.adam_step == int(jts.opt_state[1].count)
    assert float(ts.obs_rms.count) == float(jts.obs_rms.count) > 1.0    # trained normalizers
    _same_policy(jp, jts, tp, ts)


def test_jax_checkpoint_of_another_network_raises(tmp_path):
    cfg = _run_train_cfg()
    cfg["params"]["network"]["mlp"]["units"] = [64, 64]
    jp = jppo.PPO(tgx.make("Cartpole", num_envs=8, seed=0), jppo.PPOConfig.from_rlgames(cfg))
    path = str(tmp_path / "small.ckpt")
    jax_save_train_state(path, jp.init(jax.random.key(0)))
    tp = tppo.PPO(tgt.make("Cartpole", num_envs=8, seed=0, device="cpu"),
                  tppo.PPOConfig.from_rlgames(_run_train_cfg()), device="cpu")
    with pytest.raises(ValueError, match="checkpoint has 39 leaves, template expects 45 — "
                                         "config/model mismatch"):
        load_train_state(path, tp)


def test_load_config_composes_like_jax():
    from thormang_isaacgym_tpu.utils.config import load_config as jax_load_config
    argv = ["task=HumanoidMJCF", "train=HumanoidPPO", "num_envs=128",
            "train.params.config.horizon_length=8", "task.sim.substeps=2"]
    cfg = load_config(argv)
    assert cfg == jax_load_config(argv)
    assert cfg["task"] == {"name": "HumanoidMJCF", "sim": {"substeps": 2}}
    assert cfg["train"]["params"]["config"]["horizon_length"] == 8


def test_main_without_cuda_or_device_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["task=Cartpole", "num_envs=8", "max_iterations=1", f"output_root={tmp_path}"])
    assert not (tmp_path / "Cartpole").exists()


@pytest.mark.parametrize("argv, item", [
    (["task=HumanoidAMP", "train=HumanoidAMPPPO"], "ROADMAP A10"),
    (["task=Cartpole", "capture_video=true"], "ROADMAP A12"),
    (["task=Cartpole", "headless=false"], "ROADMAP A12"),
])
def test_unported_paths_raise(argv, item, tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        train.main(argv + ["device=cpu", "num_envs=8", f"output_root={tmp_path}"])


@pytest.fixture(scope="module")
def ma_op3_run(tmp_path_factory):
    """The CLI on MA_OP3 (cfg/train/MA_OP3PPO.yaml, algo ma_ppo), 2 envs on the
    CPU, one iteration of a narrow network over 2 steps."""
    out = tmp_path_factory.mktemp("ma_runs")
    argv = ["task=MA_OP3", "device=cpu", "num_envs=2", f"output_root={out}",
            "train.params.network.mlp.units=[16]", "train.params.config.horizon_length=2",
            "train.params.config.mini_epochs=1"]
    ts = train.main(argv + ["max_iterations=1"])
    return out, argv, ts


def test_ma_op3_trains_through_the_cli(ma_op3_run):
    out, _, ts = ma_op3_run
    rows = [json.loads(line) for line in (out / "MA_OP3" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0] and math.isfinite(rows[0]["reward_mean"])
    assert rows[0]["reward_mean"] >= 0.0 and rows[0]["env_steps"] == 2 * 2
    assert ts.epoch == 1 and tuple(ts.model.mu.weight.shape) == (22, 16)
    assert (out / "MA_OP3" / "nn" / "last.ckpt").is_file()


def test_ma_op3_play_raises(ma_op3_run):
    """The JAX play adds the (B, A) reward into a (B,) return and raises, so
    the port's play of a multi-agent task raises."""
    out, argv, _ = ma_op3_run
    ckpt = out / "MA_OP3" / "nn" / "last.ckpt"
    with pytest.raises(NotImplementedError, match="multi-agent"):
        train.main(argv + ["test=true", f"checkpoint={ckpt}"])


def test_jax_mappo_checkpoint_loads_into_the_port(tmp_path):
    """A JAX MAPPO TrainState (MA_OP3PPO.yaml, narrow, float32) written with
    JAX's save_train_state loads into the port's MAPPO and gives JAX's
    deterministic actions and values on (B, 2, 88) obs at atol 1e-5."""
    from thormang_isaacgym_tpu.learn.ma import MAPPO as JMAPPO
    from thormang_isaacgym_tpu_torch.learn.ma import MAPPO
    y = _train_yaml("MA_OP3PPO")
    jcfg = dataclasses.replace(jppo.PPOConfig.from_rlgames(y), units=(32, 16),
                               mixed_precision=False)
    jp = JMAPPO(tgx.make("MA_OP3", num_envs=2, seed=0), jcfg)
    jts = jp.init(jax.random.key(3))
    rng = np.random.default_rng(4)
    jts = dataclasses.replace(jts, obs_rms=jrms_update(jts.obs_rms, jnp.asarray(
        rng.normal(size=(64, 88)) * 2 + 1, jnp.float32)), value_rms=jrms_update(
        jts.value_rms, jnp.asarray(rng.normal(size=64) * 3, jnp.float32)))
    path = str(tmp_path / "mappo.ckpt")
    jax_save_train_state(path, jts)
    tcfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(y), units=(32, 16),
                               mixed_precision=False)
    tp = MAPPO(tgt.make("MA_OP3", num_envs=2, seed=0, device="cpu"), tcfg, device="cpu")
    ts = load_train_state(path, tp)
    obs = (rng.normal(size=(6, 2, 88)) * 2.0).astype(np.float32)
    ja = np.asarray(jp.act_deterministic(jts, jnp.asarray(obs)))
    _, _, jv = jp._policy(jts, jnp.asarray(obs))
    ta = tp.act_deterministic(ts, torch.as_tensor(obs))
    _, _, tv = tp._policy(ts, torch.as_tensor(obs))
    assert tuple(ta.shape) == (6, 2, 22) and tuple(tv.shape) == (6, 2)
    np.testing.assert_allclose(ta.numpy(), ja, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
    assert float(ts.obs_rms.count) == float(jts.obs_rms.count) > 1.0


def test_profile_epoch_writes_a_chrome_trace(tmp_path):
    """profile_epoch=0 traces epochs 0-2 with torch.profiler into
    <run>/profile/trace.json (a small network keeps it short)."""
    train.main(["task=Cartpole", "num_envs=8", "max_iterations=3", "device=cpu", "profile_epoch=0",
                "train.params.network.mlp.units=[16]", "train.params.config.mini_epochs=1",
                f"output_root={tmp_path}"])
    trace = tmp_path / "Cartpole" / "profile" / "trace.json"
    assert trace.is_file()
    assert "traceEvents" in json.loads(trace.read_text())
