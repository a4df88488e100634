"""The port's policy export (runtime/export.py) against the JAX package's.

- A JAX ``TrainState`` carried across (weights off their init, ``obs_rms``
  off the identity, AntPPO's flags with normalize_input, float32): the
  port's npz holds JAX's keys with JAX's values plus ``obs_rms/mean`` and
  ``obs_rms/var``; the parity observations are JAX's bit for bit and the
  parity outputs JAX's at atol 1e-5; the meta JSON is JAX's.
- The ``.pt2`` program reloads (``torch.export.load``) and gives the parity
  outputs at atol 1e-5, for other batch sizes too.
- At the identity ``obs_rms`` JAX's ``numpy_policy_forward`` reads the port's
  npz and agrees with the parity outputs (atol 1e-5).
- Off the identity, the port's numpy forward applies the normaliser and
  agrees (atol 1e-5), where JAX's, on its own export, disagrees with its own
  parity outputs: the JAX fault ROADMAP C records.
- An LSTM policy raises; ``main`` writes the files for a task's YAML.
"""
import dataclasses
import json
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
from thormang_isaacgym_tpu.runtime import export as jexport
from thormang_isaacgym_tpu_torch.learn import ppo as tppo
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.runtime import export as texport

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=0)
N_OBS, N_ACT = 60, 8


def _pair(identity_rms, seed=0):
    with open(os.path.join(ROOT, "cfg", "train", "AntPPO.yaml")) as f:
        y = yaml.safe_load(f)
    kw = dict(units=(32, 16), mixed_precision=False, normalize_input=True)
    jcfg = dataclasses.replace(jppo.PPOConfig.from_rlgames(y), **kw)
    tcfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(y), **kw)
    task = SimpleNamespace(num_states=0, num_agents=1)
    jp = jppo.PPO(SimpleNamespace(num_obs=N_OBS, num_actions=N_ACT, num_envs=2, task=task), jcfg)
    tp = tppo.PPO(SimpleNamespace(num_obs=N_OBS, num_actions=N_ACT, num_envs=2, task=task,
                                  device="cpu"), tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    jts = jp.init(jax.random.key(seed))
    jts = dataclasses.replace(jts, params=jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.05, jnp.float32), jts.params))
    if not identity_rms:
        jts = dataclasses.replace(jts, obs_rms=jrms_update(
            jts.obs_rms, jnp.asarray(rng.normal(size=(64, N_OBS)) * 2 + 1, jnp.float32)))
    return jp, jts, tp, convert.train_state(tp, jax.tree.map(np.asarray, jts))


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """{identity_rms: (JAX dir, port dir, the port's parity outputs)}."""
    out = {}
    for ident in (True, False):
        jp, jts, tp, ts = _pair(ident)
        jdir = tmp_path_factory.mktemp(f"jax_{ident}")
        tdir = tmp_path_factory.mktemp(f"port_{ident}")
        jexport.export_policy(jp, jts, str(jdir), "ant", num_parity=100)
        got = texport.export_policy(tp, ts, str(tdir), "ant")
        out[ident] = (jdir, tdir, got)
    return out


def _load(d):
    return (dict(np.load(d / "ant_weights.npz")), json.loads((d / "ant_meta.json").read_text()),
            np.load(d / "ant_parity_obs.npy"), np.load(d / "ant_parity_out.npy"))


@pytest.mark.parametrize("identity_rms", [True, False])
def test_export_files_match_jax(exports, identity_rms):
    jdir, tdir, got = exports[identity_rms]
    jw, jmeta, jobs, jout = _load(jdir)
    tw, tmeta, tobs, tout = _load(tdir)
    assert set(tw) - set(jw) == {"obs_rms/mean", "obs_rms/var"} and set(jw) <= set(tw)
    for k in jw:
        assert tw[k].shape == jw[k].shape, k
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **TOL)
    np.testing.assert_array_equal(tobs, jobs)
    assert tout.shape == jout.shape == (100, N_ACT)
    np.testing.assert_allclose(tout, jout, **TOL)
    np.testing.assert_array_equal(tout, got)
    assert tmeta == jmeta


def test_pt2_program_reloads_and_agrees(exports):
    _, tdir, _ = exports[False]
    _, _, obs, out = _load(tdir)
    program = torch.export.load(str(tdir / "ant_policy.pt2")).module()
    with torch.no_grad():
        np.testing.assert_allclose(program(torch.as_tensor(obs)).numpy(), out, **TOL)
        np.testing.assert_allclose(program(torch.as_tensor(obs[:7])).numpy(), out[:7], **TOL)


def test_jax_numpy_forward_reads_the_port_npz(exports):
    _, tdir, _ = exports[True]
    w, meta, obs, out = _load(tdir)
    np.testing.assert_allclose(jexport.numpy_policy_forward(w, meta, obs), out, **TOL)
    np.testing.assert_allclose(texport.numpy_policy_forward(w, meta, obs), out, **TOL)


def test_numpy_forward_applies_obs_rms_where_jax_does_not(exports):
    jdir, tdir, _ = exports[False]
    w, meta, obs, out = _load(tdir)
    np.testing.assert_allclose(texport.numpy_policy_forward(w, meta, obs), out, **TOL)
    jw, jmeta, jobs, jout = _load(jdir)
    # JAX's numpy forward leaves obs_rms out, so it misses its own parity set
    assert np.abs(jexport.numpy_policy_forward(jw, jmeta, jobs) - jout).max() > 1e-2


def test_lstm_policy_raises_and_main_writes(tmp_path):
    task = SimpleNamespace(num_states=0, num_agents=1)
    env = SimpleNamespace(num_obs=4, num_actions=1, num_envs=2, task=task, device="cpu")
    p = tppo.PPO(env, tppo.PPOConfig(units=(8,), rnn_units=8, seq_len=4, horizon_length=4,
                                     mixed_precision=False), device="cpu")
    with pytest.raises(NotImplementedError, match="LSTM"):
        texport.export_policy(p, p.init(0), str(tmp_path), "x")
    texport.main(["task=Cartpole", "device=cpu", f"export_dir={tmp_path / 'e'}",
                  "train.params.network.mlp.units=[32,32]"])
    names = sorted(os.listdir(tmp_path / "e"))
    assert names == ["Cartpole_meta.json", "Cartpole_parity_obs.npy", "Cartpole_parity_out.npy",
                     "Cartpole_policy.pt2", "Cartpole_weights.npz"]
