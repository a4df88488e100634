"""scripts/eval_shadowhand_uniform_torch.py, the port's twin of the JAX
script scripts/eval_shadowhand_uniform.py, held against it.

Both scripts run on the CPU from the same JAX checkpoint (a ShadowHandPPO
TrainState saved by the JAX package; the port's script reads it through
``runtime/checkpoint.py``) over the same short rollout: a stand-in
ShadowHand env of 4 envs whose 200 steps replay one seeded stream of the
task's metrics (the consecutive-success EMA, successes, rot_dist,
goal_dist), so the scripts' own work is what is compared: the step loop,
a row every 100 steps, the env means, the rounding and the output's keys
(atol 1e-4: one rounding unit). Both policies act on the same observations
and agree (atol 1e-5). The task's metrics themselves are held against JAX
in tests/test_torch_shadow_hand.py.
"""
import importlib.util
import os
from typing import NamedTuple
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.learn.ppo import PPO as JPPO, PPOConfig as JPPOConfig
from thormang_isaacgym_tpu.runtime.checkpoint import save_train_state as jsave
from thormang_isaacgym_tpu.utils.config import CFG_ROOT, load_yaml
import thormang_isaacgym_tpu_torch as tgt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS, N_OBS, N_ACT = 4, 200, 211, 20


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream():
    rng = np.random.default_rng(0)
    f = np.float32
    return [dict(consecutive_successes=rng.uniform(0, 3, B).astype(f),
                 successes=rng.integers(0, 5, B).astype(f),
                 rot_dist=rng.uniform(0, np.pi, B).astype(f),
                 goal_dist=rng.uniform(0, 0.1, B).astype(f)) for _ in range(STEPS + 1)]


class _State(NamedTuple):
    obs: object
    i: object
    metrics: dict


class _Replay:
    """A stand-in ShadowHand env replaying the metric stream (stacked, so
    the JAX script's jitted step traces it once); `wrap` makes the
    package's arrays."""

    def __init__(self, wrap, device=None):
        self.num_envs, self.num_obs, self.num_actions = B, N_OBS, N_ACT
        self.task = SimpleNamespace(num_states=0, num_agents=1)
        self.wrap, self.device = wrap, device
        self.stream = {k: wrap(np.stack([s[k] for s in _stream()])) for k in _stream()[0]}
        self.obs = wrap(np.random.default_rng(1).normal(size=(B, N_OBS)).astype(np.float32))
        self.actions = []

    def _state(self, i):
        return _State(self.obs, i, {k: v[i] for k, v in self.stream.items()})

    def reset(self, _seed):
        return self._state(0)

    def step_fn(self, state, a):
        self.actions.append(a)
        return self._state(state.i + 1)


def test_port_script_matches_jax_script(tmp_path, monkeypatch):
    cfg = JPPOConfig.from_rlgames(load_yaml(os.path.join(CFG_ROOT, "train", "ShadowHandPPO.yaml")))
    jenv = _Replay(jnp.asarray)
    ts = JPPO(jenv, cfg).init(jax.random.key(3))
    ckpt = str(tmp_path / "jax.ckpt")
    jsave(ckpt, ts)

    seen = {}
    monkeypatch.setattr(tgx, "make", lambda name, **kw: seen.setdefault("jax", (name, kw)) and jenv)
    want = _script("eval_shadowhand_uniform").main(ckpt, num_envs=B, steps=STEPS, seed=5)

    tenv = _Replay(torch.as_tensor, device=torch.device("cpu"))
    monkeypatch.setattr(tgt, "make",
                        lambda name, **kw: seen.setdefault("port", (name, kw)) and tenv)
    got = _script("eval_shadowhand_uniform_torch").main(
        [ckpt, "--envs", str(B), "--steps", str(STEPS), "--device", "cpu"])

    assert seen["jax"][0] == seen["port"][0] == "ShadowHand"
    assert seen["jax"][1]["goal_curriculum"] is seen["port"][1]["goal_curriculum"] is False
    assert [r["step"] for r in got["history"]] == [r["step"] for r in want["history"]] == [100, 200]
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=1e-4), k
    assert got["final"] == got["history"][-1]
    for k in ("num_envs", "steps", "goal_curriculum", "deterministic"):
        assert got[k] == want[k], k
    # the same policy: the port's actions are JAX's on the same observations
    assert len(tenv.actions) == STEPS
    jp = JPPO(jenv, cfg)
    np.testing.assert_allclose(tenv.actions[0].numpy(), np.asarray(jp.act_deterministic(
        ts, jenv.obs)), atol=1e-5)
    with pytest.raises(ValueError, match="at least 100"):
        _script("eval_shadowhand_uniform_torch").main([ckpt, "--steps", "50", "--device", "cpu"])
