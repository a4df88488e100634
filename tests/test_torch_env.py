"""Port parity for engine/env.py and the Ant task: ``post_physics`` obs,
reward and done on identical states, and one ``step_fn`` with a masked
auto-reset where the port's reset is fed the JAX-sampled reset state (the two
packages' random streams differ by design). Tolerances: post_physics obs atol
1e-4 / rtol 1e-5; reward atol 1e-2 (float32: the progress reward is a
difference of two ~6e4 potentials, whose ulp is 4e-3); after a physics step q
2e-3 and qd 2e-2 as in tests/test_fused.py and obs 1e-3; done, timeout,
progress and episode exactly."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.engine.env import _env_keys
from thormang_isaacgym_tpu.tasks.ant import AntTaskState as JAntTaskState
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom
from thormang_isaacgym_tpu_torch.tasks.ant import AntTaskState

B = 4


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _random_ant_state(jenv, rng):
    """A JAX Ant EnvState with seeded numpy physics, contact and task fields."""
    js = jenv.init_fn(jax.random.key(0))
    q = np.array(js.q)
    q[:, 0:2] = rng.uniform(-1, 1, (B, 2))
    q[:, 2] = rng.uniform(0.2, 0.7, B)           # some below termination height
    qr = rng.normal(size=(B, 4)) * 0.3 + [1, 0, 0, 0]
    q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(-0.6, 1.7, (B, 8))
    qd = rng.normal(size=(B, 14))
    net = rng.normal(size=(B, 9, 3)) * 20
    pot = -np.linalg.norm(np.array([1000.0, 0]) - q[:, 0:2], axis=1) / (1 / 60) \
        + rng.normal(size=B) * 0.5
    task = JAntTaskState(jnp.asarray(pot, jnp.float32), jnp.asarray(pot, jnp.float32),
                         jnp.asarray(rng.uniform(-1, 1, (B, 8)), jnp.float32))
    return dataclasses.replace(js, q=jnp.asarray(q, jnp.float32), qd=jnp.asarray(qd, jnp.float32),
                               net_contact=jnp.asarray(net, jnp.float32), task=task)


def _port_state(env, js):
    """The port EnvState holding the same values as JAX state `js`."""
    ts = env.init_fn(0)
    task = AntTaskState(_t(js.task.potentials), _t(js.task.prev_potentials), _t(js.task.actions))
    return dataclasses.replace(
        ts, q=_t(js.q), qd=_t(js.qd), obs=_t(js.obs), reward=_t(js.reward), done=_t(js.done),
        timeout=_t(js.timeout), progress=_t(js.progress, torch.int64),
        net_contact=_t(js.net_contact), net_torque=_t(js.net_torque),
        episode=_t(js.episode, torch.int64), episode_return=_t(js.episode_return),
        last_episode_return=_t(js.last_episode_return), task=task)


@pytest.fixture(scope="module")
def ref():
    """JAX references, computed once: post_physics on a random state, and one
    step with envs 1 and 3 auto-resetting."""
    rng = np.random.default_rng(0)
    jenv = tgx.make("Ant", num_envs=B, seed=0)
    js = _random_ant_state(jenv, rng)
    post = jenv.task.post_physics(js, js.task)

    done = np.zeros(B, np.float32)
    done[[1, 3]] = 1.0
    js2 = dataclasses.replace(js, done=jnp.asarray(done),
                              progress=jnp.asarray([5, 7, 9, 998], jnp.int32))
    actions = jnp.asarray(rng.uniform(-1, 1, (B, 8)), jnp.float32)
    # the reset draws that step_fn makes for this state
    episode = js2.episode + (js2.done > 0).astype(jnp.int32)
    keys = _env_keys(jax.random.fold_in(js2.key, 1), episode, 17)
    q_r, qd_r, _, task_r = jax.vmap(jenv.task.reset_fn)(keys, js2.params, js2.task)
    stepped = jax.jit(jenv.step_fn)(js2, actions)
    return dict(state=js, post=post, state2=js2, actions=actions, reset=(q_r, qd_r, task_r),
                stepped=stepped)


@pytest.fixture(scope="module")
def env():
    return tgt.make("Ant", num_envs=B, seed=0, device="cpu")


def test_ant_post_physics_matches_jax(ref, env):
    js = ref["state"]
    ts = _port_state(env, js)
    obs, rew, done, task, metrics = env.task.post_physics(ts, ts.task)
    jobs, jrew, jdone, jtask, _ = ref["post"]
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-2, rtol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert 0 < done.sum() < B
    np.testing.assert_allclose(task.potentials.numpy(), np.asarray(jtask.potentials), rtol=1e-6)


def test_masked_auto_reset_step_matches_jax(ref, env, monkeypatch):
    js2 = ref["state2"]
    q_r, qd_r, task_r = ref["reset"]

    def fed_reset(rng, params, task):
        t = AntTaskState(_t(task_r.potentials), _t(task_r.prev_potentials), _t(task_r.actions))
        return _t(q_r), _t(qd_r), params, t

    monkeypatch.setattr(env.task, "reset_fn", fed_reset)
    ts = _port_state(env, js2)
    out = env.step_fn(ts, _t(ref["actions"]))
    jo = ref["stepped"]
    np.testing.assert_allclose(out.q.numpy(), np.asarray(jo.q), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(out.qd.numpy(), np.asarray(jo.qd), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(out.obs.numpy(), np.asarray(jo.obs), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(out.reward.numpy(), np.asarray(jo.reward), atol=1e-2, rtol=1e-4)
    for k in ("done", "timeout", "progress", "episode"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(getattr(jo, k)), err_msg=k)
    np.testing.assert_allclose(out.episode_return.numpy(), np.asarray(jo.episode_return),
                               atol=1e-2, rtol=1e-4)
    assert out.progress.tolist()[1] == 1 and out.progress.tolist()[3] == 1   # reset envs restart
    assert out.done.tolist()[3] == 0.0


def test_env_random_streams_are_keyed_and_deterministic():
    ep = torch.tensor([0, 0, 1, 1])
    a = EnvRandom(7, ep, 17).uniform(5)
    b = EnvRandom(7, ep, 17).uniform(5)
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1])                       # env id enters the key
    c = EnvRandom(7, ep + 1, 17).uniform(5)
    assert not torch.equal(a, c)                             # episode enters the key
    assert not torch.equal(a, EnvRandom(8, ep, 17).uniform(5))
    r = EnvRandom(0, torch.zeros(4096, dtype=torch.int64), 0)
    u = torch.cat([r.uniform(8), r.uniform(8)], 1)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


def test_nan_quarantine():
    """A non-finite carried state is swapped for a fresh reset state (progress
    restarts) without poisoning the batch."""
    env = tgt.make("Cartpole", num_envs=4, seed=0, device="cpu")
    s = env.reset(0)
    q = s.q.clone()
    q[1, 0] = float("nan")
    s = dataclasses.replace(s, q=q, progress=s.progress + 5)
    s = env.step(s, torch.zeros(4, 1))
    assert bool(torch.isfinite(s.obs).all()) and bool(torch.isfinite(s.q).all())
    assert bool(torch.isfinite(s.reward).all())
    assert s.progress.tolist() == [6, 1, 6, 6]


def test_make_applies_cfg_sim_block_and_defaults_to_cuda():
    import yaml
    with open(os.path.join(os.path.dirname(__file__), "..", "cfg", "task", "Ant.yaml")) as f:
        cfg = yaml.safe_load(f)
    env = tgt.make("Ant", num_envs=2, cfg=cfg, device="cpu")
    assert env.task.sim_params.dt == pytest.approx(0.0166)
    assert env.task.sim_params.substeps == 2 and env.task.dt == pytest.approx(0.0166)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tgt.make("Ant", num_envs=2)


def _task_yaml(name):
    import yaml
    with open(os.path.join(os.path.dirname(__file__), "..", "cfg", "task", f"{name}.yaml")) as f:
        return yaml.safe_load(f)


def test_make_applies_decimation_and_hands_the_ground_to_the_env():
    """AnymalTerrain.yaml's sim block is the physics step (dt 0.005, 1
    substep); decimation 4 makes the JAX task's 0.02 s control step of 4
    substeps, and what derives from dt follows it. Ant is unchanged."""
    env = tgt.make("AnymalTerrain", num_envs=2, cfg=_task_yaml("AnymalTerrain"), device="cpu")
    t = env.task
    assert (t.decimation, t.sim_params.substeps) == (4, 4)
    assert t.sim_params.dt == pytest.approx(0.02) and t.dt == pytest.approx(0.02)
    assert (t.max_episode_length, t.push_interval) == (1000, 750)
    assert env.physics_step.hf is t.field and t.field.shape == (820, 1620)
    ant = tgt.make("Ant", num_envs=2, cfg=_task_yaml("Ant"), device="cpu").task
    assert (ant.decimation, ant.sim_params.substeps) == (1, 2)
    assert ant.sim_params.dt == pytest.approx(0.0166)
    assert tgt.make("Ant", num_envs=2, device="cpu").physics_step.hf is None


def test_anymal_terrain_rollout_stays_finite_and_on_the_grid():
    env = tgt.make("AnymalTerrain", num_envs=8, seed=0, device="cpu", num_levels=2, num_types=4)
    s = env.reset(0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        s = env.step(s, torch.rand(8, 12, generator=gen) * 2 - 1)
        for x in (s.obs, s.q, s.qd, s.reward):
            assert bool(torch.isfinite(x).all())
        lev = s.task.terrain_level
        assert lev.dtype == torch.int32 and bool(((lev >= 0) & (lev < 2)).all())
    assert s.obs.shape == (8, 188) and s.task.terrain_type.dtype == torch.int32
    # int32 task leaves survive the masked reset's select
    from thormang_isaacgym_tpu_torch.engine.env import mask_select
    mixed = mask_select(torch.tensor([True, False] * 4), s.task,
                        dataclasses.replace(s.task, terrain_level=s.task.terrain_level + 1))
    assert mixed.terrain_level.dtype == torch.int32
    assert mixed.terrain_level.tolist() == (s.task.terrain_level + torch.tensor([0, 1] * 4)).tolist()
