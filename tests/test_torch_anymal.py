"""Port parity for tasks/anymal.py and tasks/anymal_terrain.py.

``post_physics`` obs, reward, done, feet air time and the curriculum's
terrain level match the JAX package on identical states carried across by
parity/convert.py (4 envs, a 2 x 4 terrain grid). The states are chosen so
that every branch fires: promotion at a timeout, demotion at a base contact,
a knee contact (collision reward), first foot contacts (air-time reward),
and a push in ``pre_physics`` (the push's dv comes from a different random
stream in each package, so its pattern and size are compared, not its
value). Tolerances: obs atol 1e-4 / rtol 1e-5 (the JAX height scan is the
clustered sampler, the port's the plain gather); reward atol 1e-6 / rtol
1e-4; feet air time atol 1e-6; levels and done exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.tasks.anymal_terrain import AnymalTerrainTaskState as JTaskState
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.tasks.anymal import AnymalTaskState

B = 4
KW = dict(num_levels=2, num_types=4)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def envs():
    jenv = tgx.make("AnymalTerrain", num_envs=B, seed=0, **KW)
    env = tgt.make("AnymalTerrain", num_envs=B, seed=0, device="cpu", **KW)
    return jenv, env


def _jax_state(jenv):
    """A JAX AnymalTerrain EnvState whose envs take the branches above:
    0 promotes at its timeout, 1 demotes at a base contact, 2 has a knee
    contact and first foot contacts, 3 is pushed this step."""
    task = jenv.task
    rng = np.random.default_rng(0)
    js = jenv.init_fn(jax.random.key(0))
    level = np.array([0, 1, 1, 0], np.int32)
    ttype = np.array([0, 1, 2, 3], np.int32)
    origin = task.grid.env_origins[level, ttype] + [0.0, 0.0, 0.62]
    q = np.array(js.q)
    q[:, 0:3] = origin + np.array([[5.0, 0.3, -0.1], [0.1, 0.0, -0.08],
                                   [0.4, -0.6, -0.05], [4.5, 0.2, -0.1]])
    qr = rng.normal(size=(B, 4)) * 0.1 + [1.0, 0.0, 0.0, 0.3]
    q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
    q[:, 7:] = np.array(task.default_dof_pos) + rng.uniform(-0.3, 0.3, (B, 12))
    qd = rng.normal(size=(B, 18))
    net = rng.normal(size=(B, 13, 3)) * 0.1
    net[1, 0] = [0.0, 0.0, 50.0]                        # base contact: done
    net[2, task.knees[0]] = [0.0, 0.0, 5.0]             # knee contact
    net[2, [task.feet[0], task.feet[2]]] = [1.0, 0.5, 10.0]
    progress = np.array([task.max_episode_length - 1, 10, 100, task.push_interval - 1], np.int32)
    jt = JTaskState(
        commands=jnp.asarray([[0.5, 0.2, 0.1], [0.6, 0.5, -0.3], [0.3, -0.4, 1.0], [-0.4, 0.3, 0.0]],
                             jnp.float32),
        actions=jnp.asarray(rng.uniform(-1, 1, (B, 12)), jnp.float32),
        last_actions=jnp.asarray(rng.uniform(-1, 1, (B, 12)), jnp.float32),
        last_dof_vel=jnp.asarray(rng.normal(size=(B, 12)), jnp.float32),
        feet_air_time=jnp.asarray([[0.1, 0.0, 0.0, 0.2], [0.0, 0.3, 0.0, 0.0],
                                   [0.3, 0.0, 0.6, 0.2], [0.0, 0.0, 0.0, 0.0]], jnp.float32),
        terrain_level=jnp.asarray(level), terrain_type=jnp.asarray(ttype),
        origin=jnp.asarray(origin, jnp.float32))
    return dataclasses.replace(js, q=jnp.asarray(q, jnp.float32), qd=jnp.asarray(qd, jnp.float32),
                               net_contact=jnp.asarray(net, jnp.float32),
                               progress=jnp.asarray(progress), task=jt)


def _port_state(env, js):
    ts = env.init_fn(0)
    return dataclasses.replace(
        ts, q=_t(js.q), qd=_t(js.qd), net_contact=_t(js.net_contact),
        progress=_t(js.progress, torch.int64),
        task=convert.anymal_terrain_task_state(jax.tree.map(np.asarray, js.task)))


def test_anymal_terrain_post_physics_matches_jax(envs):
    jenv, env = envs
    js = _jax_state(jenv)
    jobs, jrew, jdone, jtask, _ = jenv.task.post_physics(js, js.task)
    ts = _port_state(env, js)
    obs, rew, done, task, metrics = env.task.post_physics(ts, ts.task)
    assert obs.shape == (B, 188)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-6, rtol=1e-4)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(task.feet_air_time.numpy(), np.asarray(jtask.feet_air_time),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(task.terrain_level.numpy(), np.asarray(jtask.terrain_level))
    assert task.terrain_level.dtype == torch.int32
    # the branches fired: promotion (0), demotion (1), knee contact (2),
    # first foot contacts (2)
    assert task.terrain_level.tolist() == [1, 0, 1, 0] and done.tolist() == [0, 1, 0, 0]
    assert float(metrics["rew_collision"][2]) < 0 and float(metrics["rew_air_time"][2]) != 0


def test_anymal_terrain_push_matches_jax(envs):
    jenv, env = envs
    js = _jax_state(jenv)
    actions = np.random.default_rng(1).uniform(-1, 1, (B, 12)).astype(np.float32)
    jctrl, jw, jtask = jenv.task.pre_physics(js, jnp.asarray(actions))
    ts = _port_state(env, js)
    ctrl, w, task = env.task.pre_physics(ts, _t(actions))
    np.testing.assert_allclose(ctrl.target_pos.numpy(), np.asarray(jctrl.target_pos), atol=1e-6)
    pushed = w.abs().sum((1, 2)) > 0
    assert pushed.tolist() == (np.abs(np.asarray(jw)).sum((1, 2)) > 0).tolist() \
        == [False, False, False, True]
    mass, dt = float(ts.params.body_mass[3, 0]), env.task.dt
    assert float(w[3, 0, 3:5].abs().max()) <= mass / dt and float(w[3, 0, 5]) == 0.0
    np.testing.assert_array_equal(task.last_actions.numpy(), np.asarray(jtask.last_actions))
    np.testing.assert_allclose(task.last_dof_vel.numpy(), np.asarray(jtask.last_dof_vel))


def test_anymal_post_physics_matches_jax():
    """The base task (flat ground): obs (61), reward, done."""
    jenv = tgx.make("Anymal", num_envs=B, seed=0)
    env = tgt.make("Anymal", num_envs=B, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    js = jenv.init_fn(jax.random.key(0))
    q = np.array(js.q)
    qr = rng.normal(size=(B, 4)) * 0.2 + [1.0, 0.0, 0.0, 0.0]
    q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
    q[:, 7:] += rng.uniform(-0.3, 0.3, (B, 12))
    net = rng.normal(size=(B, 13, 3)) * 0.3
    net[1, env.task.knees[1]] = [0.0, 3.0, 0.0]
    jt = dataclasses.replace(js.task, commands=jnp.asarray(rng.uniform(-1, 1, (B, 3)), jnp.float32),
                             actions=jnp.asarray(rng.uniform(-1, 1, (B, 12)), jnp.float32))
    js = dataclasses.replace(js, q=jnp.asarray(q, jnp.float32),
                             qd=jnp.asarray(rng.normal(size=(B, 18)), jnp.float32),
                             net_contact=jnp.asarray(net, jnp.float32), task=jt)
    jobs, jrew, jdone, _, _ = jenv.task.post_physics(js, js.task)
    ts = env.init_fn(0)
    task = AnymalTaskState(_t(jt.commands), _t(jt.actions))
    ts = dataclasses.replace(ts, q=_t(js.q), qd=_t(js.qd), net_contact=_t(js.net_contact), task=task)
    obs, rew, done, _, _ = env.task.post_physics(ts, task)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-6, rtol=1e-4)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done.tolist() == [0, 1, 0, 0]
