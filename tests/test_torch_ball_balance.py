"""Port parity for tasks/ball_balance.py and the BallBalance slice.

- ``post_physics`` obs, reward and done against the JAX task on identical
  states (random bot and ball states, leg contact forces and torques):
  obs atol 1e-4 / rtol 1e-5, reward atol 1e-6 / rtol 1e-5, done exactly.
- ``pre_physics`` knee targets against JAX on identical targets and actions
  (atol 1e-6); the port's reset draws within the JAX reset's ranges (the
  random streams differ by design).
- The op path against JAX ``build_step_fn(fused=False, attractors=...)`` at
  the task's SimParams (dt 1/60 s, 8 substeps) for 10 control steps from
  JAX-sampled reset states and from states with the ball in the tray or
  pressed into a leg: q atol=rtol 2e-3, qd 2e-2, net atol 1.0 / rtol 5e-3
  (tests/test_fused.py's tolerances).
- ``make("BallBalance", cfg=BallBalance.yaml)`` hands the attractors and the
  lower legs' torque rows to the kernel's wrapper and applies the YAML's
  sim block (dt 0.01 s, 1 substep); one BallBalancePPO iteration at 64 envs
  on the CPU gives finite metrics."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.ops.sim import Controls as JControls
from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
from thormang_isaacgym_tpu.tasks.ball_balance import BBotTaskState as JBBotTaskState
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom
from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
from thormang_isaacgym_tpu_torch.ops.sim import Controls, build_plain_step_fn
from thormang_isaacgym_tpu_torch.tasks import ball_balance as bb

from test_torch_fused import ball_balance_q

B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _yaml(kind, name):
    with open(os.path.join(ROOT, "cfg", kind, name)) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def envs():
    return (tgx.make("BallBalance", num_envs=B, seed=0),
            tgt.make("BallBalance", num_envs=B, seed=0, device="cpu"))


def test_post_physics_matches_jax(envs):
    jenv, env = envs
    rng = np.random.default_rng(0)
    js = jenv.init_fn(jax.random.key(0))
    q = np.array(js.q)
    q[:, 0:3] += rng.normal(size=(B, 3)) * 0.05
    qr = rng.normal(size=(B, 4)) * 0.1 + [1.0, 0.0, 0.0, 0.0]
    q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
    q[:, 7:10] = rng.uniform(-0.5, 0.5, (B, 3)) + [0.0, 0.0, 0.5]
    q[2, 9] = 0.12                                   # below 1.5 r: done
    q[:, 14:] = rng.uniform(-0.6, 0.6, (B, 6))
    qd = rng.normal(size=(B, 18))
    net = rng.normal(size=(B, 8, 3)) * 10
    tq = rng.normal(size=(B, 8, 3))
    js = dataclasses.replace(js, q=jnp.asarray(q, jnp.float32), qd=jnp.asarray(qd, jnp.float32),
                             net_contact=jnp.asarray(net, jnp.float32),
                             net_torque=jnp.asarray(tq, jnp.float32))
    ts = env.init_fn(0)
    ts = dataclasses.replace(ts, q=torch.as_tensor(np.array(js.q)),
                             qd=torch.as_tensor(np.array(js.qd)),
                             net_contact=torch.as_tensor(np.array(js.net_contact)),
                             net_torque=torch.as_tensor(np.array(js.net_torque)))
    jobs, jrew, jdone, _, _ = jenv.task.post_physics(js, js.task)
    obs, rew, done, _, metrics = env.task.post_physics(ts, ts.task)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done.numpy().tolist() == [0.0, 0.0, 1.0, 0.0]
    assert float(obs[:, 12:].abs().max()) > 0.1      # the leg sensors are read


def test_pre_physics_and_reset(envs):
    jenv, env = envs
    rng = np.random.default_rng(1)
    targets = rng.uniform(-1.5, 1.5, (B, 6)).astype(np.float32)
    actions = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    js = jenv.init_fn(jax.random.key(0))
    js = dataclasses.replace(js, task=JBBotTaskState(jnp.asarray(targets)))
    jctrl, jw, jtask = jenv.task.pre_physics(js, jnp.asarray(actions))
    assert env.task.dt == jenv.task.dt              # no YAML sim block: the task's 1/60 s
    ts = dataclasses.replace(env.init_fn(0), task=bb.BBotTaskState(torch.as_tensor(targets)))
    ctrl, w, task = env.task.pre_physics(ts, torch.as_tensor(actions))
    np.testing.assert_allclose(ctrl.target_pos.numpy(), np.asarray(jctrl.target_pos), atol=1e-6)
    np.testing.assert_array_equal(task.dof_targets.numpy(), ctrl.target_pos.numpy())
    assert not w.any() and not ctrl.effort.any()
    # reset: bot at rest, ball within the JAX reset's ranges, moving inward and down
    q, qd, _, t = env.task.reset_fn(EnvRandom(0, torch.zeros(64, dtype=torch.int64), 0),
                                    None, bb.BBotTaskState(torch.zeros(64, 6)))
    np.testing.assert_allclose(q[:, 0:7].numpy(), np.tile([0, 0, bb.TRAY_H, 1, 0, 0, 0], (64, 1)),
                               atol=1e-7)
    r = torch.linalg.norm(q[:, 7:9], dim=-1)
    assert float(r.min()) >= 0.01 - 1e-6 and float(r.max()) <= 0.25 + 1e-6
    assert float(q[:, 9].min()) >= 1.0 and float(q[:, 9].max()) <= 2.0
    assert (qd[:, 11] == -5.0).all() and (torch.sum(qd[:, 9:11] * q[:, 7:9], -1) < 0).all()
    assert not q[:, 14:].any() and not t.dof_targets.any()


def test_op_path_matches_jax(envs):
    jenv, env = envs
    jm, tm = jenv.task.model, env.task.model
    keys = jax.random.split(jax.random.key(3), B)
    resets = [jenv.task.reset_fn(k, jm.default_params(), None) for k in keys]
    q = np.stack([np.asarray(r[0]) for r in resets])
    qd = np.stack([np.asarray(r[1]) for r in resets])
    rng = np.random.default_rng(4)
    q[2:] = ball_balance_q(env.task, rng, 2)         # ball in the tray, ball on a leg
    q, qd = q.astype(np.float32), qd.astype(np.float32)
    tp = np.zeros((B, tm.nj), np.float32)
    tp[:, env.task.knees] = rng.uniform(-0.3, 0.3, (B, 3))
    jstep = jax.jit(jax_build_step_fn(jm, jenv.task.sim_params, attractors=jenv.task.attractors,
                                      fused=False))
    step = build_plain_step_fn(tm, env.task.sim_params, 0.0, env.task.attractors)
    assert env.task.sim_params == dataclasses.replace(env.task.sim_params, dt=1 / 60, substeps=8)
    z = np.zeros((B, tm.nj), np.float32)
    jargs = (jm.default_params().batch(B), JControls(*(jnp.asarray(x) for x in (tp, z, z))),
             jnp.zeros((B, tm.nb, 6)))
    targs = (tm.default_params().batch(B), Controls(*(torch.as_tensor(x) for x in (tp, z, z))),
             torch.zeros(B, tm.nb, 6))
    jq, jqd, tq, tqd = jnp.asarray(q), jnp.asarray(qd), torch.as_tensor(q), torch.as_tensor(qd)
    ball_touched = 0.0
    for _ in range(10):
        jq, jqd, jnet = jstep(jargs[0], jq, jqd, jargs[1], jargs[2])
        tq, tqd, tnet = step(targs[0], tq, tqd, targs[1], targs[2])
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(tnet.numpy(), np.asarray(jnet), atol=1.0, rtol=5e-3)
        ball_touched = max(ball_touched, float(tnet[2:, env.task.ball_body, :3].abs().max()))
    assert ball_touched > 1.0                       # the pairs act on the ball


def test_make_hands_attractors_and_sensors_to_the_kernel():
    env = tgt.make("BallBalance", num_envs=8, seed=0, device="cpu",
                   cfg=_yaml("task", "BallBalance.yaml"))
    task, step = env.task, env.physics_step
    assert (task.sim_params.dt, task.sim_params.substeps) == (0.01, 1)
    assert task.dt == 0.01 and task.clip_obs == 5.0
    assert step.attractors == tuple(task.attractors) and len(step.attractors) == 3
    assert step.tq_bodies == tuple(sorted(task.legs)) and step.pair_mode
    m = task.model
    assert step.out_rows == m.nq + m.nv + 3 * m.nb + 3 * 3
    mi, mf = step._tables
    assert mi[39:42].tolist() == [7, 3, 8]          # pairs, attractors, pair bodies
    s = env.reset(0)
    s = env.step(s, torch.zeros(8, 3))
    legs = torch.tensor(task.legs)
    others = [b for b in range(m.nb) if b not in task.legs]
    assert not s.net_torque[:, others].any()
    assert torch.isfinite(s.net_torque[:, legs]).all()


def test_ball_balance_ppo_iteration_on_cpu():
    env = tgt.make("BallBalance", num_envs=64, seed=0, device="cpu",
                   cfg=_yaml("task", "BallBalance.yaml"))
    cfg = PPOConfig.from_rlgames(_yaml("train", "BallBalancePPO.yaml"))
    assert (cfg.units, cfg.activation, cfg.separate) == ((128, 64, 32), "elu", False)
    assert (cfg.horizon_length, cfg.minibatch_size, cfg.mini_epochs) == (16, 8192, 8)
    assert (cfg.mixed_precision, cfg.normalize_value, cfg.bounds_loss_coef,
            cfg.reward_shaper_scale) == (False, True, 1e-4, 0.1)
    ppo = PPO(env, cfg, device="cpu")
    ts = ppo.init(0)
    state = env.reset(0)
    ts, state, metrics = ppo.train_iteration(ts, state)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), (k, v)
    assert ts.epoch == 1 and tuple(state.obs.shape) == (64, 24)
