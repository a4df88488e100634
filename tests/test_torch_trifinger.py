"""Port parity for models/trifinger.py and tasks/trifinger.py (the kernel's
box instance: the fingertip spheres and link capsules against a free 16 g
cube, sphere-box and capsule-box).

- ``make`` with cfg/task/Trifinger.yaml reads its env block as the JAX
  ``make`` does (asymmetric_obs, taskDifficulty, normalizeObs,
  applySafetyDamping, commandMode, normalizeAction; the same keys warned
  about): obs 41, states 113, dt 0.02 s of 4 substeps; the scene, its 9
  actor pairs (6 capsule-box, 3 sphere-box) and the torque rows of the 3
  tip bodies equal to JAX's.
- The fingertip states of JAX-sampled reset states (sites: position,
  orientation, velocity, angular velocity) atol 1e-6; the port's own resets
  inside the joint limits, the arena and the goal ranges.
- ``pre_physics`` in torque mode (with the safety damping) and in position
  mode: the efforts atol 1e-6.
- ``post_physics`` and ``compute_states`` on identical states (the
  fingertips on the cube, one env at its goal, the tips' net contact force
  and torque non-zero), with the reach term on and, past 5e7 env steps,
  off: obs and the 113 states atol 1e-5 / rtol 1e-5, reward atol 1e-4 / rtol
  1e-5, successes exactly.
- One control step (0.02 s, 4 substeps) of the port's plain step against the
  JAX op path ``build_step_fn(fused=False)`` at B = 4 on the scene cut to
  finger 0 and the cube, its fingertip pressing on the cube's top face: q
  atol=rtol 2e-3, qd 2e-2, net atol 1.0 / rtol 5e-3 (tests/test_fused.py's).
  The whole scene's (marked slow: its JAX op path takes ~20 s to jit one
  substep on the CPU) over 2 control steps.
- One TrifingerPPO iteration at 8 envs on the CPU from a JAX PPO init
  carried across (the asymmetric critic's value on the states atol 1e-5).
"""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.learn import ppo as jppo
from thormang_isaacgym_tpu.models import trifinger as jtri_model
from thormang_isaacgym_tpu.models.robot import DRIVE_EFFORT as J_DRIVE_EFFORT
from thormang_isaacgym_tpu.models.scene import compose as jcompose
from thormang_isaacgym_tpu.models.urdf import load_urdf as jload_urdf
from thormang_isaacgym_tpu.ops import collide as jcollide
from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.learn import ppo as tppo
from thormang_isaacgym_tpu_torch.models import trifinger as tri_model
from thormang_isaacgym_tpu_torch.models.robot import DRIVE_EFFORT
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.models.urdf import load_urdf
from thormang_isaacgym_tpu_torch.ops import collide
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import build_plain_step_fn
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.tasks.trifinger import TrifingerTaskState

from test_torch_fused import TRIFINGER_GRIP, trifinger_contact_q
from test_torch_hands import _same_model

B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("asymmetric_obs", "task_difficulty", "normalize_obs", "apply_safety_damping",
            "command_mode", "normalize_action", "max_episode_length", "clip_obs", "clip_actions")


def _yaml(kind, name):
    with open(os.path.join(ROOT, "cfg", kind, f"{name}.yaml")) as f:
        return yaml.safe_load(f)


def _warned(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        env = fn()
    return env, sorted(str(w.message).split("'")[1] for w in rec
                       if "matches no attribute" in str(w.message))


@pytest.fixture(scope="module")
def envs():
    cfg = _yaml("task", "Trifinger")
    jenv, jkeys = _warned(lambda: tgx.make("Trifinger", num_envs=B, seed=0, cfg=cfg))
    env, keys = _warned(lambda: tgt.make("Trifinger", num_envs=B, seed=0, cfg=cfg, device="cpu"))
    return jenv, env, jkeys, keys


def test_make_with_its_yaml(envs):
    jenv, env, jkeys, keys = envs
    task, jtask = env.task, jenv.task
    assert keys == jkeys
    for k in ENV_KEYS:
        assert getattr(task, k) == getattr(jtask, k), k
    assert (task.task_difficulty, task.command_mode, task.asymmetric_obs) == (4, "torque", True)
    m, jm = task.model, jtask.model
    _same_model(m, jm)
    assert collide.pairs(m) == tuple(jcollide._pairs(jm))
    kinds = [k for _, _, k in collide.pairs(m)]
    assert (kinds.count("capbox"), kinds.count("sphere"), m.nb, m.nj) == (6, 3, 11, 9)
    assert (env.num_obs, task.num_states, env.num_actions) == (41, 113, 9)
    assert (task.sim_params.dt, task.sim_params.substeps) == (0.02, 4)
    np.testing.assert_array_equal(task.dof_ids, np.asarray(jtask.dof_ids))
    assert task.net_torque_bodies == tuple(jtask.net_torque_bodies)
    step = env.physics_step
    assert step.pair_mode == 2 and step.layout == "local" and step.tq_bodies == task.net_torque_bodies


def _jax_resets(jt, seed):
    reset = jax.jit(jt.reset_fn)
    task0 = jax.tree.map(lambda x: x[0], jt.default_task_state(jax.random.key(0)))
    out = [reset(k, jt.model.default_params(), task0) for k in jax.random.split(jax.random.key(seed), B)]
    return (np.stack([np.asarray(r[0]) for r in out]), np.stack([np.asarray(r[1]) for r in out]),
            jax.tree.map(lambda *x: np.stack(x), *[r[3] for r in out]))


def test_reset_fingertips_match_jax(envs):
    jenv, env, _, _ = envs
    task = env.task
    q, qd, jtask = _jax_resets(jenv.task, 1)
    ft = task._fingertip_state(torch.as_tensor(q), torch.as_tensor(qd))
    np.testing.assert_allclose(ft.numpy(), jtask.last_fingertip, atol=1e-6)
    # the port's own resets: joints in their limits, the cube in the arena, goals in range
    s = env.reset(3)
    jq = s.q[:, 7:][:, task._dof]
    assert bool(((jq >= task.q_lo - 1e-6) & (jq <= task.q_hi + 1e-6)).all())
    r = torch.linalg.norm(s.q[:, 0:2], dim=-1)
    assert bool((r <= tri_model.ARENA_RADIUS - 0.065 + 1e-6).all())
    g = s.task
    assert bool(((g.goal_pos[:, 2] >= 0.0325 - 1e-6) & (g.goal_pos[:, 2] <= 0.1 + 1e-6)).all())
    np.testing.assert_allclose(torch.linalg.norm(g.goal_quat, dim=-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(g.last_fingertip.numpy(),
                               task._fingertip_state(s.q, s.qd).numpy(), atol=1e-6)


def _task_state(jtask):
    return TrifingerTaskState(**{f.name: torch.as_tensor(np.asarray(getattr(jtask, f.name), np.float32))
                                 for f in dataclasses.fields(TrifingerTaskState)})


def _states(jenv, env, global_step=5):
    """A JAX and a port EnvState on the same state: the fingertips on the
    cube (envs 0-2), env 3 from a JAX reset; env 0's goal the cube's pose
    (a success); the previous step's fingertips and cube 2 mm off; the tips'
    net contact force and torque non-zero."""
    jt, tt = jenv.task, env.task
    rng = np.random.default_rng(2)
    q, qd, jtask = _jax_resets(jt, 4)
    q[:3] = trifinger_contact_q(tt, rng, 3)
    qd = (qd + rng.normal(size=qd.shape) * 0.2).astype(np.float32)
    ft = tt._fingertip_state(torch.as_tensor(q), torch.as_tensor(qd)).numpy()
    jtask = dataclasses.replace(
        jtask, actions=rng.uniform(-1, 1, (B, 9)).astype(np.float32),
        torques=rng.uniform(-0.36, 0.36, (B, 9)).astype(np.float32),
        last_fingertip=(ft + rng.normal(size=ft.shape) * 2e-3).astype(np.float32),
        last_object=np.concatenate([q[:, 0:7] + rng.normal(size=(B, 7)) * 2e-3,
                                    rng.normal(size=(B, 6)) * 0.1], 1).astype(np.float32))
    jtask.goal_pos[0], jtask.goal_quat[0] = q[0, 0:3] + 0.005, q[0, 3:7]
    net = np.zeros((B, tt.model.nb, 3), np.float32)
    tq_ = np.zeros((B, tt.model.nb, 3), np.float32)
    tips = list(tt.net_torque_bodies)
    net[:, tips] = rng.normal(size=(B, 3, 3)) * 2.0
    tq_[:, tips] = rng.normal(size=(B, 3, 3)) * 0.02
    js = jax.jit(jenv.init_fn)(jax.random.key(0))
    js = dataclasses.replace(js, q=jnp.asarray(q, jnp.float32), qd=jnp.asarray(qd),
                             net_contact=jnp.asarray(net), net_torque=jnp.asarray(tq_),
                             global_step=jnp.asarray(global_step, js.global_step.dtype),
                             task=jax.tree.map(jnp.asarray, jtask))
    ts = dataclasses.replace(env.init_fn(0), q=torch.as_tensor(q, dtype=torch.float32),
                             qd=torch.as_tensor(qd), net_contact=torch.as_tensor(net),
                             net_torque=torch.as_tensor(tq_),
                             global_step=torch.tensor(global_step), task=_task_state(jtask))
    return js, ts


def test_pre_physics_matches_jax(envs):
    jenv, env, _, _ = envs
    jt, tt = jenv.task, env.task
    js, ts = _states(jenv, env)
    a = np.random.default_rng(3).uniform(-1.2, 1.2, (B, 9)).astype(np.float32)
    try:
        for mode in ("torque", "position"):
            jt.command_mode = tt.command_mode = mode
            jctrl, jw, jtask = jt.pre_physics(js, jnp.asarray(a))
            tctrl, tw, ttask = tt.pre_physics(ts, torch.as_tensor(a))
            np.testing.assert_allclose(tctrl.effort.numpy(), np.asarray(jctrl.effort), atol=1e-6)
            np.testing.assert_allclose(ttask.torques.numpy(), np.asarray(jtask.torques), atol=1e-6)
            assert not tw.any() and not tctrl.target_pos.any()
            assert float(tctrl.effort.abs().max()) == pytest.approx(0.36)   # clamped
    finally:
        jt.command_mode = tt.command_mode = "torque"


@pytest.mark.parametrize("global_step", [5, 20_000_000])
def test_post_physics_and_states_match_jax(envs, global_step):
    """At global step 5 (x 4 envs) the reach term counts, at 2e7 it is off."""
    jenv, env, _, _ = envs
    jt, tt = jenv.task, env.task
    js, ts = _states(jenv, env, global_step)
    jobs, jrew, jdone, jtask, jm = jax.jit(jt.post_physics)(js, js.task)
    obs, rew, done, task, m = tt.post_physics(ts, ts.task)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(task.successes.numpy(), np.asarray(jtask.successes))
    assert task.successes.numpy().tolist()[0] == 1.0
    for k in ("pose_reward", "finger_obj_dist"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), atol=1e-5, rtol=1e-5)
    for f in ("last_object", "last_fingertip"):
        np.testing.assert_allclose(getattr(task, f).numpy(), np.asarray(getattr(jtask, f)), atol=1e-6)
    jstates = jax.jit(jt.compute_states)(dataclasses.replace(js, task=jtask), jtask)
    states = tt.compute_states(dataclasses.replace(ts, task=task), task)
    assert tuple(states.shape) == (B, 113)
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates), atol=1e-5, rtol=1e-5)
    assert float(states[:, -18:].abs().min(-1).values.max()) > 0.0    # the tip wrenches


def _one_finger(load, comp, drive_effort, model_mod):
    """The Trifinger scene cut to finger 0 and the cube (the same URDF lines
    in both packages)."""
    urdf = "\n".join(ln for ln in model_mod.make_trifinger_urdf().splitlines()
                     if "_120" not in ln and "_240" not in ln)
    robot = load(urdf, fix_base_link=True, armature=2e-4, name="trifinger")
    robot._defaults["drive_mode"] = np.full(robot.nj, drive_effort, np.int32)
    robot._defaults["drive_effort_limit"] = np.full(robot.nj, model_mod.MAX_TORQUE, np.float32)
    cube = load(model_mod.make_cube_urdf())
    return comp([(robot, (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0), "robot/"),
                 (cube, (0.0, 0.0, 0.0325, 1.0, 0.0, 0.0, 0.0), "obj/")], name="trifinger_scene")


def _op_path_step(jm, tm, sp, q, qd, effort, steps):
    jstep = jax.jit(jax_build_step_fn(jm, sp, fused=False, need_torque=True))
    step = build_plain_step_fn(tm, sp)
    jparams, tparams = jm.default_params().batch(B), tm.default_params().batch(B)
    from thormang_isaacgym_tpu.ops.sim import Controls as JControls
    from thormang_isaacgym_tpu_torch.ops.sim import Controls
    z = np.zeros_like(effort)
    jctrl = JControls(jnp.asarray(z), jnp.asarray(z), jnp.asarray(effort))
    tctrl = Controls(*(torch.as_tensor(x) for x in (z, z, effort)))
    jq, jqd, tq, tqd = jnp.asarray(q), jnp.asarray(qd), torch.as_tensor(q), torch.as_tensor(qd)
    for _ in range(steps):
        jq, jqd, jnet = jstep(jparams, jq, jqd, jctrl, jnp.zeros((B, jm.nb, 6)))
        tq, tqd, tnet = step(tparams, tq, tqd, tctrl, torch.zeros(B, tm.nb, 6))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(tnet.numpy(), np.asarray(jnet), atol=1.0, rtol=5e-3)
    return tnet


def test_op_path_matches_jax_on_one_finger(envs):
    _, env, _, _ = envs
    tm = _one_finger(load_urdf, compose, DRIVE_EFFORT, tri_model)
    jm = _one_finger(jload_urdf, jcompose, J_DRIVE_EFFORT, jtri_model)
    _same_model(tm, jm)
    assert [k for _, _, k in collide.pairs(tm)] == ["capbox", "capbox", "sphere"]
    rng = np.random.default_rng(5)
    q = np.zeros((B, tm.nq), np.float32)
    q[:, 0:3] = [0.0, 0.0, 0.0325 - 5e-4]
    q[:, 3] = 1.0
    q[:, 7:] = np.asarray(TRIFINGER_GRIP[0:3]) + rng.normal(size=(B, 3)) * 2e-3
    qd = (rng.normal(size=(B, tm.nv)) * 0.05).astype(np.float32)
    effort = rng.uniform(-0.36, 0.36, (B, tm.nj)).astype(np.float32)
    f = forward_kinematics(tm, torch.as_tensor(q), torch.as_tensor(qd))
    assert bool((collide.candidates(tm, f)[-1][5] > 0).all())    # the tip presses on the cube
    tnet = _op_path_step(jm, tm, env.task.sim_params, q, qd, effort, 1)
    assert float(tnet[:, tm.body_id("obj/cube"), :3].abs().max()) > 1.0


@pytest.mark.slow
def test_op_path_matches_jax_whole_scene(envs):
    """(slow: the JAX op path on the whole scene takes ~20 s to jit on the
    CPU.) Two control steps from the three fingertips on the cube."""
    jenv, env, _, _ = envs
    rng = np.random.default_rng(6)
    q = trifinger_contact_q(env.task, rng, B)
    qd = (rng.normal(size=(B, env.task.model.nv)) * 0.05).astype(np.float32)
    effort = np.zeros((B, env.task.model.nj), np.float32)
    effort[:, env.task.dof_ids] = rng.uniform(-0.36, 0.36, (B, 9))
    _op_path_step(jenv.task.model, env.task.model, env.task.sim_params, q, qd, effort, 2)


def test_trifinger_ppo_iteration_on_cpu(envs):
    jenv, _, _, _ = envs
    train = _yaml("train", "TrifingerPPO")
    small = dict(horizon_length=4, minibatch_size=32, mixed_precision=False)
    jcfg = dataclasses.replace(jppo.PPOConfig.from_rlgames(train), **small)
    tcfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(train), **small)
    env = tgt.make("Trifinger", num_envs=8, seed=0, cfg=_yaml("task", "Trifinger"), device="cpu")
    jp = jppo.PPO(jenv, jcfg)
    jts = jp.init(jax.random.key(1))
    ppo = tppo.PPO(env, tcfg, device="cpu")
    ts = convert.train_state(ppo, jax.tree.map(np.asarray, jts))
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(16, 41)).astype(np.float32)
    states = rng.normal(size=(16, 113)).astype(np.float32)
    for g, w in zip(ppo._policy(ts, torch.as_tensor(obs), torch.as_tensor(states)),
                    jp._policy(jts, jnp.asarray(obs), jnp.asarray(states))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    state = env.reset(0)
    ts, state, metrics = ppo.train_iteration(ts, state)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), (k, v)
    assert ts.epoch == 1 and tuple(state.states.shape) == (8, 113)
    assert bool(torch.isfinite(state.states).all()) and float(ts.states_rms.count) > 1.0
    assert env.physics_step.launches == 0
