"""Port parity for models/franka.py, tasks/franka_cabinet.py and
tasks/franka_cube_stack.py (the Franka slice: FrankaCabinet's two fixed
roots, FrankaCubeStack's operational-space control on ops/inertia.py).

- ``load_franka`` and the task scenes: topology, geoms and ``_defaults``
  equal to JAX's, exactly; the actor pairs and the kernel's box instance.
- ``pre_physics`` against JAX (jitted) on identical states at B = 4: two
  JAX-sampled reset states and two contact states (tests/test_torch_fused.py)
  with seeded velocities and actions. Cabinet: the position targets atol
  1e-6. CubeStack osc: the arm torques atol 2e-3 / rtol 1e-3 (the OSC's two
  nested float32 inverses of the arm's mass matrix and of the task-space
  one, on torques of up to the 87 N m limit), the gripper targets exactly;
  joint_tor: atol 1e-5.
- ``post_physics`` against JAX on identical states: obs, reward and metrics
  atol 1e-5 / rtol 1e-5, done exactly; the states include a drawer out past
  0.39 m (done) and a stacked cube (reward 16, done).
- ``make`` of both names: a ``VecEnv`` on CUDA by default (raises without a
  card), on the CPU with ``device="cpu"``: the YAML's sim block, the box
  instance, two finite control steps of the plain version; CubeStack's
  ``controlType`` from its YAML.
- The op path (the kernel's plain version) against the JAX op path over one
  control step, and the host-compiled kernel against the JAX kernel body on
  the Franka arm alone: marked ``slow`` (the JAX compiles take minutes on
  the CPU)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.engine.env import EnvState as JEnvState
from thormang_isaacgym_tpu.models import franka as jfranka
from thormang_isaacgym_tpu.ops import collide as jcollide
from thormang_isaacgym_tpu.tasks import franka_cabinet as jcabinet
from thormang_isaacgym_tpu.tasks import franka_cube_stack as jcube
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.models import franka
from thormang_isaacgym_tpu_torch.ops import collide, fused
from thormang_isaacgym_tpu_torch.tasks import franka_cabinet as cabinet
from thormang_isaacgym_tpu_torch.tasks import franka_cube_stack as cube

from test_torch_fused import franka_cabinet_contact_q, franka_cube_contact_q
from test_torch_hands import _same_model

B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _yaml(kind, name):
    with open(os.path.join(ROOT, "cfg", kind, name)) as f:
        return yaml.safe_load(f)


def _jax_resets(jt, n, seed):
    """n JAX-sampled reset states (q, qd, task) as numpy: the port's random
    streams are not JAX's, so resets are compared by feeding these across."""
    jm = jt.model
    task0 = jax.tree.map(lambda x: x[0], jt.default_task_state(jax.random.key(0)))
    keys = jax.random.split(jax.random.key(seed), n)
    q, qd, _, task = jax.jit(jax.vmap(lambda k: jt.reset_fn(k, jm.default_params(), task0)))(keys)
    return np.array(q), np.array(qd), jax.tree.map(np.array, task)


def _states(jenv, env, q, qd, task, net=None, progress=None):
    """The JAX and port EnvStates at the same (q, qd, task fields (numpy),
    net contact, progress)."""
    nb = env.task.model.nb
    n = q.shape[0]
    net = np.zeros((n, nb, 3)) if net is None else net
    progress = np.zeros(n, np.int64) if progress is None else progress
    jt = jenv.task
    zf = jnp.zeros(n)
    js = JEnvState(
        q=jnp.asarray(q, jnp.float32), qd=jnp.asarray(qd, jnp.float32),
        params=jt.model.default_params().batch(n), obs=jnp.zeros((n, jt.num_obs)),
        states=jnp.zeros((n, 0)), reward=zf, done=zf, timeout=zf,
        progress=jnp.asarray(progress, jnp.int32), net_contact=jnp.asarray(net, jnp.float32),
        net_torque=jnp.zeros((n, nb, 3)), key=jax.random.key(0), episode=jnp.zeros(n, jnp.int32),
        global_step=jnp.asarray(0, jnp.int32), last_rand=jnp.zeros(n, jnp.int32),
        episode_return=zf, last_episode_return=zf,
        task=dataclasses.replace(jt.default_task_state(jax.random.key(0)),
                                 **{k: jnp.asarray(v, jnp.float32) for k, v in task.items()}),
        metrics={})
    ts = env.init_fn(0)
    ts = dataclasses.replace(
        ts, q=torch.as_tensor(q, dtype=torch.float32), qd=torch.as_tensor(qd, dtype=torch.float32),
        net_contact=torch.as_tensor(net, dtype=torch.float32), progress=torch.as_tensor(progress),
        task=dataclasses.replace(ts.task, **{k: torch.as_tensor(v, dtype=torch.float32)
                                            for k, v in task.items()}))
    return js, ts


def _jax_pre_post(jt):
    """JAX pre_physics and post_physics under one jit (one compile)."""
    return jax.jit(lambda s, a: (jt.pre_physics(s, a), jt.post_physics(s, s.task)))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_franka_model_matches_jax():
    assert franka.make_franka_urdf() == jfranka.make_franka_urdf()
    _same_model(franka.load_franka(), jfranka.load_franka())
    _same_model(franka.load_franka(armature=0.02, disable_gravity=False),
                jfranka.load_franka(armature=0.02, disable_gravity=False))
    m = franka.load_franka()
    assert franka.franka_dof_ids(m) == jfranka.franka_dof_ids(jfranka.load_franka()) == list(range(9))
    for k in ("FRANKA_DEFAULT_STIFFNESS", "FRANKA_DEFAULT_DAMPING", "FRANKA_DEFAULT_DOF_POS",
              "FRANKA_CUBE_DOF_POS"):
        np.testing.assert_array_equal(getattr(franka, k), getattr(jfranka, k))
    assert cabinet.make_cabinet_urdf() == jcabinet.make_cabinet_urdf()
    assert cube._cube_urdf("cubeA", cube.CUBE_A) == jcube._cube_urdf("cubeA", jcube.CUBE_A)


@pytest.fixture(scope="module")
def cabinet_envs():
    cfg = {"env": _yaml("task", "FrankaCabinet.yaml")["env"]}
    with pytest.warns(UserWarning):                   # startPositionNoise: neither task has it
        jenv = tgx.make("FrankaCabinet", num_envs=B, cfg=cfg)
        env = tgt.make("FrankaCabinet", num_envs=B, cfg=cfg, device="cpu")
    return jenv, env


@pytest.fixture(scope="module", params=["osc", "joint_tor"])
def cube_envs(request):
    cfg = {"env": dict(_yaml("task", "FrankaCubeStack.yaml")["env"], controlType=request.param)}
    with pytest.warns(UserWarning):                   # distRewardScale: neither task has it
        jenv = tgx.make("FrankaCubeStack", num_envs=B, cfg=cfg)
        env = tgt.make("FrankaCubeStack", num_envs=B, cfg=cfg, device="cpu")
    return jenv, env


def _scene_checks(jenv, env, kinds):
    jm, tm = jenv.task.model, env.task.model
    _same_model(tm, jm)
    assert tm.root_base_pose == jm.root_base_pose and tm.roots_floating == jm.roots_floating
    assert collide.pairs(tm) == tuple(jcollide._pairs(jm))
    got = [k for _, _, k in collide.pairs(tm)]
    assert {k: got.count(k) for k in set(got)} == kinds
    fused.check_caps(tm)
    # the box instance; at the YAML's width (4096, 8192) on an H100's 132 SMs
    # one thread an env in blocks of 32
    width = _yaml("task", f"{type(env.task).__name__}.yaml")["env"]["numEnvs"]
    assert env.physics_step.pair_mode == 2
    assert env.physics_step.launch_geometry(width, sms=132) == ("local", 1, 32, 0)
    np.testing.assert_array_equal(env.task.fr_ids, jenv.task.fr_ids)
    assert (env.task.num_obs, env.task.num_actions) == (jenv.task.num_obs, jenv.task.num_actions)


def test_cabinet_scene_matches_jax(cabinet_envs):
    jenv, env = cabinet_envs
    _scene_checks(jenv, env, {"boxbox": 6, "capbox": 4})
    tm = env.task.model
    assert (tm.nb, tm.n_roots, tm.n_floating, collide.pair_candidate_count(tm)) == (15, 2, 0, 118)
    # the two fixed roots at their own poses
    assert tm.root_base_pose == (cabinet.FRANKA_POSE, cabinet.CABINET_POSE)
    assert (env.task.drawer_dof, env.task.drawer_body) == (jenv.task.drawer_dof, jenv.task.drawer_body)


def test_cube_stack_scene_matches_jax(cube_envs):
    jenv, env = cube_envs
    _scene_checks(jenv, env, {"boxbox": 5})
    tm = env.task.model
    assert (tm.nb, tm.n_roots, tm.n_floating, collide.pair_candidate_count(tm)) == (12, 3, 2, 85)
    assert env.task.control_type == jenv.task.control_type
    assert env.task.ground_height_fn() == jenv.task.ground_height_fn() == cube.TABLE_Z
    np.testing.assert_array_equal(np.asarray(tm._defaults["drive_mode"]),
                                  np.asarray(jenv.task.model._defaults["drive_mode"]))


def test_cabinet_pre_and_post_physics_match_jax(cabinet_envs):
    jenv, env = cabinet_envs
    jt, tt = jenv.task, env.task
    rng = np.random.default_rng(0)
    q, qd, jtask = _jax_resets(jt, B, 1)
    q[2:] = franka_cabinet_contact_q(tt, rng, 2)
    q[3, tt.drawer_dof] = 0.395                     # out past 0.39: done
    qd = rng.normal(size=qd.shape) * 0.3
    task = dict(dof_targets=jtask.dof_targets + rng.normal(size=(B, 9)) * 0.05,
                actions=rng.uniform(-1, 1, (B, 9)))
    js, ts = _states(jenv, env, q, qd, task)
    a = rng.uniform(-1, 1, (B, 9)).astype(np.float32)
    (jctrl, jw, jtask2), (jobs, jrew, jdone, _, jmet) = _jax_pre_post(jt)(js, jnp.asarray(a))
    tctrl, tw, ttask2 = tt.pre_physics(ts, torch.as_tensor(a))
    for g, w in zip(tctrl, jctrl):
        _close(g, w, atol=1e-6)
    _close(ttask2.dof_targets, jtask2.dof_targets, atol=1e-6)
    assert not tw.any()
    obs, rew, done, _, met = tt.post_physics(ts, ts.task)
    assert tuple(obs.shape) == (B, 23)
    _close(obs, jobs, atol=1e-5, rtol=1e-5)
    _close(rew, jrew, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done.tolist() == [0.0, 0.0, 0.0, 1.0]
    for k in ("drawer_pos", "grasp_dist"):
        _close(met[k], jmet[k], atol=1e-5, rtol=1e-5)


def test_cube_stack_pre_and_post_physics_match_jax(cube_envs):
    jenv, env = cube_envs
    jt, tt = jenv.task, env.task
    rng = np.random.default_rng(1)
    q, qd, _ = _jax_resets(jt, B, 2)
    q[2:] = franka_cube_contact_q(tt, rng, 2)
    # env 3: cube A stacked on B, the gripper away (reward 16, done)
    q[3, 0:7] = [0.0, 0.1, cube.TABLE_Z + cube.CUBE_B + cube.CUBE_A / 2, 1.0, 0.0, 0.0, 0.0]
    q[3, 7:14] = [0.0, 0.1, cube.TABLE_Z + cube.CUBE_B / 2, 1.0, 0.0, 0.0, 0.0]
    qd = rng.normal(size=qd.shape) * 0.3
    task = dict(actions=rng.uniform(-1, 1, (B, tt.num_actions)), finger_target=np.full(B, 0.04))
    js, ts = _states(jenv, env, q, qd, task)
    a = rng.uniform(-1, 1, (B, tt.num_actions)).astype(np.float32)
    a[0, -1], a[1, -1] = -0.5, 0.5                  # a closing and an opening gripper
    (jctrl, _, _), (jobs, jrew, jdone, _, jmet) = _jax_pre_post(jt)(js, jnp.asarray(a))
    tctrl, tw, ttask2 = tt.pre_physics(ts, torch.as_tensor(a))
    fr = tt.fr_ids
    if tt.control_type == "osc":
        _close(tctrl.effort, jctrl.effort, atol=2e-3, rtol=1e-3)
    else:
        _close(tctrl.effort, jctrl.effort, atol=1e-5)
    np.testing.assert_array_equal(tctrl.target_pos.numpy(), np.asarray(jctrl.target_pos))
    assert tctrl.target_pos[0, fr[7]] == 0.0 and tctrl.target_pos[1, fr[7]] == 0.04
    assert not tw.any() and float(tctrl.effort.abs().max()) > 1.0
    obs, rew, done, _, met = tt.post_physics(ts, ts.task)
    assert tuple(obs.shape) == (B, tt.num_obs)
    _close(obs, jobs, atol=1e-5, rtol=1e-5)
    _close(rew, jrew, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert float(rew[3]) == 16.0 and done.tolist() == [0.0, 0.0, 0.0, 1.0]
    for k in ("cubeA_height", "stack_rate", "grasp_dist"):
        _close(met[k], jmet[k], atol=1e-5, rtol=1e-5)


def test_resets_stay_in_the_jax_ranges(cabinet_envs, cube_envs):
    """The port's reset draws (its own streams) within the JAX draws' ranges."""
    from thormang_isaacgym_tpu_torch.engine.env import EnvRandom
    _, env = cabinet_envs
    t = env.task
    ep = torch.zeros(256, dtype=torch.int64)
    q, qd, _, task = t.reset_fn(EnvRandom(5, ep, 17), None, None)
    pos = q[:, t._fr]
    assert float((pos - t.default_dof).abs().max()) <= 0.125 + 1e-6 and not qd.any()
    assert bool(((pos >= t.fr_lower) & (pos <= t.fr_upper)).all())
    torch.testing.assert_close(task.dof_targets, pos)
    _, env = cube_envs
    t = env.task
    q, _, _, task = t.reset_fn(EnvRandom(5, ep, 17), None, None)
    d = torch.linalg.norm(q[:, 0:2] - q[:, 7:9], dim=-1)
    assert float(d.min()) >= 0.13 - 1e-6 and float(d.max()) <= 0.22 + 1e-6
    assert bool((q[:, 2] == cube.TABLE_Z + cube.CUBE_A / 2).all())
    assert bool((q[:, 14 + t.fr_ids[7:]] == 0.04).all())
    torch.testing.assert_close(torch.linalg.norm(q[:, 3:7], dim=-1), torch.ones(256))


@pytest.mark.parametrize("name", ["FrankaCabinet", "FrankaCubeStack"])
def test_make_runs_the_box_instance(name):
    cfg = _yaml("task", f"{name}.yaml")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tgt.make(name, num_envs=2, cfg=cfg)
    with pytest.warns(UserWarning):
        env = tgt.make(name, num_envs=2, cfg=cfg, device="cpu")
    sim = cfg["sim"]
    assert (env.task.sim_params.dt, env.task.sim_params.substeps) == (sim["dt"], sim["substeps"])
    assert env.physics_step.pair_mode == 2 and env.device.type == "cpu"
    if name == "FrankaCubeStack":
        assert env.task.control_type == cfg["env"]["controlType"] == "osc"
        assert env.physics_step.sim_params is env.task.sim_params
    state = env.reset(0)
    for _ in range(2):
        state = env.step(state, torch.rand(2, env.num_actions) * 2 - 1)
    assert bool(torch.isfinite(state.obs).all()) and bool(torch.isfinite(state.reward).all())
    assert tuple(state.obs.shape) == (2, env.num_obs)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["FrankaCabinet", "FrankaCubeStack"])
def test_op_path_matches_jax_op_path(name):
    """One control step of the port's op path against the JAX op path from
    the contact states, one substep of the YAML's substep length (the JAX
    op path's CPU compile of one substep takes 35-52 s). Tolerances of
    tests/test_fused.py: q atol=rtol 2e-3, qd 2e-2, net atol 1.0 / rtol
    5e-3."""
    from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
    from thormang_isaacgym_tpu_torch.ops.sim import Controls, build_plain_step_fn
    env = tgt.make(name, num_envs=B, device="cpu", cfg={"sim": _yaml("task", f"{name}.yaml")["sim"]})
    t, m = env.task, env.task.model
    jm = tgx.make(name, num_envs=B).task.model
    sp = dataclasses.replace(t.sim_params, dt=t.sim_params.dt / t.sim_params.substeps, substeps=1)
    gen = franka_cabinet_contact_q if name == "FrankaCabinet" else franka_cube_contact_q
    rng = np.random.default_rng(7)
    q = gen(t, rng, B).astype(np.float32)
    qd = (rng.normal(size=(B, m.nv)) * 0.05).astype(np.float32)
    tgt_pos = (q[:, 7 * m.n_floating:] + rng.normal(size=(B, m.nj)) * 0.01).astype(np.float32)
    eff = rng.uniform(-5, 5, (B, m.nj)).astype(np.float32)
    ground = t.ground_height_fn() if hasattr(t, "ground_height_fn") else None
    jstep = jax.jit(jax_build_step_fn(jm, sp, fused=False, ground_height_fn=ground))
    from thormang_isaacgym_tpu.ops.sim import Controls as JControls
    z = np.zeros_like(eff)
    jout = jstep(jm.default_params().batch(B), jnp.asarray(q), jnp.asarray(qd),
                 JControls(jnp.asarray(tgt_pos), jnp.asarray(z), jnp.asarray(eff)),
                 jnp.zeros((B, m.nb, 6)))
    tout = build_plain_step_fn(m, sp, ground or 0.0)(
        m.default_params().batch(B), torch.as_tensor(q), torch.as_tensor(qd),
        Controls(*(torch.as_tensor(x) for x in (tgt_pos, z, eff))), torch.zeros(B, m.nb, 6))
    for g, w, tol in zip(tout, jout, ((2e-3, 2e-3), (2e-2, 2e-2), (1.0, 5e-3))):
        _close(g, w, atol=tol[0], rtol=tol[1])
    assert float(tout[2].abs().max()) > 1.0           # the pads touch


@pytest.mark.slow
def test_arm_kernel_source_matches_jax_kernel_body():
    """The host-compiled kernel (tests/test_torch_fused.py) on the Franka arm
    alone against the JAX kernel body in interpret mode, as
    tests/test_fused.py's fixed-base check runs it: B = 2, q 0.3 x normal,
    zero controls, 3 free-running steps of 2 substeps, q atol=rtol 2e-3
    (the interpret compile takes ~3 min on the CPU)."""
    from thormang_isaacgym_tpu.ops.fused import build_fused_step_fn as jax_fused
    from thormang_isaacgym_tpu.ops.sim import SimParams as JSimParams, zero_controls as jzero
    from thormang_isaacgym_tpu_torch.ops.sim import SimParams, zero_controls
    from test_torch_fused import _host_call, build_host_kernel
    lib = build_host_kernel()
    jm, m = jfranka.load_franka(), franka.load_franka()
    jstep = jax.jit(jax_fused(jm, JSimParams(dt=1 / 60, substeps=2), interpret=True))
    step = fused.build_fused_step_fn(m, SimParams(dt=1 / 60, substeps=2))
    q = (0.3 * np.random.default_rng(3).normal(size=(2, m.nq))).astype(np.float32)
    jq, jqd = jnp.asarray(q), jnp.zeros((2, m.nv))
    tq, tqd = torch.as_tensor(q), torch.zeros(2, m.nv)
    params = m.default_params().batch(2)
    for _ in range(3):
        jq, jqd, _ = jstep(jm.default_params().batch(2), jq, jqd, jzero(jm, 2), jnp.zeros((2, m.nb, 6)))
        tq, tqd, _ = _host_call(lib, step, params, tq, tqd, zero_controls(m, 2), torch.zeros(2, m.nb, 6))
        _close(tq, jq, atol=2e-3, rtol=2e-3)
        _close(tqd, jqd, atol=2e-2, rtol=2e-2)
