"""Port parity for models/op3.py and tasks/ma_op3.py (two OP3s and a table:
47 bodies, three floating roots, 75 actor pairs; the kernel's box
instance).

- The URDF strings equal JAX's character for character; the OP3, the table
  and the composed scene equal JAX's (``_same_model``): names, tree, axes,
  geoms and every default (the drives: kp 1000, kd 200, 4.1 N m, armature
  2e-4).
- The scene's counts: 75 pairs (36 sphere, 39 box-box) in JAX's order, 699
  pair candidates, 92 ground candidates, 11 pair bodies; ``check_caps``
  passes and the scene takes the box instance.
- ``make`` with cfg/task/MA_OP3.yaml: 2 agents, 4 substeps of 0.0166 s (the
  JAX class keeps its own 3: a deliberate divergence, ROADMAP C), the
  reward scales x dt and the episode length equal JAX's; the same keys
  warned about (none).
- Reset: q, qd and the potentials of JAX-sampled resets (the y command, the
  only draw, fed across in the states below); the port's own commands in
  [0, 10).
- ``pre_physics`` on identical (B, 2, 22) actions: the targets atol 1e-6.
- ``post_physics`` on identical states, obs, reward and task state at rtol
  = atol = 1e-5 (the potentials are about 600), against the JAX function
  run op by op (``jax.disable_jit``): jitted, XLA rounds a potential
  -|d| / dt one float32 spacing (6e-5) away from the op-by-op value, which
  the progress reward, 5 x the difference of two potentials, turns into
  4e-4 (measured on these states; the port agrees with the op-by-op JAX
  reward exactly). The states hold feet forces on both sides
  of 1.1 N and 0.1 N (and above 450 N), gripper x-forces on both sides of
  0.1 N, air times above zero, command norms on both sides of 0.1, progress
  at 1 and above, a tipped table and a dropped one; done exactly.
- The op path: one OP3 alone on the ground, its heels pressed 1 mm in, one
  control step (4 substeps) of the port's plain step against the JAX op
  path ``build_step_fn(fused=False)`` at B = 4, at the tolerances of
  tests/test_torch_trifinger.py's ``_op_path_step``.
- The table's pairs: JAX's narrowphase on the whole scene takes ~50 s to
  jit on the CPU (and ~27 s unjitted), so the candidates (depth, point,
  normal) and the pair forces are held against JAX's ``collide`` on the
  fewest pairs that still hold a box-box pair (a foot on a table leg) and a
  sphere-box pair (a gripper on the table top's edge) in contact: the
  scene cut to a0's left foot and right gripper and the table's top and
  the leg beside that foot (4 pairs).
- ``slow`` (the JAX op path's jit takes minutes on the CPU): one OP3 and
  the table (25 pairs), and the whole scene, each one control step against
  the JAX op path.
"""
import dataclasses
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.models import op3 as jop3
from thormang_isaacgym_tpu.models.scene import compose as jcompose
from thormang_isaacgym_tpu.models.urdf import load_urdf as jload_urdf
from thormang_isaacgym_tpu.ops import collide as jcollide
from thormang_isaacgym_tpu.ops.kinematics import forward_kinematics as jax_fk
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.models import op3
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.models.urdf import load_urdf
from thormang_isaacgym_tpu_torch.ops import collide, fused
from thormang_isaacgym_tpu_torch.ops.kinematics import BodyFrames, forward_kinematics
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom
from thormang_isaacgym_tpu_torch.tasks.ma_op3 import MAOP3TaskState

from test_torch_fused import MA_OP3_HEEL_Z, ma_op3_contact_q
from test_torch_hands import _same_model

B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)


def _yaml(kind, name):
    with open(os.path.join(ROOT, "cfg", kind, f"{name}.yaml")) as f:
        return yaml.safe_load(f)


def _warned(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        env = fn()
    return env, sorted(str(w.message) for w in rec if "matches no attribute" in str(w.message))


@pytest.fixture(scope="module")
def envs():
    cfg = _yaml("task", "MA_OP3")
    jenv, jkeys = _warned(lambda: tgx.make("MA_OP3", num_envs=B, seed=0, cfg=cfg))
    env, keys = _warned(lambda: tgt.make("MA_OP3", num_envs=B, seed=0, cfg=cfg, device="cpu"))
    assert keys == jkeys == []
    return jenv, env


def test_urdfs_and_models_match_jax():
    assert op3.make_op3_urdf() == jop3.make_op3_urdf()
    assert op3.make_table_urdf() == jop3.make_table_urdf()
    assert op3.OP3_DOF_NAMES == jop3.OP3_DOF_NAMES
    assert op3.DEFAULT_JOINT_ANGLES == jop3.DEFAULT_JOINT_ANGLES
    assert (op3.BASE_Z, op3.TABLE_Z) == (jop3.BASE_Z, jop3.TABLE_Z)
    m = op3.load_op3()
    _same_model(m, jop3.load_op3())
    _same_model(op3.load_table(), jop3.load_table())
    np.testing.assert_array_equal(op3.op3_default_dof(m, ""), jop3.op3_default_dof(jop3.load_op3(), ""))
    d = m._defaults
    assert (d["drive_stiffness"] == 1000.0).all() and (d["drive_damping"] == 200.0).all()
    assert (d["drive_effort_limit"] == np.float32(4.1)).all() and m.nj == 22


def test_scene_counts_and_caps(envs):
    jenv, env = envs
    m, jm = env.task.model, jenv.task.model
    _same_model(m, jm)
    pairs = collide.pairs(m)
    assert pairs == tuple(jcollide._pairs(jm))
    kinds = [k for _, _, k in pairs]
    assert (len(pairs), kinds.count("sphere"), kinds.count("boxbox")) == (75, 36, 39)
    assert sum(collide.CANDIDATES_PER_KIND[k] for k in kinds) == 699
    assert len(fused.contact.candidates(m)["geom"]) == 92
    assert len(fused.pair_bodies(m)) == 11
    assert (m.nb, m.nj, m.nq, m.nv, m.n_floating) == (47, 44, 65, 62, 3)
    fused.check_caps(m)
    step = env.physics_step
    assert (step.pair_mode, step.layout, step.block) == (2, "local", fused.PAIR_BLOCK)


def test_make_with_its_yaml(envs):
    jenv, env = envs
    task, jtask = env.task, jenv.task
    assert env.task.num_agents == jtask.num_agents == 2
    assert (env.num_obs, env.num_actions) == (jenv.num_obs, jenv.num_actions) == (88, 22)
    assert (task.sim_params.dt, task.sim_params.substeps) == (0.0166, 4)
    assert (jtask.sim_params.dt, jtask.sim_params.substeps) == (0.0166, 3)   # the JAX class's own
    assert task.max_episode_length == jtask.max_episode_length == 3012
    assert task.rew.keys() == jtask.rew.keys()
    for k, v in jtask.rew.items():
        assert task.rew[k] == pytest.approx(v, rel=1e-12), k
    np.testing.assert_array_equal(task.agent_dofs, np.asarray(jtask.agent_dofs))
    np.testing.assert_array_equal(task.default_dof.numpy(), np.asarray(jtask.default_dof))
    np.testing.assert_array_equal(task.feet, jtask.feet)
    np.testing.assert_array_equal(task.grippers, jtask.grippers)
    # tree order, not the reference's DOF order
    assert task.model.joint_names[:3] == ("a0/head_pan", "a0/l_hip_yaw", "a0/l_sho_pitch")


def _jax_resets(jt, seed):
    reset = jax.jit(jt.reset_fn)
    task0 = jax.tree.map(lambda x: x[0], jt.default_task_state(jax.random.key(0)))
    out = [reset(k, jt.model.default_params(), task0)
           for k in jax.random.split(jax.random.key(seed), B)]
    return (np.stack([np.asarray(r[0]) for r in out]), np.stack([np.asarray(r[1]) for r in out]),
            jax.tree.map(lambda *x: np.stack(x), *[r[3] for r in out]))


def test_reset_matches_jax(envs):
    jenv, env = envs
    q, qd, jtask = _jax_resets(jenv.task, 1)
    task = env.task
    tq, tqd, _, tstate = task.reset_fn(EnvRandom(3, torch.zeros(B, dtype=torch.int64), 0),
                                       task.model.default_params("cpu").batch(B),
                                       task.default_task_state())
    np.testing.assert_allclose(tq.numpy(), q, atol=1e-7)
    np.testing.assert_array_equal(tqd.numpy(), qd)
    for f in ("potentials", "prev_potentials", "table_potentials", "prev_table_potentials"):
        np.testing.assert_allclose(getattr(tstate, f).numpy(), getattr(jtask, f), **TOL)
    for f in ("actions", "last_actions", "prev_torques", "feet_air_time", "last_contacts"):
        assert not getattr(tstate, f).any() and not np.asarray(getattr(jtask, f)).any()
    c = tstate.commands
    assert bool(((c[:, 1] >= 0.0) & (c[:, 1] < 10.0)).all()) and not c[:, [0, 2]].any()
    assert float(c[:, 1].std()) > 0.0                         # a draw per env
    np.testing.assert_array_equal(np.asarray(jtask.commands)[:, [0, 2]], 0.0)


def _task_state(jtask):
    return MAOP3TaskState(**{f.name: torch.as_tensor(np.asarray(getattr(jtask, f.name), np.float32))
                             for f in dataclasses.fields(MAOP3TaskState)})


def _states(jenv, env):
    """A JAX and a port EnvState on the same state: the contact states of
    tests/test_torch_fused.py (envs 0-1), a JAX reset (env 2) with both
    agents tilted, env 3's table tipped by 0.6 rad and env 1's dropped to
    0.2 m; progress 1, 2, 1, 7; feet z-forces of 0.05, 0.5, 1.5 and 500 N (and a 460 N sideways
    push), gripper x-forces of 0.05 and 0.2 N, air times in [0, 0.6) with
    zeros, commands of norm 0.05 and 5, random actions, last actions,
    torques and last contacts."""
    jt, tt = jenv.task, env.task
    rng = np.random.default_rng(2)
    q, qd, jtask = _jax_resets(jt, 4)
    q[:2] = ma_op3_contact_q(tt, rng, 2)
    q[3, 17:21] = [np.cos(0.3), np.sin(0.3), 0.0, 0.0]          # the table tipped
    q[1, 16] = 0.2                                              # the table dropped
    # env 2's agents tilted: a0 by 0.6 rad (fallen, but at progress 1), a1
    # (turned by pi) by 0.2 rad; the gravity projection's rotate and its
    # inverse differ only off upright
    axis = np.array([0.6, 0.8, 0.0])
    q[2, 3:7] = [np.cos(0.3), *(np.sin(0.3) * axis)]
    c, sn = np.cos(0.1), np.sin(0.1)
    q[2, 10:14] = [-sn * axis[2], sn * axis[1], -sn * axis[0], c]   # (0, 0, 0, 1) x tilt
    qd = (rng.normal(size=qd.shape) * 0.3).astype(np.float32)
    net = np.zeros((B, tt.model.nb, 3), np.float32)
    feet = tt.feet.reshape(-1)
    net[:, feet, 2] = rng.choice([0.05, 0.5, 1.5, 500.0], (B, 4))
    net[:, feet, :2] = rng.normal(size=(B, 4, 2))
    net[0, feet[0], 0] = 460.0
    net[:, tt.grippers.reshape(-1), 0] = rng.choice([0.05, 0.2], (B, 4))
    net[:, tt.grippers.reshape(-1), 1:] = rng.normal(size=(B, 4, 2))
    cy = np.array([0.05, 5.0, 0.05, 5.0], np.float32)
    jtask = dataclasses.replace(
        jtask,
        actions=rng.uniform(-1, 1, (B, 2, 22)).astype(np.float32),
        last_actions=rng.uniform(-1, 1, (B, 2, 22)).astype(np.float32),
        prev_torques=rng.uniform(-4.1, 4.1, (B, 2, 22)).astype(np.float32),
        feet_air_time=(rng.uniform(0, 0.6, (B, 2, 2)) * (rng.uniform(size=(B, 2, 2)) > 0.3)
                       ).astype(np.float32),
        last_contacts=(rng.uniform(size=(B, 2, 2)) > 0.5).astype(np.float32),
        potentials=(np.asarray(jtask.potentials) + rng.normal(size=(B, 2))).astype(np.float32),
        table_potentials=(np.asarray(jtask.table_potentials) + rng.normal(size=B)).astype(np.float32),
        commands=np.stack([np.zeros(B), cy, np.zeros(B)], 1).astype(np.float32))
    progress = np.array([1, 2, 1, 7])
    js = jax.jit(jenv.init_fn)(jax.random.key(0))
    js = dataclasses.replace(js, q=jnp.asarray(q, jnp.float32), qd=jnp.asarray(qd),
                             net_contact=jnp.asarray(net),
                             progress=jnp.asarray(progress, js.progress.dtype),
                             task=jax.tree.map(jnp.asarray, jtask))
    ts = dataclasses.replace(env.init_fn(0), q=torch.as_tensor(q, dtype=torch.float32),
                             qd=torch.as_tensor(qd), net_contact=torch.as_tensor(net),
                             progress=torch.as_tensor(progress), task=_task_state(jtask))
    return js, ts


def test_pre_physics_matches_jax(envs):
    jenv, env = envs
    js, ts = _states(jenv, env)
    a = np.random.default_rng(3).uniform(-1, 1, (B, 2, 22)).astype(np.float32)
    jctrl, jw, jtask = jenv.task.pre_physics(js, jnp.asarray(a))
    ctrl, w, task = env.task.pre_physics(ts, torch.as_tensor(a))
    np.testing.assert_allclose(ctrl.target_pos.numpy(), np.asarray(jctrl.target_pos), atol=1e-6)
    assert not ctrl.target_vel.any() and not ctrl.effort.any() and not w.any()
    np.testing.assert_array_equal(task.actions.numpy(), a)
    np.testing.assert_array_equal(task.last_actions.numpy(), ts.task.actions.numpy())
    # every joint of both agents targeted, in the model's joint order
    assert tuple(ctrl.target_pos.shape) == (B, 44) and bool((ctrl.target_pos != 0).all())


def test_post_physics_matches_jax(envs):
    jenv, env = envs
    jt, tt = jenv.task, env.task
    js, ts = _states(jenv, env)
    with jax.disable_jit():
        jobs, jrew, jdone, jtask, jm = jt.post_physics(js, js.task)
    obs, rew, done, task, m = tt.post_physics(ts, ts.task)
    assert tuple(obs.shape) == (B, 2, 88) and tuple(rew.shape) == (B, 2)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), **TOL)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    for f in dataclasses.fields(MAOP3TaskState):
        np.testing.assert_allclose(getattr(task, f.name).numpy(), np.asarray(getattr(jtask, f.name)),
                                   err_msg=f.name, **TOL)
    for k in ("table_height", "grip_hold"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), err_msg=k, **TOL)
    # the states' branches: a reward clipped at 0 and one above; done only
    # after the first step (env 2 is at progress 1, env 3's table tipped,
    # env 1's dropped); air time reset on contact and grown elsewhere
    r = rew.numpy()
    assert (r == 0.0).any() and (r > 0.0).any()
    assert done.numpy().tolist() == [0.0, 1.0, 0.0, 1.0]
    air, prev = task.feet_air_time.numpy(), ts.task.feet_air_time.numpy()
    assert (air == 0.0).any() and (np.abs(air - prev - tt.dt) < 1e-6).any()
    assert 0.0 < float(m["grip_hold"].max())


def _op_path_step(jm, tm, sp, q, qd, target, steps):
    """`steps` control steps of the port's plain step against the JAX op
    path from (q, qd), position drives toward `target`, no wrench: q
    atol=rtol 2e-3, qd 2e-2, net atol 1.0 / rtol 5e-3 (tests/test_fused.py's,
    as tests/test_torch_trifinger.py's ``_op_path_step``). Returns the
    port's last net contact force."""
    from thormang_isaacgym_tpu.ops.sim import Controls as JControls
    from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
    from thormang_isaacgym_tpu_torch.ops.sim import Controls, build_plain_step_fn
    n = q.shape[0]
    jstep = jax.jit(jax_build_step_fn(jm, sp, fused=False, need_torque=True))
    step = build_plain_step_fn(tm, sp)
    jparams, tparams = jm.default_params().batch(n), tm.default_params().batch(n)
    z = np.zeros_like(target)
    jctrl = JControls(jnp.asarray(target), jnp.asarray(z), jnp.asarray(z))
    tctrl = Controls(*(torch.as_tensor(x) for x in (target, z, z)))
    jq, jqd, tq, tqd = jnp.asarray(q), jnp.asarray(qd), torch.as_tensor(q), torch.as_tensor(qd)
    for _ in range(steps):
        jq, jqd, jnet = jstep(jparams, jq, jqd, jctrl, jnp.zeros((n, jm.nb, 6)))
        tq, tqd, tnet = step(tparams, tq, tqd, tctrl, torch.zeros(n, tm.nb, 6))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(tnet.numpy(), np.asarray(jnet), atol=1.0, rtol=5e-3)
    return tnet


def _targets(model, q, rng):
    """Position targets 0.01 rad (sd) from the joints: kp 1000 against the
    4.1 N m limit puts many drives at the clamp and some inside it."""
    return (q[:, model.root_nq:] + rng.normal(size=(q.shape[0], model.nj)) * 0.01).astype(np.float32)


def test_op_path_matches_jax_on_one_op3(envs):
    """One OP3 alone on the ground at the crouch, its heels 0.5-1.5 mm into
    it, one control step of MA_OP3.yaml's (4 substeps of 0.0166 / 4 s)."""
    _, env = envs
    tm, jm = op3.load_op3(), jop3.load_op3()
    rng = np.random.default_rng(5)
    q = np.zeros((B, tm.nq), np.float32)
    q[:, 0:2] = rng.uniform(-0.01, 0.01, (B, 2))
    q[:, 2] = op3.BASE_Z - MA_OP3_HEEL_Z - 0.001 + rng.uniform(-5e-4, 5e-4, B)
    q[:, 3] = 1.0
    q[:, 7:] = op3.op3_default_dof(tm) + rng.normal(size=(B, tm.nj)) * 0.002
    qd = (rng.normal(size=(B, tm.nv)) * 0.05).astype(np.float32)
    f = forward_kinematics(tm, torch.as_tensor(q), torch.as_tensor(qd))
    p, _ = fused.contact.candidate_points(tm, f)
    r = torch.as_tensor(fused.contact.candidates(tm)["r"])
    assert bool(((p[..., 2] - r) < 0).any(-1).all())            # the heels in the ground
    tnet = _op_path_step(jm, tm, env.task.sim_params, q, qd, _targets(tm, q, rng), 1)
    assert float(tnet[..., 2].max()) > 1.0


def _cut(urdf, keep):
    """`urdf` without the collision geoms not named in `keep`."""
    return re.sub(r'<collision name="(\w+)">.*?</collision>',
                  lambda m: m.group(0) if m.group(1) in keep else "", urdf)


def _cut_scene(load, comp):
    """a0 with its left foot and right gripper only, and the table with its
    top and the leg beside that foot (leg2, at x -0.24, y +0.14): 4 pairs."""
    robot = load(_cut(op3.make_op3_urdf(), ("l_foot", "r_gripper")), armature=2e-4, name="op3")
    table = load(_cut(op3.make_table_urdf(), ("top", "leg2")), name="table")
    return comp([(robot, (-0.31, 0.0, op3.BASE_Z, 1.0, 0.0, 0.0, 0.0), "a0/"),
                 (table, (0.0, 0.0, op3.TABLE_Z, 1.0, 0.0, 0.0, 0.0), "table/")], name="ma_op3_cut")


def test_table_pairs_match_jax_on_the_cut_scene(envs):
    """The cut scene at the whole scene's contact states (ma_op3_contact_q):
    in envs 1 and 4 the table moved so that the left foot presses into leg2
    (box-box corners) and the right gripper into the top's underside; in the
    others the gripper on the top's edge (sphere-box). Candidates at atol
    1e-5; the pair forces, torques and added inertias at atol 1e-3 / rtol
    1e-4 (tests/test_torch_collide.py's)."""
    _, env = envs
    tm, jm = _cut_scene(load_urdf, compose), _cut_scene(jload_urdf, jcompose)
    _same_model(tm, jm)
    pairs = collide.pairs(tm)
    assert pairs == tuple(jcollide._pairs(jm))
    assert sorted(k for _, _, k in pairs) == ["boxbox", "boxbox", "sphere", "sphere"]
    full = env.task.model
    n = 6
    fq = ma_op3_contact_q(env.task, np.random.default_rng(8), n)
    cols = [full.root_nq + full.dof_id(name) for name in tm.joint_names]
    q = np.concatenate([fq[:, 0:7], fq[:, 14:21], fq[:, cols]], 1)
    qd = (np.random.default_rng(9).normal(size=(n, tm.nv)) * 0.1).astype(np.float32)
    jf = jax.jit(jax.vmap(lambda a, b: jax_fk(jm, a, b)))(jnp.asarray(q), jnp.asarray(qd))
    tf = BodyFrames(*(torch.as_tensor(np.array(x)) for x in jf))
    jc = jax.jit(jax.vmap(lambda f: [c[4:] for c in jcollide._candidates(jm, f)]))(jf)
    tc = collide.candidates(tm, tf)
    for (_, _, _, _, nrm, depth, cp), (jn, jd, jcp) in zip(tc, jc, strict=True):
        for got, want in ((nrm, jn), (depth, jd), (cp, jcp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    depth = torch.stack([c[5] for c in tc], -1)
    kinds = [k for _, _, k in pairs for _ in range(collide.CANDIDATES_PER_KIND[k])]
    hit = {k: (depth[:, [i for i, kk in enumerate(kinds) if kk == k]] > 0).any(-1) for k in set(kinds)}
    assert hit["boxbox"].tolist() == [False, True, False, False, True, False]
    assert bool(hit["sphere"].all())
    sp = env.task.sim_params
    kw = dict(stiffness=sp.contact_stiffness, damping=sp.contact_damping,
              friction_vel=sp.friction_vel, dt=sp.dt / sp.substeps,
              max_depenetration_velocity=sp.max_depenetration_velocity)
    want = jax.jit(jax.vmap(lambda p, f: jcollide.pairwise_contact_forces(jm, p, f, **kw)))(
        jm.default_params().batch(n), jf)
    got = collide.pairwise_contact_forces(tm, tm.default_params().batch(n), tf, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4)
    assert float(got[1].abs().max()) > 1.0


def _contact_step(jmodel, tmodel, task, q, steps=1):
    rng = np.random.default_rng(10)
    qd = (rng.normal(size=(q.shape[0], tmodel.nv)) * 0.05).astype(np.float32)
    _op_path_step(jmodel, tmodel, task.sim_params, q, qd, _targets(tmodel, q, rng), steps)


@pytest.mark.slow
def test_op_path_matches_jax_on_one_op3_and_the_table(envs):
    """(slow: the JAX op path on 25 pairs takes ~2 min to jit on the CPU.)
    a0 and the table at the whole scene's contact states, one control step."""
    _, env = envs
    def scene(load_op3, load_table, comp):
        return comp([(load_op3(), (-0.31, 0.0, op3.BASE_Z, 1.0, 0.0, 0.0, 0.0), "a0/"),
                     (load_table(), (0.0, 0.0, op3.TABLE_Z, 1.0, 0.0, 0.0, 0.0), "table/")],
                    name="ma_op3_a0")
    tm, jm = scene(op3.load_op3, op3.load_table, compose), scene(jop3.load_op3, jop3.load_table, jcompose)
    _same_model(tm, jm)
    full = env.task.model
    fq = ma_op3_contact_q(env.task, np.random.default_rng(11), 2)
    cols = [full.root_nq + full.dof_id(name) for name in tm.joint_names]
    _contact_step(jm, tm, env.task, np.concatenate([fq[:, 0:7], fq[:, 14:21], fq[:, cols]], 1))


@pytest.mark.slow
def test_op_path_matches_jax_whole_scene(envs):
    """(slow: the JAX op path on the whole scene takes minutes to jit on the
    CPU.) One control step from the contact states."""
    jenv, env = envs
    _contact_step(jenv.task.model, env.task.model, env.task,
                  ma_op3_contact_q(env.task, np.random.default_rng(12), 2))
