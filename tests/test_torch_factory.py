"""Port parity for tasks/factory.py: the five Factory tasks (NutBolt Pick,
Place and Screw, Insertion, Gears) on the Franka, their controller
(ops/control.py on ops/inertia.py) and the table at TABLE_Z.

- The generated URDFs equal JAX's, character for character; every scene's
  topology, geoms (with their ``ground`` flags: ``_finish_scene`` clears the
  Franka's, of which only the finger pads exist, and keeps those), tendons
  (Screw's thread: coefficients 1 and pitch / (2 pi), bounds 0, stiffness
  2e4) and ``_defaults`` equal JAX's; the actor pairs, the caps and the
  controller spec.
- ``pre_physics`` (the torques) and ``post_physics`` of all five against
  JAX (jitted together) on identical states at B = 4: JAX-sampled resets
  and, for Pick (a floating nut) and Screw (no floating root), contact
  states (tests/test_torch_fused.py), seeded velocities, net contact forces
  and actions; also Pick with hybrid_force_motion (the finger forces into
  the closed force loop). Torques atol 2e-3 / rtol 1e-3 (the dls solve and
  the mass-matrix product in float32, on torques of up to the 87 N m
  effort limit); obs, reward and metrics atol 1e-5 / rtol 1e-5, done
  exactly.
- ``make`` of the five names: CUDA by default (raises without a card), the
  CPU with ``device="cpu"``, the YAML's sim block; a YAML ``ctrl`` block is
  not read (the class's controller, as the JAX ``make``); one finite
  control step of the plain version (Pick, Screw).
- The JAX checkpoint ``runs/factory_pick_r5b/nn/last.ckpt`` (the run that
  TRAIN_FactoryPick_r05.json records) loaded in the port gives the JAX
  policy's deterministic actions on the same observations (atol 1e-5).
- The op path against the JAX op path over one substep: on the whole Pick
  and Screw scenes marked ``slow`` (their JAX compiles take minutes); on
  the Screw scene cut to one finger pad and one nut wall, not."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.learn import ppo as jppo
from thormang_isaacgym_tpu.ops import collide as jcollide
from thormang_isaacgym_tpu.runtime.checkpoint import load_train_state as jax_load_train_state
from thormang_isaacgym_tpu.tasks import factory as jfactory
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
from thormang_isaacgym_tpu_torch.ops import collide, fused
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.runtime.checkpoint import load_train_state
from thormang_isaacgym_tpu_torch.tasks import factory

from test_torch_franka import _close, _jax_pre_post, _jax_resets, _states, _yaml
from test_torch_fused import factory_pick_contact_q, factory_screw_contact_q
from test_torch_hands import _same_model

B = 4
TASKS = ("FactoryTaskNutBoltPick", "FactoryTaskNutBoltPlace", "FactoryTaskNutBoltScrew",
         "FactoryTaskInsertion", "FactoryTaskGears")
PAIRS = {"FactoryTaskNutBoltScrew": 10}        # box-box pairs; 20 in the others
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs", "factory_pick_r5b", "nn", "last.ckpt")
HYBRID = {"ctrl_type": "hybrid_force_motion",
          "all": {"jacobian_type": "geometric", "gripper_prop_gains": [50, 50],
                  "gripper_deriv_gains": [2, 2]},
          "hybrid_force_motion": {"task_prop_gains": [40] * 6, "task_deriv_gains": [8] * 6,
                                  "wrench_prop_gains": [0.5] * 6,
                                  "force_ctrl_axes": [1, 1, 1, 0, 0, 0]}}


def test_generated_urdfs_match_jax():
    for fn in ("_nut_urdf", "_bolt_urdf", "_bolt_nut_urdf", "_plug_urdf", "_gear_base_urdf"):
        assert getattr(factory, fn)() == getattr(jfactory, fn)(), fn
    for args in (("socket", factory.SOCKET_HOLE, factory.SOCKET_OUTER, factory.SOCKET_H, 0.2),
                 ("gear_medium", factory.GEAR_HOLE, factory.GEAR_OUTER, factory.GEAR_H, 0.05)):
        assert factory._annulus_urdf(*args) == jfactory._annulus_urdf(*args)
    np.testing.assert_array_equal(factory.FRANKA_FACTORY_DOF, jfactory.FRANKA_FACTORY_DOF)
    assert factory._CTRL_YAML == jfactory._CTRL_YAML


@pytest.fixture(scope="module")
def envs():
    """The JAX and port tasks at B = 4, each made from its YAML."""
    out = {}
    for name in TASKS:
        cfg = {"env": _yaml("task", f"{name}.yaml")["env"]}
        out[name] = (tgx.make(name, num_envs=B, cfg=cfg),
                     tgt.make(name, num_envs=B, cfg=cfg, device="cpu"))
    return out


@pytest.mark.parametrize("name", TASKS)
def test_scene_matches_jax(envs, name):
    jenv, env = envs[name]
    jt, tt = jenv.task, env.task
    jm, tm = jt.model, tt.model
    _same_model(tm, jm)
    assert [g.ground for g in tm.geoms] == [g.ground for g in jm.geoms]
    assert all(g.ground for g in tm.geoms)       # the Franka's only geoms are the pads
    assert tm.root_base_pose == jm.root_base_pose and tm.roots_floating == jm.roots_floating
    assert collide.pairs(tm) == tuple(jcollide._pairs(jm))
    assert [k for _, _, k in collide.pairs(tm)] == ["boxbox"] * PAIRS.get(name, 20)
    assert collide.pair_candidate_count(tm) == 17 * PAIRS.get(name, 20)
    fused.check_caps(tm)
    # the box instance; at the YAML's 128 envs on an H100's 132 SMs the wide
    # layout in blocks of one warp, 32 lanes an env on 12 bodies, 16 on the
    # Screw task's 13
    assert env.physics_step.pair_mode == 2
    lanes = 16 if tm.nb == 13 else 32
    assert tm.nb in (12, 13) and (tm.nb == 13) == (name == "FactoryTaskNutBoltScrew")
    assert env.physics_step.launch_geometry(128, sms=132) == ("wide", lanes, 32, 0)
    assert tt.ground_height_fn() == jt.ground_height_fn() == factory.TABLE_Z
    assert tt.cfg_ctrl == jt.cfg_ctrl
    np.testing.assert_array_equal(tt.fr_ids, jt.fr_ids)
    np.testing.assert_array_equal(tt.keypoint_offsets.numpy(), np.asarray(jt.keypoint_offsets))
    np.testing.assert_array_equal(tt.effort_limit.numpy(), np.asarray(jt.effort_limit))
    assert (tt.num_obs, tt.num_actions, tt.max_episode_length) == \
        (jt.num_obs, jt.num_actions, jt.max_episode_length)
    if name == "FactoryTaskNutBoltScrew":
        (coef, lo, hi, _), = tm.tendons
        c = np.asarray(coef)
        assert (c[tt.travel_dof], c[tt.spin_dof], lo, hi) == (1.0, np.float32(0.002 / (2 * np.pi)), 0.0, 0.0)
        assert np.count_nonzero(c) == 2 and tm._defaults["tendon_stiffness"].tolist() == [2.0e4]
        # parity/convert.py carries JAX params across, the tendon rows too
        got = convert.model_params(jm.default_params())
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          getattr(tm.default_params(), f.name).numpy(), f.name)


CONTACT = {"FactoryTaskNutBoltPick": factory_pick_contact_q,
           "FactoryTaskNutBoltScrew": factory_screw_contact_q}


def _check_torques(jctrl, tctrl, tw):
    _close(tctrl.effort, jctrl.effort, atol=2e-3, rtol=1e-3)
    assert not tctrl.target_pos.any() and not tw.any() and float(tctrl.effort.abs().max()) > 1.0


@pytest.mark.parametrize("name", TASKS)
def test_pre_and_post_physics_match_jax(envs, name):
    """Torques, then obs / reward / done / metrics, on JAX-sampled resets
    and (Pick, Screw) contact states; the last env of Pick holds the nut
    lifted and of Screw the nut screwed down (success 1)."""
    jenv, env = envs[name]
    jt, tt = jenv.task, env.task
    rng = np.random.default_rng(3)
    q, _, _ = _jax_resets(jt, B, 4)
    if name in CONTACT:
        q[2:] = CONTACT[name](tt, rng, 2)
    if name == "FactoryTaskNutBoltPick":
        q[3, 2] = factory.TABLE_Z + 0.05
    if name == "FactoryTaskNutBoltScrew":
        q[3, tt.travel_dof] = -0.048
    qd = rng.normal(size=(B, tt.model.nv)) * 0.2
    net = rng.normal(size=(B, tt.model.nb, 3)) * 5.0
    js, ts = _states(jenv, env, q, qd, dict(actions=rng.uniform(-1, 1, (B, 12))), net=net)
    a = rng.uniform(-1, 1, (B, 12)).astype(np.float32)
    (jctrl, _, jtask), (jobs, jrew, jdone, _, jmet) = _jax_pre_post(jt)(js, jnp.asarray(a))
    tctrl, tw, ttask = tt.pre_physics(ts, torch.as_tensor(a))
    _check_torques(jctrl, tctrl, tw)
    np.testing.assert_array_equal(ttask.actions.numpy(), np.asarray(jtask.actions))
    obs, rew, done, _, met = tt.post_physics(ts, ts.task)
    assert tuple(obs.shape) == (B, tt.num_obs)
    _close(obs, jobs, atol=1e-5, rtol=1e-5)
    _close(rew, jrew, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert set(met) == set(jmet)
    for k in met:
        _close(met[k], jmet[k], atol=1e-5, rtol=1e-5)
    if name in CONTACT:
        assert met["success"].tolist() == [0.0, 0.0, 0.0, 1.0]


def test_hybrid_force_torques_match_jax():
    """The closed force loop reads the finger pads' net contact force."""
    jenv = tgx.make("FactoryTaskNutBoltPick", num_envs=B, ctrl_cfg=HYBRID)
    env = tgt.make("FactoryTaskNutBoltPick", num_envs=B, ctrl_cfg=HYBRID, device="cpu")
    jt, tt = jenv.task, env.task
    assert tt.cfg_ctrl == jt.cfg_ctrl and tt.cfg_ctrl["do_force_ctrl"]
    rng = np.random.default_rng(2)
    q, _, _ = _jax_resets(jt, B, 2)
    q[2:] = factory_pick_contact_q(tt, rng, 2)
    qd = rng.normal(size=(B, tt.model.nv)) * 0.2
    net = rng.normal(size=(B, tt.model.nb, 3)) * 5.0
    js, ts = _states(jenv, env, q, qd, dict(actions=np.zeros((B, 12))), net=net)
    a = rng.uniform(-1, 1, (B, 12)).astype(np.float32)
    jctrl, _, _ = jax.jit(jt.pre_physics)(js, jnp.asarray(a))
    _check_torques(jctrl, *tt.pre_physics(ts, torch.as_tensor(a))[:2])


@pytest.mark.parametrize("name", TASKS)
def test_make_reads_the_yaml_as_jax_does(name):
    cfg = _yaml("task", f"{name}.yaml")
    cfg["ctrl"] = {"ctrl_type": "task_space_impedance"}    # not read, as by the JAX make
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tgt.make(name, num_envs=2, cfg=cfg)
    env = tgt.make(name, num_envs=2, cfg=cfg, device="cpu")
    t = env.task
    assert (t.sim_params.dt, t.sim_params.substeps) == (cfg["sim"]["dt"], cfg["sim"]["substeps"])
    assert t.cfg_ctrl == tgx.make(name, num_envs=2, cfg=cfg).task.cfg_ctrl
    assert t.cfg_ctrl["ctrl_type"] == "joint_space_id" and env.device.type == "cpu"
    assert env.num_envs == 2 and tuple(env.reset(0).obs.shape) == (2, t.num_obs)
    if name in ("FactoryTaskNutBoltPick", "FactoryTaskNutBoltScrew"):
        state = env.step(env.reset(0), torch.rand(2, 12) * 2 - 1)
        assert bool(torch.isfinite(state.obs).all()) and bool(torch.isfinite(state.q).all())


def test_jax_checkpoint_gives_jax_actions(envs):
    """runs/factory_pick_r5b/nn/last.ckpt (a JAX FactoryTaskNutBoltPick run)
    in the port: the deterministic actions of the JAX policy, both in
    float32 (the YAML's mixed_precision makes the JAX MLP compute in
    bfloat16 on any device, the port's on CUDA only)."""
    jenv, env = envs["FactoryTaskNutBoltPick"]
    train = _yaml("train", "FactoryTaskNutBoltPickPPO.yaml")
    cfg = dataclasses.replace(PPOConfig.from_rlgames(train), mixed_precision=False)
    ppo = PPO(env, cfg, device="cpu")
    ts = load_train_state(CKPT, ppo)
    jp = jppo.PPO(jenv, dataclasses.replace(jppo.PPOConfig.from_rlgames(train), mixed_precision=False))
    jts = jax_load_train_state(CKPT, jp.init(jax.random.key(0)))
    obs = np.random.default_rng(5).normal(size=(B, 20)).astype(np.float32)
    got = ppo.act_deterministic(ts, torch.as_tensor(obs))
    want = jp.act_deterministic(jts, jnp.asarray(obs))
    _close(got, want, atol=1e-5)
    assert float(np.abs(np.asarray(want)).max()) > 0.05


# the Screw scene cut, in both packages alike, to the left finger pad and
# the nut's -x wall (geoms 0 and 6: one box-box pair of 17 candidates, not
# 10 pairs): the JAX op path unrolls its narrowphase pair by pair, and its
# CPU compile of a whole scene's substep takes 1-2 min, of the cut one ~10 s
SCREW_CUT = (0, 6)


@pytest.mark.parametrize("name,gen,geoms", [
    pytest.param("FactoryTaskNutBoltPick", factory_pick_contact_q, None, marks=pytest.mark.slow),
    pytest.param("FactoryTaskNutBoltScrew", factory_screw_contact_q, None, marks=pytest.mark.slow),
    ("FactoryTaskNutBoltScrew", factory_screw_contact_q, SCREW_CUT)])
def test_op_path_matches_jax_op_path(name, gen, geoms):
    """One substep (of the YAML's substep length) of the port's op path
    against the JAX op path from the contact states, with the Franka's
    efforts; the whole scenes at B = 4 (slow), and the Screw scene cut to
    SCREW_CUT at 2 envs, which keeps what the Franka slice brings to the
    physics: two fixed roots at their own poses, the table at TABLE_Z, the
    thread tendon (coefficients 1 and 3.2e-4) exactly on its bound 0 in env
    0 and 1 mm off it in env 1, whose pad presses into the wall. Tolerances
    of tests/test_fused.py: q atol=rtol 2e-3, qd 2e-2, net atol 1.0 / rtol
    5e-3."""
    from thormang_isaacgym_tpu.ops.sim import Controls as JControls
    from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
    from thormang_isaacgym_tpu_torch.ops.dynamics import tendon_sums
    from thormang_isaacgym_tpu_torch.ops.sim import Controls, build_plain_step_fn
    n = B if geoms is None else 2
    env = tgt.make(name, num_envs=n, device="cpu", cfg={"sim": _yaml("task", f"{name}.yaml")["sim"]})
    t, m = env.task, env.task.model
    jm = tgx.make(name, num_envs=n).task.model
    if geoms is not None:
        m = dataclasses.replace(m, geoms=tuple(m.geoms[i] for i in geoms))
        jm = dataclasses.replace(jm, geoms=tuple(jm.geoms[i] for i in geoms))
        assert [k for _, _, k in collide.pairs(m)] == ["boxbox"]
    sp = dataclasses.replace(t.sim_params, dt=t.sim_params.dt / t.sim_params.substeps, substeps=1)
    rng = np.random.default_rng(8)
    q = gen(t, rng, n).astype(np.float32)
    if geoms is not None:                        # the thread 1 mm off its bound in env 1
        q[1, t.travel_dof] -= 1e-3
    qd = (rng.normal(size=(n, m.nv)) * 0.05).astype(np.float32)
    eff = rng.uniform(-5, 5, (n, m.nj)).astype(np.float32)
    z = np.zeros_like(eff)
    jstep = jax.jit(jax_build_step_fn(jm, sp, fused=False, ground_height_fn=factory.TABLE_Z))
    jout = jstep(jm.default_params().batch(n), jnp.asarray(q), jnp.asarray(qd),
                 JControls(*(jnp.asarray(x) for x in (z, z, eff))), jnp.zeros((n, m.nb, 6)))
    tout = build_plain_step_fn(m, sp, factory.TABLE_Z)(
        m.default_params().batch(n), torch.as_tensor(q), torch.as_tensor(qd),
        Controls(*(torch.as_tensor(x) for x in (z, z, eff))), torch.zeros(n, m.nb, 6))
    for g, w, tol in zip(tout, jout, ((2e-3, 2e-3), (2e-2, 2e-2), (1.0, 5e-3))):
        _close(g, w, atol=tol[0], rtol=tol[1])
    assert float(tout[2].abs().max()) > 1.0
    if geoms is not None:
        L = tendon_sums(m.tendons, torch.as_tensor(q))[:, 0]
        pad = tout[2][:, t.lfinger_body].norm(dim=-1)
        assert float(L[0]) == 0.0 and float(L[1]) != 0.0
        assert float(pad[0]) == 0.0 and float(pad[1]) > 10.0


@pytest.mark.slow
def test_checkpoint_play_tracks_jax():
    """The deterministic play of runs/factory_pick_r5b/nn/last.ckpt over one
    episode (99 control steps) at 8 envs in the JAX package (its op path on
    the CPU; its jit of the env step takes ~2.5 min), with the port's policy
    and env step taken from the JAX package's state at every step: each
    step's q (atol = rtol 2e-3, tests/test_fused.py's) and each env's
    keypoint_dist (atol 1e-3) agree with JAX's (measured: within 7.0e-5 and
    6.4e-5; qd and the net contact, held substep by substep elsewhere,
    within 0.035 and 2.5 N). Free running from the same reset, the two
    plays part once a grip starts, as contact amplifies float32 rounding;
    the JAX play's env means and the largest deviations are printed."""
    train = _yaml("train", "FactoryTaskNutBoltPickPPO.yaml")
    n = 8
    jenv = tgx.make("FactoryTaskNutBoltPick", num_envs=n, seed=3)
    jp = jppo.PPO(jenv, jppo.PPOConfig.from_rlgames(train))
    jts = jax_load_train_state(CKPT, jp.init(jax.random.key(0)))
    env = tgt.make("FactoryTaskNutBoltPick", num_envs=n, seed=3, device="cpu",
                   cfg=_yaml("task", "FactoryTaskNutBoltPick.yaml"))
    ppo = PPO(env, PPOConfig.from_rlgames(train), device="cpu")
    ts = load_train_state(CKPT, ppo)
    js = jenv.reset(jax.random.key(3))
    st = env.reset(3)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype)

    @jax.jit
    def jstep(ts_, s):
        return jenv.step_fn(s, jp.act_deterministic(ts_, s.obs))

    kd_j, dev = [], dict(q=0.0, qd=0.0, kd=0.0, net=0.0)
    with torch.no_grad():
        for _ in range(jenv.task.max_episode_length - 1):
            st = dataclasses.replace(
                st, q=t(js.q), qd=t(js.qd), obs=t(js.obs), progress=t(js.progress, torch.int64),
                net_contact=t(js.net_contact), task=dataclasses.replace(st.task, actions=t(js.task.actions)))
            js = jstep(jts, js)
            st = env.step_fn(st, ppo.act_deterministic(ts, st.obs))
            _close(st.q, js.q, atol=2e-3, rtol=2e-3)
            _close(st.metrics["keypoint_dist"], js.metrics["keypoint_dist"], atol=1e-3)
            kd_j.append(float(js.metrics["keypoint_dist"].mean()))
            for k, g, w in (("q", st.q, js.q), ("qd", st.qd, js.qd), ("net", st.net_contact, js.net_contact),
                            ("kd", st.metrics["keypoint_dist"], js.metrics["keypoint_dist"])):
                dev[k] = max(dev[k], float(np.abs(g.numpy() - np.asarray(w)).max()))
    print({"jax": [round(x, 4) for x in kd_j], "max_abs_dev": dev})
    assert min(kd_j) < 0.3                       # the policy reaches the nut
