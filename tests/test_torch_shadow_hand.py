"""Port parity for ShadowHand (the slice of kernel block B4b: the hand's four
fixed tendons, each holding q_J0 - q_J1 in [-0.05, 0.05]).

- ``make("ShadowHand", cfg=ShadowHand.yaml, device="cpu")``: obs 211, the
  YAML's dt 0.01667 s of 2 substeps, controlFrequencyInv 1, 18 actor pairs
  (3 box-box, 15 capsule-box) with 111 candidates on 18 pair bodies, 4
  tendons, the kernel's box instance with the fingertips' torque rows; the
  scene, its pairs and its tendon table equal to JAX's, exactly.
- The physics (the op path, the plain version of the kernel) against the JAX
  op path ``build_step_fn(fused=False)`` at B = 4 over 3 control steps (dt
  1/60 s, 2 substeps), from JAX-sampled reset states and from states with the
  cube pressed into the palm and fingers and the tendons on either side of
  their bounds, targets from seeded actions through both tasks'
  ``pre_physics`` (equal at atol 1e-6): q atol=rtol 2e-3, qd 2e-2, net atol
  1.0 / rtol 5e-3 (tests/test_fused.py's tolerances).
- ``post_physics`` against JAX on identical states with tendons in
  violation (below and above their bounds) and inside: the 211-dim obs atol
  1e-4 / rtol 1e-5, of which the DOF-force estimate (the drive torque plus
  the tendon springs' torque) atol 1e-5 / rtol 1e-6, reward atol 1e-4 / rtol
  1e-5, done, successes and the consecutive-success EMA at 1e-6.
- The privileged states of ``asymmetric_observations`` (``compute_states``,
  211) against JAX on identical states, the fingertips' net contact force
  and torque rows non-zero: atol 1e-4 / rtol 1e-5 (the obs's tolerance).
- One ShadowHandPPO iteration at 8 envs on the CPU is finite, from weights
  that ``parity/convert.py`` carried across from a JAX PPO init (forward
  pass atol=rtol 1e-5)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.learn import ppo as jppo
from thormang_isaacgym_tpu.ops import collide as jcollide
from thormang_isaacgym_tpu.ops import fused as jax_fused
from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.learn import ppo as tppo
from thormang_isaacgym_tpu_torch.ops import collide, fused
from thormang_isaacgym_tpu_torch.ops.sim import build_plain_step_fn
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.tasks import shadow_hand as tshadow

from test_torch_fused import shadow_contact_q as contact_states
from test_torch_fused import tendon_length
from test_torch_hands import _same_model

B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _yaml(kind, name):
    with open(os.path.join(ROOT, "cfg", kind, name)) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def envs():
    """The JAX and port ShadowHand envs at B = 4 with ShadowHand.yaml's env
    block; the port keeps the task's own sim block (dt 1/60 s), as JAX does."""
    env_blk = {"env": _yaml("task", "ShadowHand.yaml")["env"]}
    with pytest.warns(UserWarning):                 # the reference keys neither task reads
        jenv = tgx.make("ShadowHand", num_envs=B, seed=0, cfg=env_blk)
        env = tgt.make("ShadowHand", num_envs=B, seed=0, cfg=env_blk, device="cpu")
    return jenv, env


def test_make_shadow_hand_with_its_yaml(envs):
    jenv, _ = envs
    with pytest.warns(UserWarning):
        env = tgt.make("ShadowHand", num_envs=8, seed=0, cfg=_yaml("task", "ShadowHand.yaml"),
                       device="cpu")
    task, step = env.task, env.physics_step
    m, jm = task.model, jenv.task.model
    _same_model(m, jm)
    assert collide.pairs(m) == tuple(jcollide._pairs(jm))
    kinds = [k for _, _, k in collide.pairs(m)]
    assert (kinds.count("boxbox"), kinds.count("capbox"), len(kinds)) == (3, 15, 18)
    assert collide.pair_candidate_count(m) == 111
    assert len(fused.pair_bodies(m)) == 18 <= fused.MAX_PAIR_BODIES
    assert (m.nb, m.nj, len(m.tendons)) == (26, 24, 4)
    assert (task.num_obs, task.num_actions, task.obs_type) == (211, 20, "full_state")
    assert abs(task.sim_params.dt - 1 / 60) < 1e-5 and task.dt == task.sim_params.dt
    assert (task.sim_params.substeps, task.control_freq_inv, task.max_episode_length) == (2, 1, 600)
    assert step.pair_mode == 2 and step.tq_bodies == tuple(int(b) for b in task.fingertip_ids)
    jrows = jax_fused._make_rows(jm)
    assert {f.name: getattr(jrows, f.name) for f in dataclasses.fields(jrows)} == \
        {k: v for k, v in step.rows.items()}
    assert step._tables[0][42] == 4 and step._tables[0][41] == 18
    np.testing.assert_array_equal(task.act_ids, jenv.task.act_ids)
    np.testing.assert_array_equal(task.fingertip_ids, jenv.task.fingertip_ids)
    s = env.step(env.reset(0), torch.zeros(8, 20))
    assert tuple(s.obs.shape) == (8, 211) and bool(torch.isfinite(s.obs).all())
    assert step.launches == 0                        # CPU tensors run the plain version


def test_op_path_matches_jax(envs):
    jenv, env = envs
    jt, tt = jenv.task, env.task
    jm, tm = jt.model, tt.model
    assert (tt.sim_params.dt, tt.sim_params.substeps) == (jt.sim_params.dt, jt.sim_params.substeps)
    keys = jax.random.split(jax.random.key(3), B)
    task0 = jax.tree.map(lambda x: x[0], jt.default_task_state(jax.random.key(0)))
    resets = [jt.reset_fn(k, jm.default_params(), task0) for k in keys]
    q = np.stack([np.asarray(r[0]) for r in resets]).astype(np.float32)
    qd = np.stack([np.asarray(r[1]) for r in resets]).astype(np.float32)
    rng = np.random.default_rng(4)
    q[2:] = contact_states(tm, rng, 2)             # the cube pressed into the hand
    jstep = jax.jit(jax_build_step_fn(jm, jt.sim_params, fused=False))
    step = build_plain_step_fn(tm, tt.sim_params)
    jparams, tparams = jm.default_params().batch(B), tm.default_params().batch(B)
    # the same task state: the previous targets (those of the tendon-coupled
    # J0s, which no action sets, too) are the joint positions, as after a reset
    js = jenv.init_fn(jax.random.key(0))
    js = dataclasses.replace(js, task=dataclasses.replace(js.task, prev_targets=jnp.asarray(q[:, 7:])))
    ts = env.init_fn(0)
    ts = dataclasses.replace(ts, task=dataclasses.replace(ts.task, prev_targets=torch.as_tensor(q[:, 7:])))
    jq, jqd, tq, tqd = jnp.asarray(q), jnp.asarray(qd), torch.as_tensor(q), torch.as_tensor(qd)
    touched, violated = 0.0, 0.0
    for _ in range(3):
        a = rng.uniform(-1.0, 1.0, (B, 20)).astype(np.float32)
        jctrl, jw, jtask = jt.pre_physics(js, jnp.asarray(a))
        tctrl, tw, ttask = tt.pre_physics(ts, torch.as_tensor(a))
        np.testing.assert_allclose(tctrl.target_pos.numpy(), np.asarray(jctrl.target_pos), atol=1e-6)
        assert not tw.any() and not np.asarray(jw).any()
        js, ts = dataclasses.replace(js, task=jtask), dataclasses.replace(ts, task=ttask)
        violated = max(violated, float((np.abs(tendon_length(tm, tq[:, 7:].numpy())) > 0.05).mean()))
        jq, jqd, jnet = jstep(jparams, jq, jqd, jctrl, jnp.zeros((B, jm.nb, 6)))
        tq, tqd, tnet = step(tparams, tq, tqd, tctrl, tw)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(tnet.numpy(), np.asarray(jnet), atol=1.0, rtol=5e-3)
        touched = max(touched, float(tnet[2:, tt.object_body, :3].abs().max()))
    assert touched > 1.0                            # the pairs act on the cube
    assert violated > 0.1                           # the tendon springs act


def test_post_physics_and_dof_forces_match_jax(envs):
    jenv, env = envs
    jt, tt = jenv.task, env.task
    rng = np.random.default_rng(0)
    js = jenv.init_fn(jax.random.key(0))
    q = contact_states(tt.model, rng, B)
    q[1, 0:3] = [0.0, -0.39 + 0.3, 0.56]            # fallen: 0.3 m from the goal
    L = tendon_length(tt.model, q[:, 7:])
    assert (L < -0.05).any() and (L > 0.05).any() and (np.abs(L) < 0.05).any()
    goal = rng.normal(size=(B, 4))
    goal /= np.linalg.norm(goal, axis=1, keepdims=True)
    goal[0] = q[0, 3:7]                              # reached: the goal is the cube's orientation
    qd = rng.normal(size=(B, tt.model.nv)) * 0.5
    progress = np.array([3, 10, 599, 40])            # env 2 times out
    task = dict(goal_rot=goal, successes=np.array([2.0, 0.0, 5.0, 1.0]),
                cons_successes=np.full(B, 0.7), prev_targets=q[:, 7:] + rng.normal(size=(B, 24)) * 0.1,
                actions=rng.uniform(-1, 1, (B, 20)), rb_force=np.zeros((B, 3)),
                force_prob=np.full(B, 0.01), goal_cap=np.array([0.8, 2.0, np.pi - 1e-4, 3.0]))
    task = {k: np.asarray(v, np.float32) for k, v in task.items()}
    net = rng.normal(size=(B, tt.model.nb, 3)) * 5
    tq_ = rng.normal(size=(B, tt.model.nb, 3))
    js = dataclasses.replace(
        js, q=jnp.asarray(q), qd=jnp.asarray(qd, jnp.float32), progress=jnp.asarray(progress, jnp.int32),
        net_contact=jnp.asarray(net, jnp.float32), net_torque=jnp.asarray(tq_, jnp.float32),
        task=dataclasses.replace(js.task, **{k: jnp.asarray(v) for k, v in task.items()}))
    ts = env.init_fn(0)
    ts = dataclasses.replace(
        ts, q=torch.as_tensor(q), qd=torch.as_tensor(qd, dtype=torch.float32),
        progress=torch.as_tensor(progress), net_contact=torch.as_tensor(net, dtype=torch.float32),
        net_torque=torch.as_tensor(tq_, dtype=torch.float32),
        task=tshadow.HandTaskState(**{k: torch.as_tensor(v) for k, v in task.items()}))
    jdof = jt._dof_force_estimate(js, js.task)
    dof = tt._dof_force_estimate(ts, ts.task)
    np.testing.assert_allclose(dof.numpy(), np.asarray(jdof), atol=1e-5, rtol=1e-6)
    # the tendon springs' torque is felt beside the drive torque
    jq, jqd = ts.q[:, 7:], ts.qd[:, 6:]
    drive = torch.clamp(tt.kp * (ts.task.prev_targets - jq) - tt.kd * jqd, -tt.effort_lim, tt.effort_lim)
    assert float((dof - drive).abs().max()) > 0.1
    jobs, jrew, jdone, jtask, _ = jt.post_physics(js, js.task)
    obs, rew, done, ttask, metrics = tt.post_physics(ts, ts.task)
    assert tuple(obs.shape) == (B, 211)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done.numpy().tolist() == [0.0, 1.0, 0.0, 0.0]
    for k in ("successes", "cons_successes", "goal_cap"):
        np.testing.assert_allclose(getattr(ttask, k).numpy(), np.asarray(getattr(jtask, k)),
                                   atol=1e-6, err_msg=k)
    assert ttask.successes.numpy().tolist() == [3.0, 0.0, 5.0, 1.0]
    np.testing.assert_array_equal(ttask.goal_rot.numpy()[1:], np.asarray(jtask.goal_rot)[1:])
    assert float(metrics["rot_dist"][0]) < 1e-3


def test_asymmetric_states_match_jax():
    env_blk = {"env": {**_yaml("task", "ShadowHand.yaml")["env"], "asymmetric_observations": True}}
    with pytest.warns(UserWarning):
        jenv = tgx.make("ShadowHand", num_envs=B, seed=0, cfg=env_blk)
        env = tgt.make("ShadowHand", num_envs=B, seed=0, cfg=env_blk, device="cpu")
    jt, tt = jenv.task, env.task
    assert tt.num_states == jt.num_states == 211
    rng = np.random.default_rng(8)
    q = contact_states(tt.model, rng, B)
    qd = (rng.normal(size=(B, tt.model.nv)) * 0.5).astype(np.float32)
    net = np.zeros((B, tt.model.nb, 3), np.float32)
    tq_ = np.zeros((B, tt.model.nb, 3), np.float32)
    net[:, tt.fingertip_ids] = rng.normal(size=(B, 5, 3)) * 5
    tq_[:, tt.fingertip_ids] = rng.normal(size=(B, 5, 3)) * 0.05
    goal = rng.normal(size=(B, 4))
    task = dict(goal_rot=goal / np.linalg.norm(goal, axis=1, keepdims=True),
                prev_targets=q[:, 7:] + rng.normal(size=(B, 24)) * 0.1,
                actions=rng.uniform(-1, 1, (B, 20)))
    task = {k: np.asarray(v, np.float32) for k, v in task.items()}
    js = jax.jit(jenv.init_fn)(jax.random.key(0))
    js = dataclasses.replace(
        js, q=jnp.asarray(q), qd=jnp.asarray(qd), net_contact=jnp.asarray(net),
        net_torque=jnp.asarray(tq_),
        task=dataclasses.replace(js.task, **{k: jnp.asarray(v) for k, v in task.items()}))
    ts = env.init_fn(0)
    ts = dataclasses.replace(
        ts, q=torch.as_tensor(q), qd=torch.as_tensor(qd), net_contact=torch.as_tensor(net),
        net_torque=torch.as_tensor(tq_),
        task=dataclasses.replace(ts.task, **{k: torch.as_tensor(v) for k, v in task.items()}))
    jstates = jax.jit(jt.compute_states)(js, js.task)
    states = tt.compute_states(ts, ts.task)
    assert tuple(states.shape) == (B, 211) and tuple(ts.states.shape) == (B, 211)
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates), atol=1e-4, rtol=1e-5)
    # the fingertip force-torque rows (161-190, after 72 joint, 24 object and
    # goal, and 65 fingertip-state rows), scaled by 10, are read
    assert float(states[:, 161:191].abs().min(-1).values.min()) > 0.0


def test_shadow_hand_ppo_iteration_on_cpu():
    train = _yaml("train", "ShadowHandPPO.yaml")
    small = dict(horizon_length=4, minibatch_size=32, mixed_precision=False)
    jcfg = dataclasses.replace(jppo.PPOConfig.from_rlgames(train), **small)
    tcfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(train), **small)
    assert (tcfg.units, tcfg.activation, tcfg.separate, tcfg.fixed_sigma) == \
        ((512, 512, 256, 128), "elu", False, True)
    assert (tcfg.mini_epochs, tcfg.reward_shaper_scale) == (5, 0.01)
    cfg = _yaml("task", "ShadowHand.yaml")
    with pytest.warns(UserWarning):
        jenv = tgx.make("ShadowHand", num_envs=8, seed=0, cfg={"env": cfg["env"]})
        env = tgt.make("ShadowHand", num_envs=8, seed=0, cfg=cfg, device="cpu")
    jts = jppo.PPO(jenv, jcfg).init(jax.random.key(1))
    ppo = tppo.PPO(env, tcfg, device="cpu")
    ts = convert.train_state(ppo, jax.tree.map(np.asarray, jts))
    obs = np.random.default_rng(2).normal(size=(16, 211)).astype(np.float32)
    want = jppo.PPO(jenv, jcfg).network.apply(jts.params, jnp.asarray(obs))
    with torch.no_grad():
        got = ts.model(torch.as_tensor(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    state = env.reset(0)
    ts, state, metrics = ppo.train_iteration(ts, state)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), (k, v)
    assert ts.epoch == 1 and tuple(state.obs.shape) == (8, 211)
    assert env.physics_step.launches == 0
