"""Port parity for the hand models and tasks/allegro_hand.py (the AllegroHand
slice: its cube and palm, its 12 capsule-box and 1 box-box actor pairs).

- ``load_shadow_hand`` (24 DOFs, its 4 tendons), ``load_allegro_hand`` (16
  DOFs) and ``make_block_urdf``: topology, geoms and ``_defaults`` equal to
  JAX's, exactly; the task obs tables of tests/test_hands.py.
- The AllegroHand physics (the op path, the plain version of the kernel)
  against the JAX op path ``build_step_fn(fused=False)`` at B = 4 over 3
  control steps of controlFrequencyInv = 2 physics steps (dt 1/60 s, 2
  substeps), from JAX-sampled reset states and from states with the cube
  pressed into the palm and fingers, targets from seeded actions through
  both tasks' ``pre_physics`` (equal at atol 1e-6): q atol=rtol 2e-3, qd
  2e-2, net atol 1.0 / rtol 5e-3 (tests/test_fused.py's tolerances).
- ``post_physics`` against JAX on identical states and task states: the
  88-dim obs atol 1e-4 / rtol 1e-5, reward atol 1e-4 / rtol 1e-5, done,
  successes, the consecutive-success EMA and the curriculum cap (its step
  and its clamp at pi) at 1e-6; the goal where no success resamples it
  exactly, and a resampled goal lies within [0.2, cap] of the cube (the
  random streams differ by design).
- ``make("AllegroHand", cfg=AllegroHand.yaml, device="cpu")``: obs 88, the
  YAML's dt 0.01667 s (1/60 to its 4 digits), 2 substeps, 2 physics steps per
  control step, the box instance of the kernel with the fingertips' torque
  rows; ``make`` without a device raises where there is no card, and
  ``make("ShadowHand")`` builds, with its tendons (tests/test_torch_shadow_hand.py
  holds it against JAX).
- One AllegroHandPPO iteration at 8 envs on the CPU is finite, from weights
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
from thormang_isaacgym_tpu.models import allegro_hand as jallegro
from thormang_isaacgym_tpu.models import load_urdf as jax_load_urdf
from thormang_isaacgym_tpu.models import shadow_hand as jshadow
from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
from thormang_isaacgym_tpu.tasks.allegro_hand import ALLEGRO_NUM_OBS as J_ALLEGRO_NUM_OBS
from thormang_isaacgym_tpu.tasks.shadow_hand import NUM_OBS as J_NUM_OBS
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch import models as tmodels
from thormang_isaacgym_tpu_torch.learn import ppo as tppo
from thormang_isaacgym_tpu_torch.ops import collide
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import build_plain_step_fn
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.tasks import allegro_hand as tallegro
from thormang_isaacgym_tpu_torch.tasks import shadow_hand as tshadow

from test_torch_fused import allegro_contact_q as contact_states

B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _yaml(kind, name):
    with open(os.path.join(ROOT, "cfg", kind, name)) as f:
        return yaml.safe_load(f)


def _same_model(a, b):
    for f in ("parent", "joint_type", "joint_names", "body_names", "tendons"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("joint_axis", "joint_pos", "joint_quat"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), f)
    assert [(g.body, g.gtype, tuple(g.size), tuple(g.pos), tuple(g.quat)) for g in a.geoms] == \
        [(g.body, g.gtype, tuple(g.size), tuple(g.pos), tuple(g.quat)) for g in b.geoms]
    assert set(a._defaults) == set(b._defaults)
    for k in a._defaults:
        np.testing.assert_array_equal(np.asarray(a._defaults[k]), np.asarray(b._defaults[k]), k)


def test_hand_models_match_jax():
    sh, jsh = tmodels.load_shadow_hand(), jshadow.load_shadow_hand()
    _same_model(sh, jsh)
    assert sh.nj == 24 and len(tmodels.ACTUATED_DOF_NAMES) == 20 and len(sh.tendons) == 4
    assert tmodels.ACTUATED_DOF_NAMES == jshadow.ACTUATED_DOF_NAMES
    assert tmodels.FINGERTIP_BODIES == jshadow.FINGERTIP_BODIES
    for coef, lo, hi, _ in sh.tendons:
        c = np.asarray(coef)
        assert (c != 0).sum() == 2 and c.sum() == 0.0 and (lo, hi) == (-0.05, 0.05)
    assert (np.asarray(sh._defaults["tendon_stiffness"]) == 30.0).all()
    ah, jah = tmodels.load_allegro_hand(), jallegro.load_allegro_hand()
    _same_model(ah, jah)
    assert (ah.nj, ah.nb, len(ah.tendons)) == (16, 17, 0)
    assert tmodels.ALLEGRO_DOF_NAMES == jallegro.ALLEGRO_DOF_NAMES
    assert tmodels.make_allegro_urdf() == jallegro.make_allegro_urdf()
    assert tmodels.make_block_urdf() == jshadow.make_block_urdf()
    _same_model(tmodels.load_urdf(tmodels.make_block_urdf()), jax_load_urdf(jshadow.make_block_urdf()))
    assert tshadow.NUM_OBS == J_NUM_OBS and tallegro.ALLEGRO_NUM_OBS == J_ALLEGRO_NUM_OBS


@pytest.fixture(scope="module")
def envs():
    """The JAX and port AllegroHand envs at B = 4 with AllegroHand.yaml's env
    block; the port keeps the task's own sim block (dt 1/60 s), as JAX does."""
    env_blk = {"env": _yaml("task", "AllegroHand.yaml")["env"]}
    with pytest.warns(UserWarning):                 # the reference keys neither task reads
        jenv = tgx.make("AllegroHand", num_envs=B, seed=0, cfg=env_blk)
        env = tgt.make("AllegroHand", num_envs=B, seed=0, cfg=env_blk, device="cpu")
    return jenv, env


def test_scene_and_pairs_match_jax(envs):
    jenv, env = envs
    jm, tm = jenv.task.model, env.task.model
    _same_model(tm, jm)
    from thormang_isaacgym_tpu.ops import collide as jcollide
    assert collide.pairs(tm) == tuple(jcollide._pairs(jm))
    kinds = [k for _, _, k in collide.pairs(tm)]
    assert (kinds.count("boxbox"), kinds.count("capbox"), len(kinds)) == (1, 12, 13)
    assert collide.pair_candidate_count(tm) == 65
    assert (env.task.num_obs, env.task.control_freq_inv) == (88, 2)
    np.testing.assert_array_equal(env.task.act_ids, jenv.task.act_ids)
    np.testing.assert_array_equal(env.task.fingertip_ids, jenv.task.fingertip_ids)
    assert env.task.net_torque_bodies == jenv.task.net_torque_bodies


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
    js = jenv.init_fn(jax.random.key(0))
    ts = env.init_fn(0)
    jq, jqd, tq, tqd = jnp.asarray(q), jnp.asarray(qd), torch.as_tensor(q), torch.as_tensor(qd)
    touched = 0.0
    for _ in range(3):
        a = rng.uniform(-1.0, 1.0, (B, 16)).astype(np.float32)
        jctrl, jw, jtask = jt.pre_physics(js, jnp.asarray(a))
        tctrl, tw, ttask = tt.pre_physics(ts, torch.as_tensor(a))
        np.testing.assert_allclose(tctrl.target_pos.numpy(), np.asarray(jctrl.target_pos), atol=1e-6)
        assert not tw.any() and not np.asarray(jw).any()
        js, ts = dataclasses.replace(js, task=jtask), dataclasses.replace(ts, task=ttask)
        for _ in range(tt.control_freq_inv):
            jq, jqd, jnet = jstep(jparams, jq, jqd, jctrl, jnp.zeros((B, jm.nb, 6)))
            tq, tqd, tnet = step(tparams, tq, tqd, tctrl, tw)
            np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-3, rtol=2e-3)
            np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=2e-2, rtol=2e-2)
            np.testing.assert_allclose(tnet.numpy(), np.asarray(jnet), atol=1.0, rtol=5e-3)
            touched = max(touched, float(tnet[2:, tt.object_body, :3].abs().max()))
    assert touched > 1.0                            # the pairs act on the cube


def test_post_physics_matches_jax(envs):
    jenv, env = envs
    jt, tt = jenv.task, env.task
    rng = np.random.default_rng(0)
    js = jenv.init_fn(jax.random.key(0))
    q = contact_states(tt.model, rng, B)
    q[1, 0:3] = [0.0, -0.08 + 0.3, 0.54]            # fallen: 0.3 m from the goal
    goal = rng.normal(size=(B, 4))
    goal /= np.linalg.norm(goal, axis=1, keepdims=True)
    goal[0] = q[0, 3:7] * [1, 1, 1, 1]               # reached: the goal is the cube's orientation
    qd = rng.normal(size=(B, tt.model.nv)) * 0.5
    progress = np.array([3, 10, 599, 40])            # env 2 times out
    task = dict(goal_rot=goal, successes=np.array([2.0, 0.0, 5.0, 1.0]),
                cons_successes=np.full(B, 0.7), prev_targets=q[:, 7:] + rng.normal(size=(B, 16)) * 0.1,
                actions=rng.uniform(-1, 1, (B, 16)), rb_force=np.zeros((B, 3)),
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
    jobs, jrew, jdone, jtask, _ = jt.post_physics(js, js.task)
    obs, rew, done, ttask, metrics = tt.post_physics(ts, ts.task)
    assert tuple(obs.shape) == (B, 88)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done.numpy().tolist() == [0.0, 1.0, 0.0, 0.0]
    for k in ("successes", "cons_successes", "goal_cap"):
        np.testing.assert_allclose(getattr(ttask, k).numpy(), np.asarray(getattr(jtask, k)),
                                   atol=1e-6, err_msg=k)
    assert ttask.successes.numpy().tolist() == [3.0, 0.0, 5.0, 1.0]
    np.testing.assert_allclose(ttask.goal_cap.numpy(), [0.80025, 2.00025, np.pi, 3.00025], atol=1e-6)
    # the goal resamples where it was reached, within [0.2, cap] of the cube
    reached = np.asarray(jtask.goal_rot != js.task.goal_rot).any(-1)
    assert reached.tolist() == [True, False, False, False]
    np.testing.assert_array_equal(ttask.goal_rot.numpy()[1:], np.asarray(jtask.goal_rot)[1:])
    d = tt.post_physics(ts, dataclasses.replace(ts.task, goal_rot=ttask.goal_rot))[4]["rot_dist"]
    assert 0.2 - 1e-4 <= float(d[0]) <= 0.8 + 1e-4
    assert float(metrics["rot_dist"][0]) < 1e-3


def test_make_allegro_hand_with_its_yaml():
    with pytest.warns(UserWarning):
        env = tgt.make("AllegroHand", num_envs=8, seed=0, cfg=_yaml("task", "AllegroHand.yaml"),
                       device="cpu")
    task, step = env.task, env.physics_step
    assert (task.num_obs, task.num_actions, task.obs_type) == (88, 16, "full_state")
    assert abs(task.sim_params.dt - 1 / 60) < 1e-5 and task.dt == task.sim_params.dt
    assert (task.sim_params.substeps, task.control_freq_inv, task.max_episode_length) == (2, 2, 600)
    assert step.pair_mode == 2 and step.tq_bodies == tuple(int(b) for b in task.fingertip_ids)
    assert step.out_rows == task.model.nq + task.model.nv + 3 * task.model.nb + 3 * 4
    s = env.step(env.reset(0), torch.zeros(8, 16))
    assert tuple(s.obs.shape) == (8, 88) and bool(torch.isfinite(s.obs).all())
    assert step.launches == 0                        # CPU tensors run the plain version
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tgt.make("AllegroHand", num_envs=8)
    shadow = tgt.make("ShadowHand", num_envs=8, device="cpu")
    assert len(shadow.task.model.tendons) == 4 and shadow.physics_step.pair_mode == 2
    assert shadow.physics_step._tables[0][42] == 4


def test_allegro_hand_ppo_iteration_on_cpu():
    train = _yaml("train", "AllegroHandPPO.yaml")
    small = dict(horizon_length=4, minibatch_size=32, mixed_precision=False)
    jcfg = dataclasses.replace(jppo.PPOConfig.from_rlgames(train), **small)
    tcfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(train), **small)
    assert (tcfg.units, tcfg.activation, tcfg.separate, tcfg.fixed_sigma) == \
        ((512, 256, 128), "elu", False, True)
    assert (tcfg.mini_epochs, tcfg.critic_coef, tcfg.reward_shaper_scale) == (5, 4, 0.01)
    cfg = _yaml("task", "AllegroHand.yaml")
    with pytest.warns(UserWarning):
        jenv = tgx.make("AllegroHand", num_envs=8, seed=0, cfg={"env": cfg["env"]})
        env = tgt.make("AllegroHand", num_envs=8, seed=0, cfg=cfg, device="cpu")
    jts = jppo.PPO(jenv, jcfg).init(jax.random.key(1))
    ppo = tppo.PPO(env, tcfg, device="cpu")
    ts = convert.train_state(ppo, jax.tree.map(np.asarray, jts))
    obs = np.random.default_rng(2).normal(size=(16, 88)).astype(np.float32)
    want = jppo.PPO(jenv, jcfg).network.apply(jts.params, jnp.asarray(obs))
    with torch.no_grad():
        got = ts.model(torch.as_tensor(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    state = env.reset(0)
    ts, state, metrics = ppo.train_iteration(ts, state)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), (k, v)
    assert ts.epoch == 1 and tuple(state.obs.shape) == (8, 88)
    assert env.physics_step.launches == 0


def test_fingertip_sensors_and_forces_on_cpu():
    """The fingertips' torque rows reach net_torque (the other bodies' stay
    zero); the random object force, when on, is a wrench on the cube only."""
    env = tgt.make("AllegroHand", num_envs=8, seed=0, device="cpu", force_scale=10.0)
    task = env.task
    s = env.reset(0)
    rng = np.random.default_rng(5)
    prob = torch.tensor([1.0, 0.0] * 4)               # a kick every step, or never
    s = dataclasses.replace(s, q=torch.as_tensor(contact_states(task.model, rng, 8)),
                            task=dataclasses.replace(s.task, force_prob=prob))
    ctrl, wrench, t = task.pre_physics(s, torch.zeros(8, 16))
    kicked = t.rb_force.abs().amax(-1) > 0
    assert kicked.tolist() == [True, False] * 4
    others = [b for b in range(task.model.nb) if b != task.object_body]
    assert not wrench[:, others].any()
    torch.testing.assert_close(wrench[:, task.object_body, 3:6], t.rb_force)
    s = env.step(s, torch.zeros(8, 16))
    tips = list(task.fingertip_ids)
    rest = [b for b in range(task.model.nb) if b not in tips]
    assert not s.net_torque[:, rest].any() and bool(torch.isfinite(s.net_torque).all())
    frames = forward_kinematics(task.model, s.q, s.qd)
    assert bool(torch.isfinite(frames.pos).all())
