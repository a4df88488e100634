"""Port parity for the AMP stack: models/amp_humanoid.py, learn/motion_lib.py,
tasks/humanoid_amp.py (HumanoidAMP) and the discriminator of
learn/networks.py, against the JAX package on identical numpy inputs made
from seeds (float32).

- The model: the URDF string character for character, 29 bodies, 28
  joints, nq 35, nv 34, the hands as sites, ``amp_dof_perm`` and the
  drives; the flat instance's local layout (the shared and split layouts
  over the budget).
- ``canonicalize_clip`` and ``make_gait_clip`` (numpy in both): equal bit
  for bit. ``MotionLib.get_motion_state`` on two clips of different fps and
  lengths at frame times, midpoints and clamped ends: atol 1e-5, rtol 1e-5
  (JAX jitted: XLA fuses the lerps into FMAs, 3e-6 apart).
- ``dof_to_obs`` and ``build_amp_observations`` (with and without the local
  root rotation): atol 1e-6, rtol 1e-5.
- The reset in each of the four init modes from JAX-sampled motion ids,
  times and Hybrid draws (JAX's threefry draws fed across to
  ``reset_from``): q, qd and the AMP window at atol 1e-5, rtol 1e-5.
- ``pre_physics`` (the PD targets) at atol 1e-6; ``post_physics`` on states
  where some envs fall and some do not (contact and height, the first
  steps exempt): obs and window atol 1e-5, rtol 1e-5, done exactly,
  ``pose_error`` atol 1e-5.
- One control step (2 physics steps of 2 substeps) of the port's plain
  step against the JAX op path at 4 envs from reference states with the
  feet in the ground: q atol=rtol 2e-3, qd 2e-2, net atol 1.0 / rtol 5e-3
  (tests/test_fused.py's tolerances).
- ``fetch_amp_obs_demo``'s windows on identical ids and times: atol 1e-5.
- ``make`` with cfg/task/HumanoidAMP.yaml: dt is the control step 0.0332 s
  (the physics step 0.0166 x controlFrequencyInv 2), the env keys reach the
  task as in JAX, and without CUDA and ``device=`` it raises.
- The learner (learn/amp.py) on stand-in envs: the config, the
  discriminator's forward pass (atol 1e-5), ``_loss`` and its gradients on
  one minibatch with the gradient penalty, the logit regulariser and the
  weight decay all non-zero (loss atol=rtol 1e-5, gradients 1e-4), and one
  ``train_iteration`` against JAX's (one minibatch of all T B rows, one
  mini-epoch, the rollout and the demo fetch stubbed, a ring of one
  repeated row, keep-prob 1): normalisers, metrics and weights at atol=rtol
  1e-5 / 1e-4, the inserted rows equal as a set.
"""
import dataclasses
import os
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.learn import amp as jamp
from thormang_isaacgym_tpu.learn import motion_lib as jml
from thormang_isaacgym_tpu.learn.normalize import rms_update as jrms_update
from thormang_isaacgym_tpu.models import amp_humanoid as jah
from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
from thormang_isaacgym_tpu.tasks import humanoid_amp as jha
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.learn import amp as tamp
from thormang_isaacgym_tpu_torch.learn import motion_lib as tml
from thormang_isaacgym_tpu_torch.models import amp_humanoid as tah
from thormang_isaacgym_tpu_torch.ops.sim import build_plain_step_fn
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.tasks import NOT_PORTED
from thormang_isaacgym_tpu_torch.tasks import humanoid_amp as tha

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
TOL = dict(atol=1e-5, rtol=1e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)


def _yaml(kind, name):
    with open(os.path.join(ROOT, "cfg", kind, f"{name}.yaml")) as f:
        return yaml.safe_load(f)


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **tol)


@pytest.fixture(scope="module")
def tasks():
    """The JAX and port HumanoidAMP tasks (the gait clip) at B envs."""
    return jha.HumanoidAMP(num_envs=B, seed=0), tha.HumanoidAMP(num_envs=B, device="cpu")


# ---------------------------------------------------------------------------
# the model and the motion library
# ---------------------------------------------------------------------------

def test_model_matches_jax():
    assert tah.make_amp_humanoid_urdf() == jah.make_amp_humanoid_urdf()
    jm, tm = jah.load_amp_humanoid(), tah.load_amp_humanoid()
    assert (tm.nb, tm.nj, tm.nq, tm.nv) == (jm.nb, jm.nj, jm.nq, jm.nv) == (29, 28, 35, 34)
    assert list(tm.body_names) == list(jm.body_names) and tm.sites == jm.sites
    assert sorted(tm.sites) == ["left_hand", "right_hand"]
    np.testing.assert_array_equal(tah.amp_dof_perm(tm), jah.amp_dof_perm(jm))
    assert (tah.AMP_DOF_NAMES, tah.DOF_OFFSETS) == (jah.AMP_DOF_NAMES, jah.DOF_OFFSETS)
    for k in ("drive_mode", "drive_stiffness", "drive_damping", "drive_effort_limit",
              "dof_lower", "dof_upper"):
        np.testing.assert_array_equal(np.asarray(tm._defaults[k]), np.asarray(jm._defaults[k]),
                                      err_msg=k)
    from thormang_isaacgym_tpu_torch.ops import fused
    f = fused.build_fused_step_fn(tm, tha.HumanoidAMP(num_envs=2, device="cpu").sim_params)
    # over the shared and the split layouts' budget: the flat instance's lean split layout
    assert (f.pair_mode, f.layout, f.smem_bytes) == (0, "split_lean", 228_768)
    assert f.layout_bytes > fused.SMEM_BUDGET


def _random_clip(rng, F, fps):
    """A canonicalized clip of seeded rotations (F frames at fps)."""
    def quats(*shape):
        q = rng.normal(size=shape + (4,))
        return q / np.linalg.norm(q, axis=-1, keepdims=True)
    root_pos = np.cumsum(rng.normal(size=(F, 3)) * 0.02, 0) + [0, 0, 0.9]
    return root_pos, quats(F), quats(F, 12), fps


def test_canonicalize_and_gait_clip_match_jax():
    jg, tg = jml.make_gait_clip(), tml.make_gait_clip()
    args = _random_clip(np.random.default_rng(0), 17, 60.0)
    jc, tc = jml.canonicalize_clip(*args), tml.canonicalize_clip(*args)
    for want, got in ((jg, tg), (jc, tc)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def libs():
    """Two clips: the gait clip (30 fps, 85 frames) and a seeded one (60
    fps, 17 frames), sampling weights 1 : 3."""
    clips = [jml.make_gait_clip(), jml.canonicalize_clip(*_random_clip(
        np.random.default_rng(1), 17, 60.0))]
    return jml.MotionLib(clips, weights=[1.0, 3.0]), tml.MotionLib(clips, weights=[1.0, 3.0])


@pytest.mark.parametrize("where", ["frames", "midpoints", "ends"])
def test_motion_state_matches_jax(libs, where):
    jlib, tlib = libs
    ids, times = [], []
    for m, (nf, fps) in enumerate(((85, 30.0), (17, 60.0))):
        f = np.arange(nf, dtype=np.float64)
        t = {"frames": f / fps, "midpoints": (f[:-1] + 0.5) / fps,
             "ends": np.array([-0.3, -1e-4, 0.0, (nf - 1) / fps, (nf - 1) / fps + 1e-4, 5.0]),
             }[where]
        ids.append(np.full(len(t), m))
        times.append(t)
    ids = np.concatenate(ids).astype(np.int32)
    times = np.concatenate(times).astype(np.float32)
    want = jax.jit(jlib.get_motion_state)(jnp.asarray(ids), jnp.asarray(times))
    got = tlib.get_motion_state(torch.as_tensor(ids, dtype=torch.int64), torch.as_tensor(times))
    names = ("root_pos", "root_rot", "dof_pos", "root_vel", "root_ang_vel", "dof_vel", "key_pos")
    for n, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), n
        _close(g, w, dict(atol=1e-5, rtol=1e-5), n)
    _close(tlib.lengths, jlib.lengths, dict(atol=0, rtol=0))


def test_motion_sampling_follows_the_weights(libs):
    """The port's draws are not JAX's threefry streams; their law is: ids by
    the weights 1 : 3, times uniform over each clip's length."""
    _, tlib = libs
    gen = torch.Generator().manual_seed(0)
    ids = tlib.sample_motions(gen, 20000)
    assert abs(float((ids == 1).float().mean()) - 0.75) < 0.01
    t = tlib.sample_time(gen, ids)
    assert bool((t >= 0).all()) and bool((t < tlib.lengths[ids]).all())
    np.testing.assert_array_equal(tlib.ids_at(torch.tensor([0.0, 0.2499, 0.25, 0.9999])).numpy(),
                                  [0, 0, 1, 1])


# ---------------------------------------------------------------------------
# the task
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("local_root_obs", [False, True])
def test_amp_observations_match_jax(local_root_obs):
    rng = np.random.default_rng(2)
    n = 6
    rot = rng.normal(size=(n, 4))
    args = [rng.normal(size=(n, 3)), rot / np.linalg.norm(rot, axis=-1, keepdims=True),
            rng.normal(size=(n, 3)), rng.normal(size=(n, 3)), rng.uniform(-3.1, 3.1, (n, 28)),
            rng.normal(size=(n, 28)), rng.normal(size=(n, 4, 3))]
    args = [a.astype(np.float32) for a in args]
    want = jax.jit(jha.build_amp_observations, static_argnums=7)(*map(jnp.asarray, args),
                                                                 local_root_obs)
    got = tha.build_amp_observations(*map(torch.as_tensor, args), local_root_obs)
    assert tuple(got.shape) == (n, 105)
    _close(got, want, dict(atol=1e-6, rtol=1e-5))
    _close(tha.dof_to_obs(torch.as_tensor(args[4])), jax.jit(jha.dof_to_obs)(jnp.asarray(args[4])),
           dict(atol=1e-6, rtol=1e-5))


def _jax_draws(jt, keys):
    """The motion ids, times and Hybrid draws of the JAX reset_fn under
    `keys` (its own splits, as reset_fn makes them)."""
    def draw(key):
        k_mode, k_m, k_t = jax.random.split(key, 3)
        mid = jt.motion_lib.sample_motions(k_m, 1)[0]
        return mid, jt.motion_lib.sample_time(k_t, mid[None])[0], \
            jax.random.bernoulli(k_mode, jt.hybrid_init_prob)
    return [np.array(x) for x in jax.jit(jax.vmap(draw))(keys)]


@pytest.mark.parametrize("mode", ["Default", "Start", "Random", "Hybrid"])
def test_reset_matches_jax(tasks, mode):
    jt, tt = tasks
    jt.state_init = tt.state_init = tha.STATE_INIT[mode]
    try:
        keys = jax.random.split(jax.random.key(5), 8)
        task0 = jax.tree.map(lambda x: x[0], jt.default_task_state(jax.random.key(0)))
        params = jt.model.default_params()
        jq, jqd, _, jtask = jax.jit(jax.vmap(lambda k: jt.reset_fn(k, params, task0)))(keys)
        ids, t, use_ref = _jax_draws(jt, keys)
        q, qd, amp = tt.reset_from(torch.as_tensor(ids, dtype=torch.int64),
                                   torch.tensor(t), torch.tensor(use_ref))
    finally:
        jt.state_init = tt.state_init = tha.STATE_INIT["Random"]
    if mode == "Hybrid":
        assert 0 < use_ref.sum() < len(use_ref)
    assert tuple(amp.shape) == (8, 2, 105)
    _close(q, jq, msg="q")
    _close(qd, jqd, msg="qd")
    _close(amp, jtask.amp_obs, msg="window")
    if mode in ("Start", "Random"):
        # the history frame steps back by the control step, clamped at t = 0
        prev = tt._window(torch.as_tensor(ids, dtype=torch.int64), torch.as_tensor(
            np.maximum(t - 0.0332, 0.0) if mode == "Random" else np.zeros_like(t)))[:, 0]
        _close(amp[:, 1], prev, dict(atol=1e-6, rtol=1e-6))


def test_pre_physics_matches_jax(tasks):
    jt, tt = tasks
    a = np.random.default_rng(3).uniform(-1, 1, (B, 28)).astype(np.float32)
    jctrl, jw, _ = jt.pre_physics(SimpleNamespace(task=None), jnp.asarray(a))
    ctrl, w, _ = tt.pre_physics(SimpleNamespace(task=None), torch.as_tensor(a))
    _close(ctrl.target_pos, jctrl.target_pos, dict(atol=1e-6, rtol=1e-6))
    for got, want in ((ctrl.target_vel, jctrl.target_vel), (ctrl.effort, jctrl.effort), (w, jw)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(tt.pd_scale, jt.pd_scale, dict(atol=0, rtol=0))


def _ref_states(tt, n, seed):
    """n reference states of the gait clip at seeded times: (q, qd, window)."""
    rng = np.random.default_rng(seed)
    t = torch.as_tensor(rng.uniform(0.0, 2.7, n).astype(np.float32))
    q, qd, amp = tt.reset_from(torch.zeros(n, dtype=torch.int64), t,
                               torch.ones(n, dtype=torch.bool))
    return q.numpy().copy(), qd.numpy().copy(), amp.numpy().copy()


def test_post_physics_matches_jax(tasks):
    """Env 0 on the clip; 1 low with the head in contact (falls); 2 on the
    clip with the torso in contact (falls: standing, the shins are below
    the termination height); 3 low with only the feet in contact; 4 as 1
    on its first step (exempt); 5 low and nothing in contact. Env 0's
    torso yaw is turned a whole turn back: pose_error wraps it."""
    jt, tt = tasks
    n = 6
    q, qd, amp = _ref_states(tt, n, 4)
    rng = np.random.default_rng(5)
    qd += rng.normal(size=qd.shape).astype(np.float32) * 0.3
    q[[1, 3, 4, 5], 2] = 0.25
    q[0, 7 + tt.model.dof_id("torso_z")] -= 2.0 * np.pi
    net = np.zeros((n, tt.model.nb, 3), np.float32)
    head, torso = tt.model.body_id("head"), tt.model.body_id("torso")
    feet = [tt.model.body_id(k) for k in ("right_foot", "left_foot")]
    net[[1, 4], head, 2] = 30.0
    net[2, torso, 0] = 5.0
    net[3, feet, 2] = 200.0
    progress = np.array([5, 5, 5, 5, 1, 5])

    def post(mod, task_state, *xs):
        q_, qd_, net_, progress_, amp_ = xs
        state = SimpleNamespace(q=q_, qd=qd_, net_contact=net_, progress=progress_, metrics={})
        return mod.post_physics(state, task_state(amp_))

    xs = (q, qd, net, progress, amp)
    jout = jax.jit(lambda *a: post(jt, jha.AMPTaskState, *a))(*map(jnp.asarray, xs))
    out = post(tt, tha.AMPTaskState, *map(torch.as_tensor, xs))
    obs, rew, done, task, metrics = out
    assert tuple(obs.shape) == (n, 105)
    _close(obs, jout[0], msg="obs")
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jout[2]))
    assert done.numpy().tolist() == [0.0, 1.0, 1.0, 0.0, 0.0, 0.0]
    _close(task.amp_obs, jout[3].amp_obs, msg="window")
    np.testing.assert_array_equal(task.amp_obs[:, 1].numpy(), amp[:, 0])
    np.testing.assert_array_equal(metrics["terminate"].numpy(), np.asarray(jout[4]["terminate"]))
    _close(metrics["pose_error"], jout[4]["pose_error"], dict(atol=1e-5, rtol=0))
    # the states off the clip are off the demo poses; env 0's velocities moved, not its pose
    assert float(metrics["pose_error"][0]) < 0.05


def test_op_path_step_matches_jax(tasks):
    jt, tt = tasks
    jm, tm = jt.model, tt.model
    sp, jsp = tt.sim_params, jt.sim_params
    assert (sp.dt, sp.substeps) == (jsp.dt, jsp.substeps) == (0.0166, 2)
    q, qd, _ = _ref_states(tt, B, 6)
    a = np.random.default_rng(7).uniform(-0.5, 0.5, (B, 28)).astype(np.float32)
    jctrl, jw, _ = jt.pre_physics(SimpleNamespace(task=None), jnp.asarray(a))
    tctrl, tw, _ = tt.pre_physics(SimpleNamespace(task=None), torch.as_tensor(a))
    jstep = jax.jit(jax_build_step_fn(jm, jt.sim_params, fused=False))
    step = build_plain_step_fn(tm, tt.sim_params)
    jq, jqd, tq, tqd = jnp.asarray(q), jnp.asarray(qd), torch.as_tensor(q), torch.as_tensor(qd)
    for _ in range(tt.control_freq_inv):
        jq, jqd, jnet = jstep(jm.default_params().batch(B), jq, jqd, jctrl, jw)
        tq, tqd, tnet = step(tm.default_params().batch(B), tq, tqd, tctrl, tw)
    _close(tq, jq, dict(atol=2e-3, rtol=2e-3), "q")
    _close(tqd, jqd, dict(atol=2e-2, rtol=2e-2), "qd")
    jnet = np.asarray(jnet)
    _close(tnet[..., :jnet.shape[-1]], jnet, dict(atol=1.0, rtol=5e-3), "net")
    # a sole presses on the ground in every env
    feet = [tm.body_id(k) for k in ("right_foot", "left_foot")]
    assert float(tnet[:, feet, 2].sum(-1).min()) > 5.0


def test_fetch_amp_obs_demo_matches_jax(tasks):
    jt, tt = tasks
    n = 16
    key = jax.random.key(8)
    want = jax.jit(jt.fetch_amp_obs_demo, static_argnums=1)(key, n)
    k_m, k_t = jax.random.split(key)
    ids = jax.jit(jt.motion_lib.sample_motions, static_argnums=1)(k_m, n)
    t0 = jax.jit(jt.motion_lib.sample_time)(k_t, ids)
    got = tt.demo_obs(torch.as_tensor(np.array(ids), dtype=torch.int64),
                      torch.as_tensor(np.array(t0)))
    assert tuple(got.shape) == (n, 210)
    _close(got, want)
    gen = torch.Generator().manual_seed(0)
    assert tuple(tt.fetch_amp_obs_demo(gen, 5).shape) == (5, 210)


def test_make_with_humanoid_amp_yaml_matches_jax(monkeypatch):
    cfg = _yaml("task", "HumanoidAMP")

    def warned(fn):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            env = fn()
        return env, sorted(str(w.message).split("'")[1] for w in rec
                           if "matches no attribute" in str(w.message))

    jenv, jkeys = warned(lambda: tgx.make("HumanoidAMP", num_envs=2, seed=0, cfg=cfg))
    env, keys = warned(lambda: tgt.make("HumanoidAMP", num_envs=2, seed=0, cfg=cfg, device="cpu"))
    assert keys == jkeys == []
    task, jtask = env.task, jenv.task
    assert task.dt == jtask.dt == 0.0332
    assert (task.sim_params.dt, task.sim_params.substeps, task.control_freq_inv) == (0.0166, 2, 2)
    for attr in ("state_init", "num_amp_obs", "num_amp_obs_steps", "hybrid_init_prob",
                 "termination_height", "enable_early_termination", "local_root_obs",
                 "max_episode_length", "num_obs", "num_actions"):
        assert getattr(task, attr) == getattr(jtask, attr), attr
    assert (task.state_init, task.num_amp_obs) == (2, 210)
    state = env.reset(0)
    state = env.step(state, torch.zeros(2, 28))
    assert tuple(state.task.amp_obs.shape) == (2, 2, 105) and bool(torch.isfinite(state.obs).all())
    # every entry of the JAX registry resolves in the port's
    from thormang_isaacgym_tpu.tasks import TASK_MAP as JTASK_MAP
    from thormang_isaacgym_tpu_torch.tasks import get_task_class
    assert NOT_PORTED == {}
    for name in JTASK_MAP:
        assert get_task_class(name).__name__ == JTASK_MAP[name][1], name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgt.make("HumanoidAMP", num_envs=2, seed=0, cfg=cfg)


# ---------------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------------

T, NE, O, ACT, W = 4, 8, 12, 5, 7          # W: an AMP frame's width, 2 frames a window
N = T * NE


def _traj(rng):
    f = np.float32
    mu = rng.normal(size=(T, NE, ACT)).astype(f)
    log_std = np.full((T, NE, ACT), -0.3, f)
    done = (rng.uniform(size=(T, NE)) < 0.2).astype(f)
    return dict(obs=(rng.normal(size=(T, NE, O)) * 2).astype(f),
                action=(mu + np.exp(log_std) * rng.normal(size=mu.shape)).astype(f),
                logp=(rng.normal(size=(T, NE)) - 4).astype(f),
                value=rng.normal(size=(T, NE)).astype(f),
                mu=(mu + 0.05 * rng.normal(size=mu.shape)).astype(f), log_std=log_std,
                reward=rng.normal(size=(T, NE)).astype(f), done=done,
                timeout=done * (rng.uniform(size=(T, NE)) < 0.5),
                amp_obs=(rng.normal(size=(T, NE, 2 * W)) * 1.5 + 0.3).astype(f))


def _cfgs(**kw):
    """(JAX, port) AMPConfig of HumanoidAMPPPO.yaml, narrow, float32."""
    y = _yaml("train", "HumanoidAMPPPO")
    kw = dict(units=(32, 16), disc_units=(24, 16), horizon_length=T, minibatch_size=N,
              mini_epochs=1, amp_replay_buffer_size=N, amp_replay_keep_prob=1.0,
              lr_schedule="adaptive", **kw)
    return (dataclasses.replace(jamp.AMPConfig.from_rlgames(y), **kw),
            dataclasses.replace(tamp.AMPConfig.from_rlgames(y), **kw))


def _pair(jcfg, tcfg, seed=0, demo=None):
    """JAX AMPPPO on a stand-in env (normalisers off identity, the ring
    full of one repeated row at pointer 5), the port AMPPPO and the state
    carried across."""
    jtask = SimpleNamespace(num_states=0, num_agents=1, num_amp_obs=2 * W,
                            fetch_amp_obs_demo=lambda key, n: jnp.asarray(demo[:n]))
    ttask = SimpleNamespace(num_states=0, num_agents=1, num_amp_obs=2 * W,
                            fetch_amp_obs_demo=lambda gen, n: torch.as_tensor(demo[:n]))
    jenv = SimpleNamespace(num_obs=O, num_actions=ACT, num_envs=NE, task=jtask)
    tenv = SimpleNamespace(num_obs=O, num_actions=ACT, num_envs=NE, task=ttask, device="cpu")
    jp, tp = jamp.AMPPPO(jenv, jcfg), tamp.AMPPPO(tenv, tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    jts = jax.jit(jp.init)(jax.random.key(seed))
    f32 = jnp.float32
    # every weight and bias off its init (the biases start at 0)
    jts = dataclasses.replace(jts, params=jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.05, f32), jts.params))
    row = rng.normal(size=2 * W).astype(np.float32)
    jrms = jax.jit(jrms_update)
    jts = dataclasses.replace(
        jts, obs_rms=jrms(jts.obs_rms, jnp.asarray(rng.normal(size=(64, O)) * 2 + 1, f32)),
        value_rms=jrms(jts.value_rms, jnp.asarray(rng.normal(size=64) * 3, f32)),
        amp_rms=jrms(jts.amp_rms, jnp.asarray(rng.normal(size=(64, 2 * W)) * 1.2 - 0.4,
                                                     f32)),
        replay=jnp.tile(jnp.asarray(row), (N, 1)), replay_count=jnp.asarray(N, jnp.int32),
        replay_ptr=jnp.asarray(5, jnp.int32))
    return jp, jts, tp, convert.train_state(tp, jax.tree.map(np.asarray, jts))


def test_amp_config_from_rlgames_matches_jax():
    y = _yaml("train", "HumanoidAMPPPO")
    tcfg = tamp.AMPConfig.from_rlgames(y)
    jcfg = dataclasses.asdict(jamp.AMPConfig.from_rlgames(y))
    # amp_batch_size is parsed by JAX and read by nothing, so the port drops it.
    assert set(jcfg) - set(dataclasses.asdict(tcfg)) == {"amp_batch_size"}
    assert dataclasses.asdict(tcfg) == {k: jcfg[k] for k in dataclasses.asdict(tcfg)}
    assert (tcfg.units, tcfg.disc_units, tcfg.sigma_init, tcfg.horizon_length, tcfg.minibatch_size,
            tcfg.mini_epochs, tcfg.mixed_precision, tcfg.separate) == \
        ((1024, 512), (1024, 512), -2.9, 16, 32768, 6, False, True)


def test_amp_learner_geometry_at_the_published_width():
    """HumanoidAMPPPO at 4096 envs: 65,536 transitions, 2 minibatches,
    amp_mb 4096, 8,192 demo windows and 49,152 replay rows an iteration,
    655 rows into a ring of 65,536 x 210."""
    y = _yaml("train", "HumanoidAMPPPO")
    task = SimpleNamespace(num_states=0, num_agents=1, num_amp_obs=210)
    env = SimpleNamespace(num_obs=105, num_actions=28, num_envs=4096, task=task, device="cpu")
    cfg = tamp.AMPConfig.from_rlgames(y)
    p = tamp.AMPPPO(env, cfg, device="cpu")
    n = cfg.horizon_length * env.num_envs
    nmb = n // min(cfg.minibatch_size, n)
    assert (n, nmb, p.amp_mb, nmb * p.amp_mb, cfg.mini_epochs * nmb * p.amp_mb) == \
        (65536, 2, 4096, 8192, 49152)
    assert (p.replay_insert, p.replay_size) == (655, 65536)


def test_discriminator_forward_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, jts, tp, ts = _pair(jcfg, tcfg)
    x = np.random.default_rng(9).normal(size=(20, 2 * W)).astype(np.float32) * 2
    want = jax.jit(jp.disc.apply)(jts.params["disc"], jnp.asarray(x))
    got = ts.disc(torch.as_tensor(x))
    assert tuple(got.shape) == (20,)
    _close(got, want)
    assert [tuple(k.shape) for k in ts.disc.kernels()] == [(24, 2 * W), (16, 24), (1, 16)]


def _mb_batch(rng, traj):
    batch = {k: v.reshape((-1,) + v.shape[2:]) for k, v in traj.items()
             if k not in ("reward", "done", "timeout", "amp_obs")}
    batch["adv"] = rng.normal(size=N).astype(np.float32)
    batch["ret"] = rng.normal(size=N).astype(np.float32)
    batch["amp_cur"] = traj["amp_obs"].reshape(N, -1)[:16]
    batch["amp_replay"] = (rng.normal(size=(16, 2 * W)) - 0.5).astype(np.float32)
    batch["amp_demo"] = (rng.normal(size=(16, 2 * W)) * 0.7 + 0.8).astype(np.float32)
    return batch


def test_loss_and_grads_match_jax():
    jcfg, tcfg = _cfgs()
    jp, jts, tp, ts = _pair(jcfg, tcfg)
    rng = np.random.default_rng(10)
    batch = _mb_batch(rng, _traj(rng))
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(jp._loss, has_aux=True))(
        jts.params, jts, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux = tp._loss(ts, {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(loss, jloss)
    for k in jaux:
        _close(aux[k], jaux[k], msg=k)
    assert float(aux["disc_grad_pen"].detach()) > 1e-3 and 0.0 < float(aux["disc_agent_acc"]) < 1.0
    kernels = ts.disc.kernels()
    assert float(torch.sum(kernels[-1].detach() ** 2)) > 0.0
    grads = tp.grads(loss, ts.parameters())
    want = convert._flat_like_torch(ts.model, jax.tree.map(np.asarray, jg), None, ts.disc)
    assert len(grads) == len(want) == len(ts.parameters())
    for g, w in zip(grads, want):
        _close(g, w, GTOL)
    # the discriminator's weights take gradient from the penalty's second derivative
    assert all(float(g.abs().max()) > 0 for g in grads[-6:])


def test_train_iteration_matches_jax(monkeypatch):
    """One minibatch of all T B rows and one mini-epoch (the update does not
    depend on the permutation), the demo fetch and the rollout stubbed, the
    ring one repeated row (the replay draws do not matter), keep-prob 1
    (the insert is a permutation of the rollout's windows)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(11)
    demo = (rng.normal(size=(N, 2 * W)) * 0.7 + 0.8).astype(np.float32)
    jp, jts, tp, ts = _pair(jcfg, tcfg, demo=demo)
    traj = _traj(rng)
    end = dict(obs=(rng.normal(size=(NE, O)) * 2).astype(np.float32),
               last_episode_return=rng.normal(size=NE).astype(np.float32))
    jend = SimpleNamespace(**{k: jnp.asarray(v) for k, v in end.items()}, states=None)
    tend = SimpleNamespace(**{k: torch.as_tensor(v) for k, v in end.items()}, states=None)
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    monkeypatch.setattr(jp, "rollout", lambda ts_, es, key: (jend, jtraj))
    # the stubbed rollout ignores the env state it is given
    jts2, jm = jax.jit(lambda ts_, key: jp.train_iteration(ts_, None, key)[::2])(
        jts, jax.random.key(0))
    monkeypatch.setattr(tp, "rollout", lambda ts_, es: (
        tend, {k: torch.as_tensor(v) for k, v in traj.items()}))
    ts2, _, m = tp.train_iteration(ts, tend)
    assert sorted(m) == sorted(jm)
    for k in jm:
        _close(m[k], jm[k], msg=k)
    for r in ("obs_rms", "value_rms", "amp_rms"):
        for fld in ("mean", "var", "count"):
            _close(getattr(getattr(ts2, r), fld), getattr(getattr(jts2, r), fld), msg=f"{r}.{fld}")
    # amp_rms took the rollout's windows and the demo windows
    assert float(ts2.amp_rms.count) == pytest.approx(float(jts.amp_rms.count) + 2 * N)
    jflat = convert._flat_like_torch(ts2.model, jax.tree.map(np.asarray, jts2.params), None,
                                     ts2.disc)
    for g, w in zip(ts2.parameters(), jflat):
        _close(g, w, GTOL)
    assert (ts2.replay_count, ts2.replay_ptr, ts2.epoch) == \
        (int(jts2.replay_count), int(jts2.replay_ptr), int(jts2.epoch)) == (N, 5, 1)

    def rows(x):
        x = np.asarray(x)
        return x[np.lexsort(x.T[::-1])]

    np.testing.assert_array_equal(rows(ts2.replay), rows(jts2.replay))
    np.testing.assert_array_equal(rows(ts2.replay), rows(traj["amp_obs"].reshape(N, -1)))
