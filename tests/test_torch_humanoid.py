"""Port parity for tasks/humanoid.py (HumanoidMJCF, the nv_humanoid MJCF: 22
bodies, 21 DOFs, nine near-massless chain links).

- obs 110, act 21, the feet and their torque rows as in JAX.
- ``post_physics`` on a JAX state carried across: obs atol 1e-4 / rtol 1e-5,
  reward atol 1e-2 (the progress term is a difference of two ~6e4
  potentials, whose float32 ulp is 4e-3), done exactly.
- One control step of the port's plain step against the JAX op path
  ``build_step_fn(fused=False)`` at B = 4, with the JAX task's dt 0.0166 s
  and 4 substeps, from JAX-sampled reset states and from states with the
  feet on the ground (after 10 zero-action steps), efforts from seeded actions through both
  tasks' ``pre_physics``: q atol=rtol 2e-3, qd 2e-2, net atol 1.0 / rtol
  5e-3 (tests/test_fused.py's tolerances). The JAX op path is jitted once.
- ``make`` with cfg/task/Humanoid.yaml: dt 0.0166 s with the YAML's 2
  substeps (the JAX make keeps the class's 4: a deliberate divergence), and
  the same env-block keys warned about as JAX's ``make``.
- 10 zero-action steps from the reset keep the torso above 0.8 m.
- ``Humanoid`` (THORMANG) raises FileNotFoundError without its URDF, as JAX.
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
from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.ops.sim import build_plain_step_fn
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.tasks import humanoid as thum

B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    with open(os.path.join(ROOT, "cfg", "task", "Humanoid.yaml")) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def envs():
    return (tgx.make("HumanoidMJCF", num_envs=B, seed=0),
            tgt.make("HumanoidMJCF", num_envs=B, seed=0, device="cpu"))


def test_spaces_and_feet(envs):
    jenv, env = envs
    assert (env.num_obs, env.num_actions) == (jenv.num_obs, jenv.num_actions) == (110, 21)
    assert env.task.feet == list(jenv.task.feet)
    assert env.task.net_torque_bodies == tuple(jenv.task.net_torque_bodies)
    np.testing.assert_array_equal(env.task.motor_efforts.numpy(), np.asarray(jenv.task.motor_efforts))
    assert env.task.spawn_z == pytest.approx(jenv.task.spawn_z, abs=1e-6)


def _jax_resets(jt, n, seed):
    """n JAX-sampled reset states (q, qd, task) of the JAX task."""
    task0 = jax.tree.map(lambda x: x[0], jt.default_task_state(jax.random.key(0)))
    out = [jt.reset_fn(k, jt.model.default_params(), task0)
           for k in jax.random.split(jax.random.key(seed), n)]
    return (np.stack([np.asarray(r[0]) for r in out]).astype(np.float32),
            np.stack([np.asarray(r[1]) for r in out]).astype(np.float32),
            jax.tree.map(lambda *x: jnp.stack(x), *[r[3] for r in out]))


def test_post_physics_matches_jax(envs):
    jenv, env = envs
    jt, tt = jenv.task, env.task
    rng = np.random.default_rng(0)
    q, qd, _ = _jax_resets(jt, B, 1)
    q[:, 0:2] = rng.uniform(-1, 1, (B, 2))
    q[:, 2] = [1.3, 0.7, 1.1, 0.9]                   # env 1 below the termination height
    qr = rng.normal(size=(B, 4)) * 0.3 + [1, 0, 0, 0]
    q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
    qd = qd + rng.normal(size=qd.shape).astype(np.float32)
    net = rng.normal(size=(B, tt.model.nb, 3)) * 50
    torque = rng.normal(size=(B, tt.model.nb, 3)) * 5
    pot = -np.linalg.norm([1000.0, 0] - q[:, 0:2], axis=1) / tt.dt + rng.normal(size=B)
    fields = dict(potentials=pot, prev_potentials=pot - 1.0,
                  actions=rng.uniform(-1, 1, (B, 21)), applied_torque=rng.normal(size=(B, 21)) * 50)
    fields = {k: np.asarray(v, np.float32) for k, v in fields.items()}
    js = jenv.init_fn(jax.random.key(0))
    js = dataclasses.replace(
        js, q=jnp.asarray(q), qd=jnp.asarray(qd), net_contact=jnp.asarray(net, jnp.float32),
        net_torque=jnp.asarray(torque, jnp.float32),
        task=dataclasses.replace(js.task, **{k: jnp.asarray(v) for k, v in fields.items()}))
    ts = env.init_fn(0)
    ts = dataclasses.replace(
        ts, q=torch.as_tensor(q), qd=torch.as_tensor(qd),
        net_contact=torch.as_tensor(net, dtype=torch.float32),
        net_torque=torch.as_tensor(torque, dtype=torch.float32),
        task=convert.humanoid_task_state(js.task))
    jobs, jrew, jdone, jtask, jmetrics = jt.post_physics(js, js.task)
    obs, rew, done, task, metrics = tt.post_physics(ts, ts.task)
    assert tuple(obs.shape) == (B, 110)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-2, rtol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done.numpy().tolist() == [0.0, 1.0, 0.0, 0.0]
    np.testing.assert_allclose(task.potentials.numpy(), np.asarray(jtask.potentials), rtol=1e-6)
    np.testing.assert_allclose(metrics["up_proj"].numpy(), np.asarray(jmetrics["up_proj"]), atol=1e-6)


def test_op_path_step_matches_jax(envs):
    jenv, env = envs
    jt, tt = jenv.task, env.task
    jm, tm = jt.model, tt.model
    assert (tt.sim_params.dt, tt.sim_params.substeps) == (jt.sim_params.dt, jt.sim_params.substeps) \
        == (0.0166, 4)
    q, qd, jtask = _jax_resets(jt, B, 3)
    # envs 2-3: the port's state after 10 zero-action steps from its reset,
    # the body settling onto its feet (a few hundred N on the ground)
    settled = env.reset(0)
    for _ in range(10):
        settled = env.step(settled, torch.zeros(B, 21))
    q[2:], qd[2:] = settled.q[2:].numpy(), settled.qd[2:].numpy()
    a = np.random.default_rng(4).uniform(-1.0, 1.0, (B, 21)).astype(np.float32)
    js = dataclasses.replace(jenv.init_fn(jax.random.key(0)), task=jtask)
    ts = dataclasses.replace(env.init_fn(0), task=convert.humanoid_task_state(jtask))
    jctrl, jw, _ = jt.pre_physics(js, jnp.asarray(a))
    tctrl, tw, ttask = tt.pre_physics(ts, torch.as_tensor(a))
    np.testing.assert_allclose(tctrl.effort.numpy(), np.asarray(jctrl.effort), atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(ttask.applied_torque.numpy(), tctrl.effort.numpy())
    jstep = jax.jit(jax_build_step_fn(jm, jt.sim_params, fused=False,
                                      need_torque=jt.net_torque_bodies))
    step = build_plain_step_fn(tm, tt.sim_params)
    jq, jqd, jnet = jstep(jm.default_params().batch(B), jnp.asarray(q), jnp.asarray(qd), jctrl,
                          jnp.zeros((B, jm.nb, 6)))
    tq, tqd, tnet = step(tm.default_params().batch(B), torch.as_tensor(q), torch.as_tensor(qd),
                         tctrl, tw)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=2e-2, rtol=2e-2)
    jnet = np.asarray(jnet)
    np.testing.assert_allclose(tnet[..., :jnet.shape[-1]].numpy(), jnet, atol=1.0, rtol=5e-3)
    assert float(tnet[2:, :, 2].sum(-1).min()) > 50.0   # the ground pushes on the settled envs


def test_make_with_humanoid_yaml_warns_like_jax():
    cfg = _cfg()

    def warned(fn):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            env = fn()
        return env, sorted(str(w.message).split("'")[1] for w in rec
                           if "matches no attribute" in str(w.message))

    jenv, jkeys = warned(lambda: tgx.make("HumanoidMJCF", num_envs=2, seed=0, cfg=cfg))
    env, keys = warned(lambda: tgt.make("HumanoidMJCF", num_envs=2, seed=0, cfg=cfg, device="cpu"))
    assert keys == jkeys and "actionsCost" in keys
    sp = env.task.sim_params
    assert (sp.dt, sp.substeps) == (0.0166, 2) and env.task.dt == 0.0166
    assert jenv.task.sim_params.substeps == 4         # ROADMAP C: the YAML's substeps, not the class's
    for attr in ("death_cost", "termination_height", "power_scale", "up_weight", "heading_weight",
                 "max_episode_length", "clip_actions"):
        assert getattr(env.task, attr) == getattr(jenv.task, attr), attr
    assert env.physics_step.pair_mode == 0 and env.physics_step.layout == "split"


def test_zero_actions_keep_standing():
    env = tgt.make("HumanoidMJCF", num_envs=2, seed=0, cfg=_cfg(), device="cpu")
    state = env.reset(0)
    for _ in range(10):
        state = env.step(state, torch.zeros(2, 21))
    assert bool((state.q[:, 2] > 0.8).all())
    assert bool(torch.isfinite(state.obs).all()) and state.done.sum() == 0


def test_thormang_humanoid_needs_its_urdf(tmp_path):
    missing = str(tmp_path / "thormang3.urdf")
    with pytest.raises(FileNotFoundError, match="thormang asset not found"):
        thum.Humanoid(num_envs=2, device="cpu", asset_path=missing)
    if not os.path.exists(thum.REF_THORMANG):
        with pytest.raises(FileNotFoundError):
            tgt.make("Humanoid", num_envs=2, device="cpu")
