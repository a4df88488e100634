"""Port parity for tasks/ingenuity.py and tasks/quadcopter.py (the kernel's
flat instance: Ingenuity one jointless body with box-corner and rotor-rim
ground candidates, Quadcopter 9 bodies and 8 position-driven joints).

- ``make`` with each cfg/task YAML: the model equal to JAX's, exactly; the
  YAML's dt and substeps; the flat instance's shared layout. Ingenuity flies
  under Mars gravity (0, 0, -3.721) in its sim parameters and its model
  parameters whatever its YAML says (-9.81), as the reference sets it in
  code. The JAX class holds -3.721 in its sim parameters only: its model
  parameters, which its physics reads, keep -9.81 (ROADMAP C).
- ``pre_physics`` (the controls, and the wrench: thrust forces, and at
  Ingenuity's rotor sites their torques r x f) atol 1e-5 / rtol 1e-6, and
  ``post_physics`` (obs atol 1e-5 / rtol 1e-5, reward atol 1e-5 / rtol
  1e-5, done exactly) against JAX on identical states. Ingenuity's target
  resampling (every 500 steps) draws from each package's own stream: the
  envs it resamples are compared for their pattern and range, the others
  for their values.
- One control step of the port's plain step (the kernel's plain version)
  against the JAX op path ``build_step_fn(fused=False)`` at B = 4, from
  JAX-sampled reset states and from states near the ground, the controls and
  wrench of both tasks' ``pre_physics`` on the same seeded actions, and the
  same model parameters (Ingenuity's with Mars gravity in both): q atol=rtol
  2e-3, qd 2e-2, net atol 1.0 / rtol 5e-3 (tests/test_fused.py's).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.ops import contact
from thormang_isaacgym_tpu_torch.ops.sim import build_plain_step_fn
from thormang_isaacgym_tpu_torch.tasks.ingenuity import IngenuityTaskState
from thormang_isaacgym_tpu_torch.tasks.quadcopter import QuadTaskState

from test_torch_fused import DRONE_Z, drone_contact_q
from test_torch_hands import _same_model

B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("Ingenuity", "Quadcopter")


def _yaml(name):
    with open(os.path.join(ROOT, "cfg", "task", f"{name}.yaml")) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module", params=TASKS)
def envs(request):
    name = request.param
    cfg = _yaml(name)
    return name, tgx.make(name, num_envs=B, seed=0, cfg=cfg), \
        tgt.make(name, num_envs=B, seed=0, cfg=cfg, device="cpu")


def _jax_resets(jt, seed):
    task0 = jax.tree.map(lambda x: x[0], jt.default_task_state(jax.random.key(0)))
    out = [jt.reset_fn(k, jt.model.default_params(), task0)
           for k in jax.random.split(jax.random.key(seed), B)]
    return (np.stack([np.asarray(r[0]) for r in out]).astype(np.float32),
            np.stack([np.asarray(r[1]) for r in out]).astype(np.float32),
            jax.tree.map(lambda *x: np.stack(x), *[r[3] for r in out]))


def _task_state(name, jtask):
    cls = IngenuityTaskState if name == "Ingenuity" else QuadTaskState
    return cls(**{f.name: torch.as_tensor(np.asarray(getattr(jtask, f.name), np.float32))
                  for f in dataclasses.fields(cls)})


def test_make_with_its_yaml(envs):
    name, jenv, env = envs
    m, jm = env.task.model, jenv.task.model
    _same_model(m, dataclasses.replace(jm, _defaults={
        **jm._defaults, "gravity": m._defaults["gravity"]}) if name == "Ingenuity" else jm)
    sp = env.task.sim_params
    assert (sp.dt, sp.substeps, env.task.dt) == (0.01, 2, 0.01)
    assert (env.num_obs, env.num_actions) == (jenv.num_obs, jenv.num_actions)
    assert env.task.clip_obs == jenv.task.clip_obs == 5.0
    step = env.physics_step
    assert step.pair_mode == 0 and step.hf is None and step.layout == "shared"
    cand = contact.candidates(m)
    if name == "Ingenuity":
        assert (m.nb, m.nj, m.nq, len(cand["geom"]), int(np.sum(cand["rim"]))) == (1, 0, 7, 12, 4)
    else:
        assert (m.nb, m.nj, len(cand["geom"])) == (9, 8, 14)
        np.testing.assert_array_equal(env.task.ref_dof_order, jenv.task.ref_dof_order)
        np.testing.assert_array_equal(env.task.rotor_bodies, jenv.task.rotor_bodies)


def test_ingenuity_flies_under_mars_gravity_from_its_yaml():
    cfg = _yaml("Ingenuity")
    assert cfg["sim"]["gravity"] == [0.0, 0.0, -9.81]
    env = tgt.make("Ingenuity", num_envs=B, seed=0, cfg=cfg, device="cpu")
    mars = (0.0, 0.0, -3.721)
    assert env.task.sim_params.gravity == mars
    np.testing.assert_allclose(env.reset(0).params.gravity.numpy(), np.tile(mars, (B, 1)), rtol=1e-7)
    jenv = tgx.make("Ingenuity", num_envs=B, seed=0, cfg=cfg)
    assert jenv.task.sim_params.gravity == mars
    # the JAX class's model parameters keep Earth's gravity (ROADMAP C)
    assert float(jenv.task.model.default_params().gravity[2]) == pytest.approx(-9.81)
    # 20 zero-thrust steps from the same spawn: the port falls at Mars's rate
    s = env.reset(0)
    z0 = s.q[:, 2].clone()
    for _ in range(20):
        s = env.step(s, torch.zeros(B, 6))
    np.testing.assert_allclose((z0 - s.q[:, 2]).numpy(), 0.5 * 3.721 * 0.2 ** 2, rtol=0.06)


def _states(name, jenv, env):
    """A JAX and a port EnvState on the same seeded physical state."""
    jt = jenv.task
    rng = np.random.default_rng(1)
    q, qd, jtask = _jax_resets(jt, 2)
    q[1:3] = drone_contact_q(jt.model, rng, 2, DRONE_Z[name])
    qd = qd + rng.normal(size=qd.shape).astype(np.float32)
    if name == "Quadcopter":
        jtask = dataclasses.replace(jtask, thrusts=rng.uniform(0, 2, (B, 4)).astype(np.float32))
    progress = np.array([3, 500, 499, 1000])                 # envs 1 and 3 resample a target
    js = jenv.init_fn(jax.random.key(0))
    js = dataclasses.replace(js, q=jnp.asarray(q), qd=jnp.asarray(qd), progress=jnp.asarray(progress),
                             task=jax.tree.map(jnp.asarray, jtask))
    ts = dataclasses.replace(env.init_fn(0), q=torch.as_tensor(q), qd=torch.as_tensor(qd),
                             progress=torch.as_tensor(progress), task=_task_state(name, jtask))
    return js, ts


def test_pre_and_post_physics_match_jax(envs):
    name, jenv, env = envs
    jt, tt = jenv.task, env.task
    js, ts = _states(name, jenv, env)
    a = np.random.default_rng(3).uniform(-1.0, 1.0, (B, env.num_actions)).astype(np.float32)
    jctrl, jw, jtask = jt.pre_physics(js, jnp.asarray(a))
    tctrl, tw, ttask = tt.pre_physics(ts, torch.as_tensor(a))
    for g, w in ((tctrl.target_pos, jctrl.target_pos), (tctrl.effort, jctrl.effort), (tw, jw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-6)
    assert float(tw[..., 3:6].abs().max()) > 0.1                  # thrust forces
    if name == "Ingenuity":
        assert float(tw[..., 0:3].abs().max()) > 1e-3             # and their torques
    else:
        np.testing.assert_allclose(ttask.thrusts.numpy(), np.asarray(jtask.thrusts), atol=1e-6)
        assert (tw[:, tt.rotor_bodies, 3:6].abs().amax(-1) > 0).float().mean() > 0.5
    jobs, jrew, jdone, jnext, jmetrics = jt.post_physics(js, js.task)
    obs, rew, done, nxt, metrics = tt.post_physics(ts, ts.task)
    keep = np.ones(B, bool)
    if name == "Ingenuity":
        keep[[1, 3]] = False                                    # resampled from each stream
        new = nxt.target[~torch.as_tensor(keep)]
        assert not torch.equal(new, ts.task.target[~torch.as_tensor(keep)])
        assert bool(((new[:, :2].abs() <= 5) & (new[:, 2] >= 1) & (new[:, 2] <= 2)).all())
        np.testing.assert_array_equal(nxt.target[keep].numpy(), np.asarray(jnext.target)[keep])
    np.testing.assert_allclose(obs[keep].numpy(), np.asarray(jobs)[keep], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rew[keep].numpy(), np.asarray(jrew)[keep], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(done[keep].numpy(), np.asarray(jdone)[keep])
    np.testing.assert_allclose(metrics["target_dist"][keep].numpy(),
                               np.asarray(jmetrics["target_dist"])[keep], atol=1e-5, rtol=1e-5)


def test_op_path_step_matches_jax(envs):
    name, jenv, env = envs
    jt, tt = jenv.task, env.task
    jm, tm = jt.model, tt.model
    js, ts = _states(name, jenv, env)
    a = np.random.default_rng(4).uniform(-1.0, 1.0, (B, env.num_actions)).astype(np.float32)
    jctrl, jw, _ = jt.pre_physics(js, jnp.asarray(a))
    tctrl, tw, _ = tt.pre_physics(ts, torch.as_tensor(a))
    tparams = tm.default_params().batch(B)
    # the same model parameters in both: the port's (Ingenuity's Mars gravity)
    jparams = dataclasses.replace(jm.default_params().batch(B),
                                  gravity=jnp.asarray(tparams.gravity.numpy()))
    jstep = jax.jit(jax_build_step_fn(jm, jt.sim_params, fused=False))
    step = build_plain_step_fn(tm, tt.sim_params)
    jq, jqd, jnet = jstep(jparams, js.q, js.qd, jctrl, jw)
    tq, tqd, tnet = step(tparams, ts.q, ts.qd, tctrl, tw)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=2e-2, rtol=2e-2)
    jnet = np.asarray(jnet)
    np.testing.assert_allclose(tnet[..., :jnet.shape[-1]].numpy(), jnet, atol=1.0, rtol=5e-3)
    assert float(tnet[1:3, :, 2].abs().sum(-1).min()) > 0.0    # the near-ground envs touch
