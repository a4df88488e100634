"""Port parity: the PyTorch package's plain physics step (ops/sim.py op
path, the plain version of the fused CUDA kernel) against the JAX package's
op path ``build_step_fn(fused=False)`` on Cartpole, the tiny floating URDF of
tests/test_fused.py, Ant, the pair-capsule scene of tests/test_fused.py
(actor pairs: sphere-capsule and capsule-capsule against a fixed bar) and a
one-body scene held by two attractors (B=4), and against the JAX kernel body run with
``build_fused_step_fn(..., interpret=True)`` on Cartpole, the tiny URDF and
the pair-capsule and attractor scenes (2 substeps).
Identical seeded numpy inputs; tolerances of tests/test_fused.py: q atol=rtol
2e-3, qd atol=rtol 2e-2, net atol 1.0 / rtol 5e-3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.models import load_urdf as jax_load_urdf
from thormang_isaacgym_tpu.models.scene import compose as jax_compose
from thormang_isaacgym_tpu.ops import fused as jax_fused
from thormang_isaacgym_tpu.ops.sim import Controls as JControls
from thormang_isaacgym_tpu.ops.sim import SimParams as JSimParams
from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
from thormang_isaacgym_tpu.tasks.ant import Ant as JAnt
from thormang_isaacgym_tpu.tasks.cartpole import Cartpole as JCartpole
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.ops import fused
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams, build_plain_step_fn, build_step_fn
from thormang_isaacgym_tpu_torch.tasks.ant import Ant
from thormang_isaacgym_tpu_torch.tasks.cartpole import Cartpole

from test_torch_fused import (
    HELD_ATTRACTORS, HELD_URDF, PAIR_SP, TINY_SP, TINY_URDF, pair_capsule_q, pair_capsule_scene,
)

B = 4
ATTRACTORS = {"attractor": HELD_ATTRACTORS}


def _models(name):
    """(jax model, jax sim params, port model, port sim params)."""
    if name == "tiny":
        return (jax_load_urdf(TINY_URDF), JSimParams(**TINY_SP),
                load_urdf(TINY_URDF), SimParams(**TINY_SP))
    if name == "pair_capsule":
        return (pair_capsule_scene(jax_load_urdf, jax_compose), JSimParams(**PAIR_SP),
                pair_capsule_scene(load_urdf, compose), SimParams(**PAIR_SP))
    if name == "attractor":
        return (jax_load_urdf(HELD_URDF), JSimParams(**PAIR_SP), load_urdf(HELD_URDF),
                SimParams(**PAIR_SP))
    jt = {"cartpole": JCartpole, "ant": JAnt}[name](num_envs=B)
    tt = {"cartpole": Cartpole, "ant": Ant}[name](num_envs=B, device="cpu")
    return jt.model, jt.sim_params, tt.model, tt.sim_params


def _inputs(name, model):
    """Seeded numpy (q, qd, target_pos, target_vel, effort, wrench)."""
    rng = np.random.default_rng({"cartpole": 0, "tiny": 1, "ant": 2, "pair_capsule": 3,
                                 "attractor": 4}[name])
    f = np.float32
    if name == "pair_capsule":
        q = pair_capsule_q(rng, B)
        qd = rng.normal(size=(B, model.nv)) * 0.1
        effort = np.zeros((B, 0))
    elif name == "attractor":
        q = np.zeros((B, 7))
        q[:, 0:3] = [0.2, -0.1, 0.5] + rng.normal(size=(B, 3)) * 0.1
        qr = rng.normal(size=(B, 4)) * 0.3 + [1.0, 0.0, 0.0, 0.0]
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        qd = rng.normal(size=(B, 6))
        effort = np.zeros((B, 0))
    elif name == "cartpole":
        q = rng.uniform(-0.5, 0.5, (B, model.nq))
        qd = rng.normal(size=(B, model.nv)) * 0.5
        effort = rng.uniform(-50, 50, (B, model.nj))
    else:
        q = np.zeros((B, model.nq))
        qr = rng.normal(size=(B, 4)) * 0.2 + [1.0, 0.0, 0.0, 0.0]
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        if name == "tiny":
            q[:, 2] = 0.3
            q[:, 7:] = rng.normal(size=(B, model.nj)) * 0.5
            effort = np.zeros((B, model.nj))
        else:
            q[:, 2] = 0.55 + rng.uniform(-0.05, 0.05, B)
            q[:, 7:] = np.array([0.0, 0.5236] * 4) + rng.uniform(0, 0.2, (B, model.nj))
            effort = rng.uniform(-15, 15, (B, model.nj))
        qd = rng.normal(size=(B, model.nv)) * 0.3
    wrench = np.concatenate([rng.normal(size=(B, model.nb, 3)) * 0.05,
                             rng.normal(size=(B, model.nb, 3)) * 0.5], axis=-1)
    tp = rng.normal(size=(B, model.nj)) * 0.1
    return [np.asarray(x, f) for x in (q, qd, tp, np.zeros((B, model.nj)), effort, wrench)]


def _run_jax(step, model, inputs, steps):
    q, qd, tp, tv, eff, w = (jnp.asarray(x) for x in inputs)
    params = model.default_params().batch(B)
    ctrl = JControls(tp, tv, eff)
    for _ in range(steps):
        q, qd, net = step(params, q, qd, ctrl, w)
    return np.asarray(q), np.asarray(qd), np.asarray(net)


def _run_torch(step, model, inputs, steps):
    q, qd, tp, tv, eff, w = (torch.as_tensor(x) for x in inputs)
    params = model.default_params().batch(B)
    ctrl = Controls(tp, tv, eff)
    for _ in range(steps):
        q, qd, net = step(params, q, qd, ctrl, w)
    return q.numpy(), qd.numpy(), net.numpy()


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got[1], want[1], atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got[2], want[2], atol=1.0, rtol=5e-3)


OP_CASES = [("cartpole", 1), ("cartpole", 5), ("tiny", 1), ("tiny", 12), ("ant", 1), ("ant", 3),
            ("pair_capsule", 1), ("pair_capsule", 8), ("attractor", 1), ("attractor", 12)]
KERNEL_CASES = [("cartpole", 5), ("tiny", 12), ("pair_capsule", 8), ("attractor", 12)]


@pytest.fixture(scope="module")
def jax_ref():
    """JAX results for every case, computed once."""
    out = {}
    for name in ("cartpole", "tiny", "ant", "pair_capsule", "attractor"):
        jm, jsp, tm, _ = _models(name)
        inputs = _inputs(name, tm)
        attr = ATTRACTORS.get(name)
        op = jax.jit(jax_build_step_fn(jm, jsp, attractors=attr, fused=False))
        for n, steps in OP_CASES:
            if n == name:
                out[("op", name, steps)] = _run_jax(op, jm, inputs, steps)
        for n, steps in KERNEL_CASES:
            if n == name:
                kern = jax.jit(jax_fused.build_fused_step_fn(jm, jsp, interpret=True,
                                                             attractors=attr or ()))
                out[("kernel", name, steps)] = _run_jax(kern, jm, inputs, steps)
    return out


@pytest.mark.parametrize("name,steps", OP_CASES)
def test_plain_step_matches_jax_op_path(jax_ref, name, steps):
    _, _, tm, tsp = _models(name)
    got = _run_torch(build_plain_step_fn(tm, tsp, attractors=ATTRACTORS.get(name)), tm,
                     _inputs(name, tm), steps)
    _assert_close(got, jax_ref[("op", name, steps)])
    if name == "pair_capsule" and steps > 1:
        assert float(np.abs(got[2][:, 0, :3]).max()) > 1.0     # the ball is in contact


@pytest.mark.parametrize("name,steps", KERNEL_CASES)
def test_plain_step_matches_jax_kernel_body(jax_ref, name, steps):
    _, _, tm, tsp = _models(name)
    # build_step_fn's wrapper takes the plain version for CPU tensors
    got = _run_torch(build_step_fn(tm, tsp, attractors=ATTRACTORS.get(name)), tm,
                     _inputs(name, tm), steps)
    _assert_close(got, jax_ref[("kernel", name, steps)])


@pytest.mark.parametrize("name", ["cartpole", "tiny", "ant", "pair_capsule"])
def test_packed_rows_match_jax_layout(name):
    jm, _, tm, _ = _models(name)
    jrows = jax_fused._make_rows(jm)
    rows = fused.make_rows(tm)
    for f in dataclasses.fields(jrows):
        if f.name in rows:
            assert rows[f.name] == getattr(jrows, f.name), f.name
    assert rows["total"] == jrows.total
    assert {"cartpole": 94, "ant": 330}.get(name, rows["total"]) == rows["total"]


def test_wrapper_masks_torque_to_sensor_bodies():
    _, _, tm, tsp = _models("ant")
    feet = (5, 7)
    step = fused.build_fused_step_fn(tm, tsp, need_torque=feet)
    q, qd, net = _run_torch(step, tm, _inputs("ant", tm), 2)
    full = _run_torch(build_plain_step_fn(tm, tsp), tm, _inputs("ant", tm), 2)
    np.testing.assert_array_equal(net[..., :3], full[2][..., :3])
    np.testing.assert_array_equal(net[:, feet, 3:], full[2][:, feet, 3:])
    others = [b for b in range(tm.nb) if b not in feet]
    assert not net[:, others, 3:].any()
    assert step.launches == 0            # CPU tensors never launch the kernel
    assert step.out_rows == tm.nq + tm.nv + 3 * tm.nb + 3 * len(feet)


def test_unported_features_raise():
    from thormang_isaacgym_tpu_torch.engine.terrain import Heightfield
    from thormang_isaacgym_tpu_torch.ops.sim import check_supported
    _, _, tm, tsp = _models("tiny")
    # a Heightfield ground is ported: it builds and steps (a callable does not)
    hf = Heightfield(np.full((16, 16), 0.1, np.float32), 0.25, origin=(-2.0, -2.0))
    assert check_supported(tm, ground=hf) is hf
    q, qd, net = _run_torch(build_step_fn(tm, tsp, ground_height_fn=hf), tm, _inputs("tiny", tm), 2)
    assert np.isfinite(q).all() and np.isfinite(qd).all() and np.isfinite(net).all()
    with pytest.raises(NotImplementedError):
        check_supported(tm, ground=lambda x, y: 0 * x)
    # attractors and round actor pairs are ported: they build (box-kind pairs
    # raise: tests/test_torch_collide.py)
    attr = ((0, (0, 0, 0), (0, 0, 1), 1.0, 1.0),)
    assert check_supported(tm, attractors=attr) == 0.0
    assert build_step_fn(tm, tsp, attractors=attr).pair_mode
    with pytest.raises(ValueError):
        check_supported(tm, attractors=((0, (0, 0, 0), (0, 0, 1)),))
    # fixed tendons are ported: a tendon model builds, with its tendon table;
    # a tendon whose coefficients do not cover the joints raises
    tendon = dataclasses.replace(tm, tendons=(((1.0,), -1.0, 1.0, "t"),))
    assert check_supported(tendon) == 0.0
    assert build_step_fn(tendon, tsp)._tables[0][42] == 1
    with pytest.raises(ValueError):
        check_supported(dataclasses.replace(tm, tendons=(((1.0, 1.0), -1.0, 1.0, "t"),)))
