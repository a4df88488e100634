"""Port parity for fixed tendons (block B4b of the TPU kernel).

- ``ops/dynamics.passive_forces`` with ShadowHand's four tendons (each holds
  q_J0 - q_J1 in [-0.05, 0.05]) against JAX ``passive_forces`` on joint
  states whose every coupled length lies below, inside or above its bounds:
  tau and diag atol=rtol 1e-6.
- The two-link tendon scene of tests/test_fused.py (one tendon q1 - q2 in
  [-0.05, 0.05], stiffness 25, damping 0.2; B = 8, coupled lengths on both
  sides of each bound and inside): the port's plain step against the JAX op
  path ``build_step_fn(fused=False)`` over 10 control steps (q atol=rtol
  2e-3, qd 2e-2, net atol 1.0 / rtol 5e-3, the tolerances of
  tests/test_fused.py), and the CUDA kernel's source built as host C++
  (``host_kernel``) against the JAX kernel body
  (``build_fused_step_fn(interpret=True)``), 20 control steps free running
  from the same state: q atol 1e-6, qd atol 1e-4 (rtol 1e-4). The tendon
  spring acts in some envs and not in others at every step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.models import load_urdf as jax_load_urdf
from thormang_isaacgym_tpu.models import shadow_hand as jshadow
from thormang_isaacgym_tpu.ops import dynamics as jax_dyn
from thormang_isaacgym_tpu.ops import fused as jax_fused
from thormang_isaacgym_tpu.ops.sim import SimParams as JSimParams
from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
from thormang_isaacgym_tpu.ops.sim import zero_controls as jax_zero_controls
from thormang_isaacgym_tpu_torch.models import load_urdf, load_shadow_hand
from thormang_isaacgym_tpu_torch.ops import dynamics as dyn
from thormang_isaacgym_tpu_torch.ops import fused
from thormang_isaacgym_tpu_torch.ops.sim import SimParams, build_plain_step_fn, zero_controls

from test_torch_fused import (  # noqa: F401  (host_kernel: a fixture)
    TENDON_SP, _host_call, host_kernel, tendon_length, tendon_q, tendon_scene,
)

B = 8


def _sides(model, jq) -> tuple:
    """The share of env-tendons below and above their bounds at jq (n, nj)."""
    L = tendon_length(model, jq)
    lo, hi = (np.array([t[k] for t in model.tendons]) for k in (1, 2))
    return float((L < lo).mean()), float((L > hi).mean())


@pytest.mark.parametrize("side", ["below", "inside", "above"])
def test_passive_forces_with_tendons_match_jax(side):
    jm, tm = jshadow.load_shadow_hand(), load_shadow_hand()
    assert tm.tendons == jm.tendons and len(tm.tendons) == 4
    rng = np.random.default_rng({"below": 0, "inside": 1, "above": 2}[side])
    lo, hi = np.asarray(tm._defaults["dof_lower"]), np.asarray(tm._defaults["dof_upper"])
    jq = lo + (hi - lo) * rng.uniform(0.2, 0.8, (16, tm.nj))
    off = {"below": (-0.3, -0.06), "inside": (-0.04, 0.04), "above": (0.06, 0.3)}[side]
    for coef, *_ in tm.tendons:
        j1, j0 = (int(j) for j in np.flatnonzero(np.asarray(coef)))
        jq[:, j0] = jq[:, j1] + rng.uniform(*off, 16)
    jq = jq.astype(np.float32)
    assert _sides(tm, jq) == {"below": (1.0, 0.0), "inside": (0.0, 0.0), "above": (0.0, 1.0)}[side]
    jqd = (rng.normal(size=(16, tm.nj)) * 2.0).astype(np.float32)
    h = 1.0 / 120.0
    jparams, tparams = jm.default_params().batch(16), tm.default_params().batch(16)
    jtau, jdiag = jax.vmap(lambda p, q, qd: jax_dyn.passive_forces(p, q, qd, h, tendons=jm.tendons))(
        jparams, jnp.asarray(jq), jnp.asarray(jqd))
    tau, diag = dyn.passive_forces(tparams, torch.as_tensor(jq), torch.as_tensor(jqd), h,
                                   tendons=tm.tendons)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(diag.numpy(), np.asarray(jdiag), atol=1e-6, rtol=1e-6)
    # the block is felt where a tendon is in violation, and only its damper inside
    plain_tau, plain_diag = dyn.passive_forces(tparams, torch.as_tensor(jq), torch.as_tensor(jqd), h)
    jt = [int(j) for coef, *_ in tm.tendons for j in np.flatnonzero(np.asarray(coef))]
    gain = float((diag - plain_diag)[:, jt].min())
    if side == "inside":
        np.testing.assert_allclose(gain, h * 0.1, rtol=1e-5)       # h d
    else:
        assert gain > h * h * 30.0                                  # + h^2 k
    others = [j for j in range(tm.nj) if j not in jt]
    torch.testing.assert_close(tau[:, others], plain_tau[:, others], rtol=0, atol=0)


def _two_link_inputs(model, n):
    rng = np.random.default_rng(5)
    q = tendon_q(rng, n).astype(np.float32)
    qd = (rng.normal(size=(n, model.nv)) * 1.0).astype(np.float32)
    return q, qd


def test_two_link_plain_step_matches_jax_op_path():
    jm, tm = tendon_scene(jax_load_urdf), tendon_scene(load_urdf)
    jstep = jax.jit(jax_build_step_fn(jm, JSimParams(**TENDON_SP), fused=False))
    step = build_plain_step_fn(tm, SimParams(**TENDON_SP))
    q, qd = _two_link_inputs(tm, B)
    jq, jqd, tq, tqd = jnp.asarray(q), jnp.asarray(qd), torch.as_tensor(q), torch.as_tensor(qd)
    jp, jc, jw = jm.default_params().batch(B), jax_zero_controls(jm, B), jnp.zeros((B, jm.nb, 6))
    tp, tc, tw = tm.default_params().batch(B), zero_controls(tm, B), torch.zeros(B, tm.nb, 6)
    for _ in range(10):
        below, above = _sides(tm, tq.numpy())
        assert 0.0 < below + above < 1.0              # active in some envs, not in others
        jq, jqd, jnet = jstep(jp, jq, jqd, jc, jw)
        tq, tqd, tnet = step(tp, tq, tqd, tc, tw)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(tnet.numpy(), np.asarray(jnet), atol=1.0, rtol=5e-3)
    # the springs pull the coupled length toward its band (tests/test_fused.py's check)
    assert np.abs(tendon_length(tm, tq.numpy())).max() < np.abs(tendon_length(tm, q)).max()


def test_two_link_kernel_source_matches_jax_kernel_body(host_kernel):
    """The kernel's B4b (host C++) against the TPU kernel's body in interpret
    mode, both free running from the same state for 20 control steps."""
    jm, tm = tendon_scene(jax_load_urdf), tendon_scene(load_urdf)
    jstep = jax.jit(jax_fused.build_fused_step_fn(jm, JSimParams(**TENDON_SP), interpret=True))
    step = fused.build_fused_step_fn(tm, SimParams(**TENDON_SP))
    assert step.pair_mode == 0 and step.rows["tstiff"] == jax_fused._make_rows(jm).tstiff
    q, qd = _two_link_inputs(tm, B)
    jq, jqd, tq, tqd = jnp.asarray(q), jnp.asarray(qd), torch.as_tensor(q), torch.as_tensor(qd)
    jp, jc, jw = jm.default_params().batch(B), jax_zero_controls(jm, B), jnp.zeros((B, jm.nb, 6))
    tp, tc, tw = tm.default_params().batch(B), zero_controls(tm, B), torch.zeros(B, tm.nb, 6)
    for _ in range(20):
        below, above = _sides(tm, tq.numpy())
        assert 0.0 < below + above < 1.0              # active in some envs, not in others
        jq, jqd, _ = jstep(jp, jq, jqd, jc, jw)
        tq, tqd, _ = _host_call(host_kernel, step, tp, tq, tqd, tc, tw)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=1e-4, rtol=1e-4)


def test_tendon_rows_and_table():
    """The slab's tendon rows follow _make_rows; the kernel's tendon table
    holds each tendon's nonzero terms in ascending joint order and its
    bounds, the count and the stiffness row in header ints 42-43."""
    jm, tm = jshadow.load_shadow_hand(), load_shadow_hand()
    jrows, rows = jax_fused._make_rows(jm), fused.make_rows(tm)
    for f in dataclasses.fields(jrows):
        assert rows[f.name] == getattr(jrows, f.name), f.name
    step = fused.build_fused_step_fn(tm, SimParams())
    mi, mf = step._tables
    nt = len(tm.tendons)
    assert (mi[42], mi[43]) == (nt, rows["tstiff"]) and rows["tdamp"] == rows["tstiff"] + nt
    start, joints = mi[-(nt + 1 + 2 * nt):-2 * nt], mi[-2 * nt:]
    assert start.tolist() == [0, 2, 4, 6, 8]
    coefs = mf[-2 * nt:]
    for k, (coef, lo, hi, _) in enumerate(tm.tendons):
        nz = np.flatnonzero(np.asarray(coef))
        assert joints[2 * k:2 * k + 2].tolist() == nz.tolist()
        assert coefs[2 * k:2 * k + 2].tolist() == np.asarray(coef)[nz].tolist() == [-1.0, 1.0]
        assert mf[-4 * nt + 2 * k:-4 * nt + 2 * k + 2].tolist() == [np.float32(lo), np.float32(hi)]
    n = 4                                            # the per-env rows of the packed slab
    params = dataclasses.replace(tm.default_params().batch(n),
                                 tendon_stiffness=torch.arange(n * nt, dtype=torch.float32).reshape(n, nt),
                                 tendon_damping=-torch.ones(n, nt))
    packed = step.pack(params, torch.zeros(n, tm.nq), torch.zeros(n, tm.nv), zero_controls(tm, n),
                       torch.zeros(n, tm.nb, 6))
    torch.testing.assert_close(packed[rows["tstiff"]:rows["tdamp"]], params.tendon_stiffness.t())
    torch.testing.assert_close(packed[rows["tdamp"]:rows["total"]], -torch.ones(nt, n))
