"""The port's twins of the JAX package's top-level tools, held against them.

- ``scripts/record_parity_torch.py``: its ``SPECS``, ``TPU_SPECS`` and
  ``DRAWDOWN_FRAC`` equal those of ``scripts/record_parity.py`` (imported
  as a module: it imports jax only inside its ``main``), and its ``passes``
  gives the verdict of JAX's own pass rule, the lines of JAX's ``main``
  executed on the same hand-made curves: rising, falling, a drawdown, flat,
  below the floor, a falling metric (``direction`` -1). A row whose asset is
  missing is recorded as skipped; ``--seeds`` keeps every seed's run.
- ``scripts/eval_factory_lift_torch.py``: the yaw, its wrap into the square
  nut's quarter turn, the align action and the success rule against JAX's
  formulas on identical arrays (atol 1e-5 on angles and actions: float32
  trigonometry; the success rule exactly). The gripper's target read at
  every step: the task's controls (``pre_physics``, called by every step)
  after ``_gripper_target`` is set to 0 are, bit for bit, those of a second
  env built with the target 0, as JAX's script builds it, and differ from
  the open gripper's; the
  controller's torques with the target 0 equal JAX's ``compute_dof_torque``
  (atol 2e-3, rtol 1e-3, tests/test_torch_factory.py's torque tolerance). One
  CPU run at 4 envs from the JAX Pick checkpoint, one step of reach and of
  lift (the gripper's target flipped to 0), prints JAX's keys.
- ``scripts/record_scaling_torch.py``: 1 and 2 gloo ranks on the CPU,
  Cartpole at 64 envs in all, two timed blocks of one iteration: the
  record's schema, the ranks' replicas equal, the median block's seconds,
  t1 / tN and the env-steps/s from them, and each rank's seconds in
  ``PPO.reduce`` inside its iteration.
"""
import dataclasses
import json
import math
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.core import quat as jquat
from thormang_isaacgym_tpu.ops import control as jcontrol
from thormang_isaacgym_tpu.tasks import factory as jfactory
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.ops import control as tcontrol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs", "factory_pick_r5b", "nn", "last.ckpt")
TASK = "FactoryTaskNutBoltPick"


sys.path.append(os.path.join(ROOT, "scripts"))


@pytest.fixture(scope="module")
def parity():
    import record_parity
    import record_parity_torch
    return record_parity_torch, record_parity


def test_parity_specs_are_jax(parity):
    tw, jx = parity
    assert tw.SPECS == jx.SPECS and tw.TPU_SPECS == jx.TPU_SPECS
    assert tw.DRAWDOWN_FRAC == jx.DRAWDOWN_FRAC == 0.4


def _jax_rule():
    """The lines of scripts/record_parity.py's main that judge a row, from
    ``s_last, s_first, s_floor = ...`` to ``passed = ...``, as a function
    of (curve, floor, sgn)."""
    lines = open(os.path.join(ROOT, "scripts", "record_parity.py")).read().splitlines()
    a = next(i for i, s in enumerate(lines) if "s_last, s_first, s_floor =" in s)
    b = next(i for i, s in enumerate(lines) if "passed = bool(" in s)
    body = textwrap.dedent("\n".join(lines[a:b + 1]))

    def rule(curve, floor, sgn):
        ns = dict(curve=curve, floor=floor, sgn=sgn, last=curve[-1][1], first=curve[0][1],
                  DRAWDOWN_FRAC=0.4)
        exec(body, ns)
        return ns["passed"], ns["peak"]
    return rule


CURVES = {
    "rising": ([0.1, 0.4, 0.8, 0.9], 0.75, 1),
    "falling": ([0.9, 0.6, 0.3, 0.2], 0.75, 1),
    "drawdown": ([0.1, 2.0, 0.7, 0.76], 0.75, 1),
    "kept_peak": ([0.1, 1.5, 0.9, 0.8], 0.75, 1),
    "flat": ([0.8, 0.8, 0.8], 0.75, 1),
    "below_floor": ([0.1, 0.3, 0.5], 0.75, 1),
    "negative": ([-0.5, -0.3, -0.1], -0.2, 1),
    "dist_falls": ([0.51, 0.45, 0.35, 0.30], 0.42, -1),
    "dist_above_floor": ([0.51, 0.48, 0.44], 0.42, -1),
    "dist_rises": ([0.30, 0.35, 0.40], 0.42, -1),
}


@pytest.mark.parametrize("case", sorted(CURVES))
def test_pass_rule_is_jax(parity, case):
    values, floor, sgn = CURVES[case]
    curve = [(5 * i, v) for i, v in enumerate(values)]
    passed, peak = _jax_rule()(curve, floor, sgn)
    got = parity[0].passes(curve, floor, sgn)
    assert (got["passed"], got["peak"], got["last"], got["first"]) == \
        (passed, peak, values[-1], values[0])
    assert case not in ("rising", "kept_peak", "dist_falls") or got["passed"]


def test_seeds_record_each_run_beside_the_first(parity, tmp_path, monkeypatch):
    """``--seeds``: the row is the first seed's run; every run's verdict
    and curve stand under ``seed_runs``, in the seeds' order."""
    tw = parity[0]
    calls = []

    def fake_row(spec, device, lane, seed):
        calls.append((spec[0], lane, seed))
        curve = [(0, 0.1), (5, seed / 10)]
        return dict(seed=seed, curve=curve, wall_s=1.0, **tw.passes(curve, 0.5, 1))
    monkeypatch.setattr(tw, "run_row", fake_row)
    out = tw.main(["--card", "--only", "AllegroHand", "--seeds", "7,1,2", "--device", "cpu",
                   "--out", str(tmp_path / "p.json")])
    assert calls == [("AllegroHand", "card", s) for s in (7, 1, 2)]
    row = out["lanes"]["card"]["AllegroHand"]
    assert row["seed"] == 7 and row["passed"] is True and row["run"]["device"] == "cpu"
    assert [(r["seed"], r["passed"], r["last"]) for r in row["seed_runs"]] == \
        [(7, True, 0.7), (1, False, 0.1), (2, False, 0.2)]
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads(json.dumps(out))


def test_missing_asset_row_is_skipped(parity):
    row = parity[0].run_row(parity[0].SPECS[2], "cpu")          # Gogoro
    assert "asset missing" in row["skipped"] and "passed" not in row
    assert row["jax"]["passed"] is True


@pytest.fixture(scope="module")
def lift():
    import eval_factory_lift_torch
    return eval_factory_lift_torch


def _jax_yaw(q):
    """scripts/eval_factory_lift.py's _yaw."""
    x = jax.vmap(lambda qq: jquat.rotate(qq, jnp.asarray([1.0, 0.0, 0.0])))(q)
    return jnp.arctan2(x[:, 1], x[:, 0])


def test_lift_formulas_match_jax(lift):
    rng = np.random.default_rng(0)
    quat = rng.normal(size=(64, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    np.testing.assert_allclose(lift.yaw(torch.as_tensor(quat)).numpy(),
                               np.asarray(_jax_yaw(jnp.asarray(quat))), atol=1e-5)
    d = np.concatenate([rng.uniform(-7, 7, 64), np.pi / 4 * np.arange(-8, 9)]).astype(np.float32)
    want = np.asarray(jnp.mod(jnp.asarray(d) + jnp.pi / 4, jnp.pi / 2) - jnp.pi / 4)
    np.testing.assert_allclose(lift.wrap_quarter(torch.as_tensor(d)).numpy(), want, atol=1e-5)
    thr = 3.0 * 2.0 * jfactory.NUT_H
    z = (jfactory.TABLE_Z + np.array([0.0, thr - 1e-4, thr + 1e-4, 0.1, -0.01])).astype(np.float32)
    np.testing.assert_array_equal(lift.lifted(torch.as_tensor(z)).numpy(),
                                  np.asarray(jnp.asarray(z) - jfactory.TABLE_Z > thr))
    assert lift.lift_threshold() == thr


@pytest.fixture(scope="module")
def pick():
    """JAX's Pick task and the port's Pick env, 4 envs each."""
    return tgx.make(TASK, num_envs=4, seed=3).task, tgt.make(TASK, num_envs=4, seed=3, device="cpu")


def test_align_action_matches_jax(lift, pick):
    jt, env = pick
    state = env.reset(3)
    rng = np.random.default_rng(1)
    q = state.q.numpy().copy()
    qn = q[:, env.task.qN + 3:env.task.qN + 7] + rng.normal(size=(4, 4)).astype(np.float32) * 0.5
    q[:, env.task.qN + 3:env.task.qN + 7] = qn / np.linalg.norm(qn, axis=1, keepdims=True)
    state = dataclasses.replace(state, q=torch.as_tensor(q))
    got = lift.align_action(env.task, state).numpy()
    # scripts/eval_factory_lift.py's align_step
    gq = jax.jit(jax.vmap(jt._eef))(jnp.asarray(q), jnp.asarray(state.qd.numpy()))[1]
    dyaw = _jax_yaw(jnp.asarray(q[:, 3:7])) - _jax_yaw(gq)
    dyaw = jnp.mod(dyaw + jnp.pi / 4, jnp.pi / 2) - jnp.pi / 4
    want = np.zeros((4, env.num_actions), np.float32)
    want[:, 5] = np.asarray(jnp.clip(dyaw / 0.1, -1.0, 1.0))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert env.task.qN == jt.qN == 0


def test_gripper_target_flip_is_a_second_closed_env(pick):
    """The task's controls (pre_physics, which every step calls) after the
    flip are a second env's built closed, bit for bit."""
    one = pick[1]
    closed = tgt.make(TASK, num_envs=4, seed=3, device="cpu")
    closed.task._gripper_target = 0.0                # JAX's env_closed
    state = one.reset(3)
    a = torch.as_tensor(np.random.default_rng(4).uniform(-1, 1, (4, one.num_actions)),
                        dtype=torch.float32)
    opened = one.task.pre_physics(state, a)[0].effort
    open_target = one.task._gripper_target
    one.task._gripper_target = 0.0
    try:
        got = one.task.pre_physics(state, a)[0].effort
    finally:
        one.task._gripper_target = open_target
    assert torch.equal(got, closed.task.pre_physics(state, a)[0].effort)
    assert not torch.equal(got, opened)
    # the controller's torques with the target 0 against JAX's controller
    t = one.task
    rng = np.random.default_rng(2)
    arr = dict(dof_pos=rng.uniform(-1, 1, (4, 9)), dof_vel=rng.normal(size=(4, 9)) * 0.3,
               eef_pos=rng.normal(size=(4, 3)) * 0.1, eef_quat=rng.normal(size=(4, 4)),
               eef_linvel=rng.normal(size=(4, 3)) * 0.1, eef_angvel=rng.normal(size=(4, 3)) * 0.1,
               finger_force_sum=rng.normal(size=(4, 3)), jacobian=rng.normal(size=(4, 6, 7)),
               arm_mass_matrix=np.eye(7) + 0.1 * rng.normal(size=(4, 7, 7)))
    arr["eef_quat"] /= np.linalg.norm(arr["eef_quat"], axis=1, keepdims=True)
    arr["target_pos"], arr["target_quat"] = arr["eef_pos"] + 0.02, arr["eef_quat"]
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    tt = {k: torch.as_tensor(v) for k, v in arr.items()}
    tau = tcontrol.compute_dof_torque(t.cfg_ctrl, *(tt[k] for k in list(arr)[:9]), 0.0,
                                      tt["target_pos"], tt["target_quat"], torch.zeros(4, 6))
    jtau = jax.jit(jax.vmap(lambda *xs: jcontrol.compute_dof_torque(
        t.cfg_ctrl, *xs[:9], 0.0, xs[9], xs[10], jnp.zeros(6))))(
        *(jnp.asarray(v) for v in arr.values()))
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), atol=2e-3, rtol=1e-3)


def test_lift_run_prints_jax_keys(lift, capsys):
    out = lift.main([CKPT, "--device", "cpu"], num_envs=4, reach=1, align=0, close=0, lift=1)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert {"checkpoint", "num_envs", "reach_keypoint_dist", "phases",
            "nut_height_above_table_mean", "lift_threshold_m", "success_rate"} <= set(out)
    assert out["phases"] == {"reach": 1, "close": 0, "lift": 1} and out["num_envs"] == 4
    assert out["kernel_launches"] == 0              # the CPU: the plain version
    assert out["kernel_geometry"] is None
    assert 0.0 <= out["success_rate"] <= 1.0 and math.isfinite(out["reach_keypoint_dist"])


def test_scaling_record_on_two_gloo_ranks(tmp_path):
    import record_scaling_torch as mod
    out = mod.main(["--lane", "cpu", "--iters", "1", "--out", str(tmp_path / "s.json")],
                   envs=64, ranks=(1, 2), repeats=2)
    assert json.loads((tmp_path / "s.json").read_text()) == out
    rec = out["lanes"]["cpu"]
    assert (rec["task"], rec["num_envs_total"], rec["horizon"], rec["device"], rec["repeats"]) \
        == ("Cartpole", 64, 16, "cpu", 2)
    one, two = rec["points"]
    assert (one["ranks"], one["sharded"], two["ranks"], two["sharded"]) == (1, False, 2, True)
    assert two["replicas_equal"] is True and two["backend"] == "gloo"
    assert (one["envs_per_rank"], two["envs_per_rank"]) == (64, 32)
    # each rank launches nothing on the CPU (the plain version)
    assert (one["launches_by_rank"], two["launches_by_rank"]) == ([0], [0, 0])
    for p in (one, two):
        assert len(p["iter_s_blocks"]) == 2 and p["iter_s"] == sum(p["iter_s_blocks"]) / 2
        assert p["env_steps_per_s"] == pytest.approx(64 * 16 / p["iter_s"])
        lo, hi = p["efficiency_range"]
        assert lo <= p["efficiency_t1_over_tn"] <= hi
    assert one["efficiency_t1_over_tn"] == 1.0 and one["reduce_s_by_rank"] == [0.0]
    assert two["efficiency_t1_over_tn"] == pytest.approx(one["iter_s"] / two["iter_s"])
    assert rec["efficiency_min"] == two["efficiency_t1_over_tn"]
    # the all-reduce's seconds: inside each rank's iteration
    assert all(0.0 < r < two["iter_s"] for r in two["reduce_s_by_rank"])
    assert two["reduce_share_by_rank"] == [r / two["iter_s"] for r in two["reduce_s_by_rank"]]
