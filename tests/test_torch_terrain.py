"""Port parity for the heightfield ground (engine/terrain.py, the sloped
branch of ops/contact.py, the heightfield mode of ops/fused.py).

- TerrainGrid heights and spawn origins: bit-equal to the JAX package's for
  the same seed.
- height_fn / height_and_grad_fn: atol 1e-6 against JAX at random interior
  points.
- The plain ground-plane sampler against JAX ``_ground_plane_sampler`` on
  Anymal at 4 envs: atol 1e-4 on c, 1e-5 on gx and gy (the JAX sampler's
  clustered einsum rounds differently from the plain gather; c carries
  gx x + gy y of up to ~10 here).
- The op path over a Heightfield against JAX ``build_step_fn(fused=False)``,
  and the kernel's plain twin (frozen planes) against the JAX kernel body
  ``build_fused_step_fn(ground=hf, interpret=True)``: the op path on
  Anymal over a TerrainGrid and on the tiny URDF of tests/test_ground.py
  over a 20 % slope, the twin on the tiny URDF, at the tolerances of
  tests/test_fused.py: q atol=rtol 2e-3, qd atol=rtol 2e-2, net atol 1.0 /
  rtol 5e-3.
Inputs are seeded numpy arrays handed to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.engine.terrain import Heightfield as JHeightfield
from thormang_isaacgym_tpu.engine.terrain import TerrainGrid as JTerrainGrid
from thormang_isaacgym_tpu.models import load_urdf as jax_load_urdf
from thormang_isaacgym_tpu.ops import fused as jax_fused
from thormang_isaacgym_tpu.ops.sim import Controls as JControls
from thormang_isaacgym_tpu.ops.sim import SimParams as JSimParams
from thormang_isaacgym_tpu.ops.sim import build_step_fn as jax_build_step_fn
from thormang_isaacgym_tpu.tasks.anymal import Anymal as JAnymal
from thormang_isaacgym_tpu_torch.engine.terrain import Heightfield, TerrainGrid
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.ops import fused
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams, build_plain_step_fn
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.tasks.anymal import Anymal

from test_torch_fused import TINY_SP, TINY_URDF

B = 4
SLOPE_HEIGHTS = np.broadcast_to(0.05 * np.arange(24, dtype=np.float32)[:, None], (24, 24)).copy()
SLOPE_KW = dict(horizontal_scale=0.25, origin=(-3.0, -3.0))


@pytest.mark.parametrize("seed", [0, 5])
def test_terrain_grid_bit_equal_to_jax(seed):
    j = JTerrainGrid(num_levels=2, num_types=5, seed=seed)
    t = TerrainGrid(num_levels=2, num_types=5, seed=seed)
    np.testing.assert_array_equal(t.field.heights, j.field.heights)
    np.testing.assert_array_equal(t.env_origins, j.env_origins)
    assert (t.field.h_scale, t.field.v_scale) == (j.field.h_scale, j.field.v_scale)
    assert t.field.table.dtype == torch.float32 and t.field.table.shape == (180, 420)


def test_height_fns_match_jax():
    rng = np.random.default_rng(0)
    j = JTerrainGrid(num_levels=2, num_types=5, seed=1).field
    t = convert.heightfield(j)
    H, W = j.heights.shape
    x = rng.uniform(1.0, (H - 2) * j.h_scale, 512).astype(np.float32)
    y = rng.uniform(1.0, (W - 2) * j.h_scale, 512).astype(np.float32)
    want = j.height_and_grad_fn()(jnp.asarray(x), jnp.asarray(y))
    got = t.height_and_grad_fn()(torch.as_tensor(x), torch.as_tensor(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.height_fn()(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
                               np.asarray(want[0]), atol=1e-6, rtol=0)
    assert float(np.abs(np.asarray(want[1])).max()) > 0.1      # the points see slopes


def _anymal_case(seed=0):
    """(jax model, port model, sim params pair, jax hf, port hf, inputs):
    Anymal at AnymalTerrain's control step, bases placed on a 2 x 5
    TerrainGrid at tile centres (levels and types spread) plus U(-0.3, 0.3)
    m, feet near the ground."""
    jt, tt = JAnymal(num_envs=B), Anymal(num_envs=B, device="cpu")
    jsp = dataclasses.replace(jt.sim_params, dt=0.02, substeps=4)
    tsp = dataclasses.replace(tt.sim_params, dt=0.02, substeps=4)
    grid = JTerrainGrid(num_levels=2, num_types=5, seed=seed)
    rng = np.random.default_rng(seed + 10)
    m = tt.model
    o = grid.env_origins[[0, 1, 1, 0], [0, 1, 2, 4]]
    q = np.zeros((B, m.nq))
    q[:, 0:2] = o[:, 0:2] + rng.uniform(-0.3, 0.3, (B, 2))
    q[:, 2] = o[:, 2] + 0.53 + rng.uniform(-0.03, 0.03, B)
    qr = rng.normal(size=(B, 4)) * 0.05 + [1.0, 0.0, 0.0, 0.0]
    q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
    dflt = tt.default_dof_pos.numpy()
    q[:, 7:] = dflt + rng.uniform(-0.2, 0.2, (B, m.nj))
    qd = rng.normal(size=(B, m.nv)) * 0.3
    tp = dflt + rng.normal(size=(B, m.nj)) * 0.2
    wrench = np.concatenate([rng.normal(size=(B, m.nb, 3)) * 0.1,
                             rng.normal(size=(B, m.nb, 3)) * 2.0], axis=-1)
    z = np.zeros((B, m.nj))
    inputs = [np.asarray(x, np.float32) for x in (q, qd, tp, z, z, wrench)]
    return jt.model, m, jsp, tsp, grid.field, convert.heightfield(grid.field), inputs


def _tiny_case():
    """The tiny floating URDF over a 20 % slope along x."""
    jm, tm = jax_load_urdf(TINY_URDF), load_urdf(TINY_URDF)
    rng = np.random.default_rng(4)
    q = np.zeros((B, tm.nq))
    q[:, 0:2] = rng.uniform(-0.5, 0.5, (B, 2))
    q[:, 2] = 0.2 * (q[:, 0] + 3.0) + 0.12 + rng.uniform(-0.04, 0.02, B)
    qr = rng.normal(size=(B, 4)) * 0.2 + [1.0, 0.0, 0.0, 0.0]
    q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
    q[:, 7:] = rng.normal(size=(B, tm.nj)) * 0.5
    qd = rng.normal(size=(B, tm.nv)) * 0.3
    z = np.zeros((B, tm.nj))
    wrench = np.zeros((B, tm.nb, 6))
    inputs = [np.asarray(x, np.float32) for x in (q, qd, z, z, z, wrench)]
    jhf = JHeightfield(SLOPE_HEIGHTS, SLOPE_KW["horizontal_scale"], origin=SLOPE_KW["origin"])
    thf = Heightfield(SLOPE_HEIGHTS, **SLOPE_KW)
    return jm, tm, JSimParams(**TINY_SP), SimParams(**TINY_SP), jhf, thf, inputs


def _case(name):
    return _anymal_case() if name == "anymal" else _tiny_case()


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


OP_CASES = [("anymal", 1), ("anymal", 3), ("tiny", 1), ("tiny", 12)]
# the JAX kernel body on Anymal takes minutes to compile on the CPU, so the
# kernel's plain twin is held against it on the tiny URDF; Anymal over the
# terrain is held against the JAX op path above
KERNEL_CASES = [("tiny", 1), ("tiny", 12)]


@pytest.fixture(scope="module")
def jax_ref():
    """JAX results for every case, computed once."""
    out = {}
    for name in ("anymal", "tiny"):
        jm, _, jsp, _, jhf, _, inputs = _case(name)
        op = jax.jit(jax_build_step_fn(jm, jsp, ground_height_fn=jhf, fused=False))
        kern = jax.jit(jax_fused.build_fused_step_fn(jm, jsp, ground=jhf, interpret=True))
        for n, steps in OP_CASES:
            if n == name:
                out[("op", name, steps)] = _run_jax(op, jm, inputs, steps)
        for n, steps in KERNEL_CASES:
            if n == name:
                out[("kernel", name, steps)] = _run_jax(kern, jm, inputs, steps)
    return out


@pytest.mark.parametrize("name,steps", OP_CASES)
def test_op_path_over_heightfield_matches_jax(jax_ref, name, steps):
    _, tm, _, tsp, _, thf, inputs = _case(name)
    got = _run_torch(build_plain_step_fn(tm, tsp, thf), tm, inputs, steps)
    want = jax_ref[("op", name, steps)]
    _assert_close(got, want)
    assert np.abs(want[2][..., :3]).max() > 1.0          # the ground pushes back


@pytest.mark.parametrize("name,steps", KERNEL_CASES)
def test_kernel_plain_twin_matches_jax_kernel_body(jax_ref, name, steps):
    _, tm, _, tsp, _, thf, inputs = _case(name)
    step = fused.build_fused_step_fn(tm, tsp, ground=thf)
    got = _run_torch(step, tm, inputs, steps)         # CPU tensors: the plain twin
    _assert_close(got, jax_ref[("kernel", name, steps)])
    assert step.launches == 0


def test_ground_plane_sampler_matches_jax():
    jm, tm, _, _, jhf, thf, inputs = _anymal_case(seed=2)
    want = np.asarray(jax_fused._ground_plane_sampler(jm, jhf)(jnp.asarray(inputs[0])))
    got = fused.ground_plane_sampler(tm, thf)(torch.as_tensor(inputs[0])).numpy()
    C = len(fused.contact.candidates(tm)["geom"])
    assert got.shape == want.shape == (B, 3 * C)
    got, want = got.reshape(B, C, 3), want.reshape(B, C, 3)
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], atol=1e-5, rtol=0)
    assert np.abs(want[..., 1:]).max() > 0.05            # the candidates sit on slopes


def test_plane_rows_match_jax_layout():
    jm, tm, *_ = _anymal_case()
    C = len(fused.contact.candidates(tm)["geom"])
    jrows = jax_fused._make_rows(jm, ground_rows=3 * C)
    rows = fused.make_rows(tm, ground_rows=3 * C)
    for f in dataclasses.fields(jrows):
        assert rows[f.name] == getattr(jrows, f.name), f.name
    assert (C, rows["total"], fused.make_rows(tm)["total"]) == (20, 534, 474)


def test_heightfield_devices_and_callables():
    _, tm, _, tsp, _, thf, inputs = _tiny_case()
    with pytest.raises(NotImplementedError):       # a callable ground, at build time
        fused.build_fused_step_fn(tm, tsp, ground=thf.height_fn())
    x = torch.zeros(3, device="meta")
    with pytest.raises(ValueError):                # table and points on different devices
        thf.height_fn()(x, x)
    assert thf.to("cpu").table.device.type == "cpu"
    np.testing.assert_array_equal(thf.to("cpu").heights, thf.heights)
