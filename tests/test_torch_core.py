"""Port parity: core/quat.py and core/spatial.py of the PyTorch package
against the JAX package on identical seeded numpy inputs, to 1e-6: rtol 1e-6
and atol 1e-6 times the output's largest magnitude when that exceeds 1
(float32 elementwise math and 3x3 / 6x6 products)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.core import quat as JQ
from thormang_isaacgym_tpu.core import spatial as JS
from thormang_isaacgym_tpu_torch.core import quat as TQ
from thormang_isaacgym_tpu_torch.core import spatial as TS

TOL = 1e-6
N = 64


def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    q = rng.normal(size=(N, 4)).astype(f)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.normal(size=(N, 4)).astype(f)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    a = rng.normal(size=(N, 3)).astype(f)
    axis = a / np.linalg.norm(a, axis=1, keepdims=True)
    L = rng.normal(size=(N, 3, 3)).astype(f)
    spd = (L @ L.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=f)).astype(f)
    M6 = rng.normal(size=(N, 6, 6)).astype(f)
    return dict(
        q=q, q2=q2, v=rng.normal(size=(N, 3)).astype(f), axis=axis,
        ang=rng.uniform(-3, 3, N).astype(f), ang2=rng.uniform(-9, 9, N).astype(f),
        t=rng.uniform(0, 1, N).astype(f), w=rng.normal(size=(N, 3)).astype(f),
        m6=rng.normal(size=(N, 6)).astype(f), f6=rng.normal(size=(N, 6)).astype(f),
        p=rng.normal(size=(N, 3)).astype(f), mass=rng.uniform(0.1, 5, N).astype(f),
        com=0.2 * rng.normal(size=(N, 3)).astype(f), I=spd, IA=(M6 @ M6.transpose(0, 2, 1)).astype(f),
    )


# name -> f(quat module, spatial module, inputs)
CASE_FNS = {
    "normalize": lambda Q, S, x: Q.normalize(x["q"] * 3.0),
    "mul": lambda Q, S, x: Q.mul(x["q"], x["q2"]),
    "conj": lambda Q, S, x: Q.conj(x["q"]),
    "rotate": lambda Q, S, x: Q.rotate(x["q"], x["v"]),
    "rotate_inv": lambda Q, S, x: Q.rotate_inv(x["q"], x["v"]),
    "from_axis_angle": lambda Q, S, x: Q.from_axis_angle(x["axis"], x["ang"]),
    "from_euler_xyz": lambda Q, S, x: Q.from_euler_xyz(x["ang"], x["ang"] * 0.3, -x["ang"]),
    "to_euler_xyz": lambda Q, S, x: Q.to_euler_xyz(x["q"]),
    "to_matrix": lambda Q, S, x: Q.to_matrix(x["q"]),
    "from_matrix": lambda Q, S, x: Q.from_matrix(Q.to_matrix(x["q"])),
    "integrate": lambda Q, S, x: Q.integrate(x["q"], x["w"], 0.01),
    "slerp": lambda Q, S, x: Q.slerp(x["q"], x["q2"], x["t"]),
    "to_tan_norm": lambda Q, S, x: Q.to_tan_norm(x["q"]),
    "heading": lambda Q, S, x: Q.heading(x["q"]),
    "heading_quat_inv": lambda Q, S, x: Q.heading_quat_inv(x["q"]),
    "wrap_to_pi": lambda Q, S, x: Q.wrap_to_pi(x["ang2"]),
    "shortest_angle_distance": lambda Q, S, x: Q.shortest_angle_distance(x["ang"], x["ang2"]),
    "xyzw_roundtrip": lambda Q, S, x: Q.from_xyzw(Q.to_xyzw(x["q"])),
    "skew": lambda Q, S, x: S.skew(x["v"]),
    "cross_motion": lambda Q, S, x: S.cross_motion(x["m6"], x["f6"]),
    "cross_force": lambda Q, S, x: S.cross_force(x["m6"], x["f6"]),
    "motion_to_parent": lambda Q, S, x: S.motion_to_parent(Q.to_matrix(x["q"]), x["p"], x["m6"]),
    "motion_to_child": lambda Q, S, x: S.motion_to_child(Q.to_matrix(x["q"]), x["p"], x["m6"]),
    "force_to_parent": lambda Q, S, x: S.force_to_parent(Q.to_matrix(x["q"]), x["p"], x["f6"]),
    "force_to_child": lambda Q, S, x: S.force_to_child(Q.to_matrix(x["q"]), x["p"], x["f6"]),
    "motion_xform": lambda Q, S, x: S.motion_xform(Q.to_matrix(x["q"]), x["p"]),
    "force_xform": lambda Q, S, x: S.force_xform(Q.to_matrix(x["q"]), x["p"]),
    "inertia_matrix": lambda Q, S, x: S.inertia_matrix(x["mass"], x["com"], x["I"]),
    "inertia_mul": lambda Q, S, x: S.inertia_mul(x["mass"], x["com"], x["I"], x["m6"]),
    "transform_inertia_to_parent": lambda Q, S, x: S.transform_inertia_to_parent(
        Q.to_matrix(x["q"]), x["p"], x["IA"]),
}


@pytest.fixture(scope="module")
def jax_ref():
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    return {name: fn(JQ, JS, x) for name, fn in CASE_FNS.items()}


@pytest.mark.parametrize("name", sorted(CASE_FNS))
def test_core_matches_jax(jax_ref, name):
    x = {k: torch.as_tensor(v) for k, v in _inputs().items()}
    got = CASE_FNS[name](TQ, TS, x)
    want = jax_ref[name]
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=TOL * scale, rtol=TOL)
