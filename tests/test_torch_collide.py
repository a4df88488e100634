"""Port parity for ops/collide.py (actor-pair contact, every kind) and the
added-inertia input of ops/dynamics.aba, against the JAX package on identical
inputs.

- Candidates (normal n, depth, contact point cp) and forces (f_ext_w, dIA,
  net) against JAX ``collide._candidates`` / ``pairwise_contact_forces``, fed
  the same body frames (the JAX forward kinematics' output): sphere vs
  cylinder in every branch (inside face-first and wall-first on both faces,
  outside above and below the face and beyond the rim, apart), sphere vs sphere,
  sphere vs capsule and capsule vs capsule; sphere vs box (centre inside,
  on a two- and a three-way face tie, outside at a face, an edge and a
  corner), capsule vs box (parallel to a face, over an edge, end on, the
  axis through the box) and box vs box (face on face aligned, the near-tie
  of two equal face overlaps; edge across edge; a corner and an edge into
  a face), each beside seeded poses. float32 with the same formulas:
  geometry atol 1e-5, forces and dIA atol 1e-3 / rtol 1e-4. One exception,
  the capsule-box candidate at the ternary search's point: its depth holds
  at 1e-5, its normal at 5e-3 and its point at 3e-4. Near the minimum the
  search compares distances that differ by less than float32 rounding, and
  XLA's CPU code contracts a * b + c into one rounding (FMA) where the port
  rounds twice, so the two searches stop up to ~1e-4 of the axis apart
  (measured: 5.8e-5 m in the point, 1.9e-3 in the normal of a candidate 3 cm
  from the box).
- The kernel source compiled as host C++ (tests/test_torch_fused.py's
  ``host_kernel``) against the JAX kernel body
  (``build_fused_step_fn(interpret=True)``) on the two-actor box-box and
  capsule-box scenes of tests/test_fused.py and a sphere-on-box scene,
  20 steps of 1 substep; tolerances below (``test_box_kernel_source_matches_jax_kernel_body``).
- ``aba(extra_body_inertia=...)`` against JAX on BallBalance's forest with a
  random symmetric positive-definite term: qdd atol 1e-3 / rtol 1e-4.
- Every pair kind builds the kernel's wrapper (the box kinds select its box
  instance); a tendon model and a model above the pair-candidate cap raise
  at build time."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.models import load_urdf as jax_load_urdf
from thormang_isaacgym_tpu.models.scene import compose as jax_compose
from thormang_isaacgym_tpu.ops import collide as jax_collide
from thormang_isaacgym_tpu.ops import fused as jax_fused
from thormang_isaacgym_tpu.ops import dynamics as jax_dyn
from thormang_isaacgym_tpu.ops.kinematics import forward_kinematics as jax_fk
from thormang_isaacgym_tpu.ops.sim import SimParams as JSimParams
from thormang_isaacgym_tpu.ops.sim import zero_controls as jax_zero_controls
from thormang_isaacgym_tpu.tasks.ball_balance import BallBalance as JBallBalance
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.ops import collide, fused
from thormang_isaacgym_tpu_torch.ops import dynamics as dyn
from thormang_isaacgym_tpu_torch.ops.kinematics import BodyFrames, forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import SimParams, check_supported, zero_controls
from thormang_isaacgym_tpu_torch.tasks.ball_balance import BallBalance

from test_torch_fused import (  # noqa: F401  (host_kernel: a fixture)
    BOX_POSES, BOX_SP, PAIR_POSES, _host_call, box_pair_scene, host_kernel, pair_capsule_scene,
)

KW = dict(stiffness=2.0e4, damping=300.0, friction_vel=0.05, dt=0.01,
          max_depenetration_velocity=2.0)


def _body(name, geom, mass=1.0):
    return f"""<robot name="{name}"><link name="{name}"><inertial><mass value="{mass}"/>
  <inertia ixx="0.01" iyy="0.01" izz="0.02" ixy="0" ixz="0" iyz="0"/></inertial>
  <collision><geometry>{geom}</geometry></collision></link></robot>"""


BALL = _body("ball", '<sphere radius="0.1"/>')
SMALL_BALL = _body("pebble", '<sphere radius="0.05"/>', mass=0.3)
TRAY = _body("tray", '<cylinder radius="0.5" length="0.02"/>', mass=15.7)
BOX = _body("box", '<box size="0.2 0.2 0.2"/>')
CAP = _body("rod", '<capsule radius="0.04" length="0.2"/>')

# ball centres in the tray frame (r = 0.5, half thickness 0.01, ball r = 0.1)
TRAY_LOCAL = np.array([
    [0.2, 0.1, 0.004],      # inside, face first (+z)
    [-0.1, 0.3, -0.006],    # inside, face first (-z)
    [0.496, 0.0, 0.0],      # inside, wall first
    [0.0, -0.497, 0.002],   # inside, wall first
    [0.1, -0.2, 0.08],      # outside, above the face
    [0.55, 0.1, 0.02],      # outside, beyond the rim
    [0.0, 0.0, 0.3],        # apart
    [0.3, 0.3, -0.09],      # outside, below the face
])
B = len(TRAY_LOCAL)


def _quat(rng, n, tilt):
    qr = rng.normal(size=(n, 4)) * tilt + [1.0, 0.0, 0.0, 0.0]
    return qr / np.linalg.norm(qr, axis=1, keepdims=True)


def _rot(qw, v):
    w, u = qw[:, :1], qw[:, 1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _qmul(a, b):
    """Products of wxyz quaternions (n, 4), numpy."""
    aw, av, bw, bv = a[:, :1], a[:, 1:], b[:, :1], b[:, 1:]
    return np.concatenate([aw * bw - np.sum(av * bv, 1, keepdims=True),
                           aw * bv + bw * av + np.cross(av, bv)], 1)


def _axis_angle(axis, deg):
    h = np.radians(deg) / 2
    return np.array([[np.cos(h), *(np.sin(h) * np.asarray(axis, float))]])


_X, _Y, _Z = (1, 0, 0), (0, 1, 0), (0, 0, 1)
_I = np.array([[1.0, 0, 0, 0]])
S2 = np.sqrt(2.0)
# (centre of a, orientation of a, orientation of b), both in a frame of
# box b's that the case turns and places at random; b is BOX (half 0.1)
BOX_LOCAL = {
    "sphere_box": [  # ball r 0.1
        ((0.02, -0.03, 0.07), _I, _I),         # inside, the +z face nearest
        ((-0.085, 0.01, 0.0), _I, _I),         # inside, the -x face
        ((0.05, 0.05, 0.0), _I, _I),           # inside, x and y faces tie
        ((0.0, 0.0, 0.0), _I, _I),             # the centre: a three-way tie
        ((0.03, 0.02, 0.17), _I, _I),          # outside, over the top face
        ((0.15, 0.15, 0.0), _I, _I),           # outside, at an edge
        ((0.16, -0.16, 0.16), _I, _I),         # outside a corner, apart
    ],
    "capsule_box": [  # capsule r 0.04, half length 0.1
        ((-0.01, 0.02, 0.137), _axis_angle(_Y, 90), _I),   # parallel to the top face
        ((0.0, 0.12, 0.135), _axis_angle(_X, 90), _I),     # parallel, over an edge
        ((0.03, -0.02, 0.235), _I, _I),                    # end on, into the top face
        ((0.02, 0.0, 0.03), _axis_angle(_Y, 30), _I),      # the axis through the box
        ((0.137, 0.0, 0.02), _I, _I),                      # parallel to a side face
        ((0.09, 0.0, 0.13), _axis_angle(_Y, 70), _I),      # tilted over a top edge
    ],
    "box_box": [
        ((0.0, 0.0, 0.198), _I, _I),                       # face on face, aligned
        ((0.05, -0.04, 0.197), _I, _I),                    # aligned, offset
        ((0.01, -0.005, 0.2 * S2 - 0.002), _axis_angle(_X, 45),
         _axis_angle(_Y, 45)),                             # ridge across ridge
        ((-0.01, 0.02, 0.2 * S2 - 0.003), _qmul(_axis_angle(_Z, 30), _axis_angle(_X, 45)),
         _axis_angle(_Y, 45)),                             # ridges at 60 degrees
        ((0.0, 0.01, 0.23842136), _qmul(_axis_angle(_Z, 20), _axis_angle(_X, 45)),
         _I),                                              # an edge 3 mm into a face
        ((-0.00391463, 0.00215082, 0.26627053),
         _qmul(_axis_angle(_X, 45), _axis_angle(_Y, 35.26439)), _I),  # a corner 3 mm in
    ],
}


def _case(name):
    """(JAX scene, port scene, q (n, nq), qd (n, nv)), seeded numpy; n = B,
    or 16 for the box kinds."""
    B = 16 if name in BOX_LOCAL else globals()["B"]
    rng = np.random.default_rng({"cylinder": 0, "spheres": 1, "capsules": 2, "sphere_box": 5,
                                 "capsule_box": 6, "box_box": 7}[name])
    if name == "capsules":
        jm, tm = pair_capsule_scene(jax_load_urdf, jax_compose), pair_capsule_scene(load_urdf, compose)
        q = np.tile(np.concatenate(PAIR_POSES[:3]), (B, 1))
        q += rng.normal(size=q.shape) * 0.01 * np.tile([1, 1, 1, 0, 0, 0, 0], 3)
    elif name in BOX_LOCAL:
        a = {"sphere_box": BALL, "capsule_box": CAP, "box_box": BOX}[name]
        jm, tm = (comp([(load(a), (0, 0, 1, 1, 0, 0, 0), "a/"), (load(BOX), (0, 0, 0, 1, 0, 0, 0), "b/")])
                  for load, comp in ((jax_load_urdf, jax_compose), (load_urdf, compose)))
        q = np.zeros((B, 14))
        q[:, 7:10] = rng.uniform(-0.3, 0.3, (B, 3))
        frame = _quat(rng, B, 1.0)
        local, qa, qb = (np.concatenate(x) for x in zip(*(
            (np.asarray(c, float)[None], qa, qb) for c, qa, qb in BOX_LOCAL[name])))
        n = len(local)
        q[:n, 10:14] = _qmul(frame[:n], qb)
        q[:n, 3:7] = _qmul(frame[:n], qa)
        q[:n, 0:3] = q[:n, 7:10] + _rot(frame[:n], local)
        # the rest: seeded poses with the centres 0.1 .. 0.25 apart
        d = rng.normal(size=(B - n, 3))
        d *= rng.uniform(0.1, 0.25, (B - n, 1)) / np.linalg.norm(d, axis=1, keepdims=True)
        q[n:, 10:14] = frame[n:]
        q[n:, 3:7] = _quat(rng, B - n, 1.0)
        q[n:, 0:3] = q[n:, 7:10] + d
    else:
        other = TRAY if name == "cylinder" else SMALL_BALL
        jm, tm = (comp([(load(BALL), (0, 0, 1, 1, 0, 0, 0), "a/"),
                        (load(other), (0, 0, 0, 1, 0, 0, 0), "b/")])
                  for load, comp in ((jax_load_urdf, jax_compose), (load_urdf, compose)))
        q = np.zeros((B, 14))
        q[:, 7:10] = rng.uniform(-0.3, 0.3, (B, 3))
        q[:, 10:14] = _quat(rng, B, 0.2)
        if name == "cylinder":
            local = TRAY_LOCAL
        else:               # centre distances 0.1 .. 0.2 against the 0.15 radius sum
            d = rng.normal(size=(B, 3))
            local = d / np.linalg.norm(d, axis=1, keepdims=True) * np.linspace(0.1, 0.2, B)[:, None]
        q[:, 0:3] = q[:, 7:10] + _rot(q[:, 10:14], local)
        q[:, 3:7] = _quat(rng, B, 0.3)
    qd = rng.normal(size=(B, tm.nv)) * 0.5
    return jm, tm, q.astype(np.float32), qd.astype(np.float32)


def _frames(jm, q, qd):
    """JAX body frames (batched) and the port's BodyFrames of the same numbers."""
    jf = jax.vmap(lambda a, b: jax_fk(jm, a, b))(jnp.asarray(q), jnp.asarray(qd))
    return jf, BodyFrames(*(torch.as_tensor(np.array(x)) for x in jf))


CASES = ["cylinder", "spheres", "capsules", "sphere_box", "capsule_box", "box_box"]


@pytest.mark.parametrize("name", CASES)
def test_pair_candidates_match_jax(name):
    jm, tm, q, qd = _case(name)
    jf, tf = _frames(jm, q, qd)
    jc = jax.vmap(lambda f: [c[4:] for c in jax_collide._candidates(jm, f)])(jf)
    tc = collide.candidates(tm, tf)
    assert [c[:4] for c in tc] == [c[:4] for c in jax_collide._candidates(
        jm, jax.tree.map(lambda x: x[0], jf))]
    for i, ((_, _, _, _, n, depth, cp), (jn, jd, jcp)) in enumerate(zip(tc, jc, strict=True)):
        # the capsule-box candidate at the ternary search's point (module docstring)
        t_opt = name == "capsule_box" and i == 1
        # the box-box edge candidate's normal and point where it is active: with
        # every cross axis degenerate (parallel edges) they are rounding noise
        on = np.asarray(jd) > 0 if name == "box_box" and i == 16 else slice(None)
        for got, want, tol in ((n[on], np.asarray(jn)[on], 5e-3 if t_opt else 1e-5),
                               (depth, jd, 1e-5), (cp[on], np.asarray(jcp)[on], 3e-4 if t_opt else 1e-5)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)
    depth = torch.stack([c[5] for c in tc], -1)
    if name == "cylinder":
        # every branch: depth ra + face gap / wall gap inside, ra - distance outside
        n = tc[0][4].numpy()
        tray_q = q[:, 10:14]
        expect = np.array([[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0], [0, -1.0, 0]])
        np.testing.assert_allclose(n[:4], -_rot(tray_q[:4], expect), atol=1e-5)
        np.testing.assert_allclose(depth[:4, 0].numpy(), [0.106, 0.104, 0.104, 0.103], atol=1e-5)
        assert (depth[[4, 5, 7], 0] > 0).all() and depth[6, 0] < 0
    elif name == "sphere_box":
        # inside: r + the least face gap, out of that face (x or y on the tie;
        # at the very centre sign(0) leaves no normal, as in JAX)
        n = tc[0][4].numpy()
        np.testing.assert_allclose(n[:2], -_rot(q[:2, 10:14], np.array([[0, 0, 1.0], [-1.0, 0, 0]])),
                                   atol=1e-5)
        assert np.abs(_rot(q[2:3, 10:14] * [1, -1, -1, -1], n[2:3])[0, :2]).max() > 0.99
        assert not n[3].any()
        np.testing.assert_allclose(depth[:6, 0].numpy(),
                                   [0.13, 0.115, 0.15, 0.2, 0.03, 0.1 - 0.05 * S2], atol=1e-5)
        assert depth[6, 0] < 0
    elif name == "capsule_box":
        # parallel to the top face, 3 mm in: the middle and the inner end sphere
        np.testing.assert_allclose(depth[0, [2, 3]].numpy(), [0.003] * 2, atol=1e-5)
        assert (depth[:6].amax(-1) > 0).all()
    elif name == "box_box":
        # aligned: the face normal is the shared -z axis (a's and b's overlaps
        # tie); offset, one corner of each box is 3 mm inside the other
        n = tc[0][4].numpy()
        np.testing.assert_allclose(n[:2], _rot(q[:2, 10:14], np.array([[0, 0, -1.0]] * 2)), atol=1e-5)
        np.testing.assert_allclose(np.sort(depth[1, :16].numpy())[-3:], [-1.0, 0.003, 0.003],
                                   atol=1e-5)
        # ridge across ridge: only the edge-edge candidate, at the 2 and 3 mm overlap
        assert not (depth[2:4, :16] > 0).any()
        np.testing.assert_allclose(depth[2:4, 16].numpy(), [0.002, 0.003], atol=2e-5)
        # an edge, then a corner, into a face: two and one corner candidates
        assert int((depth[4, :16] > 0).sum()) == 2 and int((depth[5, :16] > 0).sum()) == 1
    else:
        assert (depth > 0).any() and (depth < 0).any()


@pytest.mark.parametrize("name", CASES)
def test_pair_forces_match_jax(name):
    jm, tm, q, qd = _case(name)
    jf, tf = _frames(jm, q, qd)
    n = len(q)
    rng = np.random.default_rng(7)
    fric = rng.uniform(0.5, 1.5, (n, tm.ng)).astype(np.float32)
    jp = dataclasses.replace(jm.default_params().batch(n), geom_friction=jnp.asarray(fric))
    tp = dataclasses.replace(tm.default_params().batch(n), geom_friction=torch.as_tensor(fric))
    want = jax.vmap(lambda p, f: jax_collide.pairwise_contact_forces(jm, p, f, **KW))(jp, jf)
    got = collide.pairwise_contact_forces(tm, tp, tf, **KW)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4)
    assert float(got[1].abs().max()) > 1.0 and float(got[2].abs().max()) > 1.0


@pytest.mark.parametrize("kind", list(BOX_POSES))
def test_box_kernel_source_matches_jax_kernel_body(host_kernel, kind):
    """The kernel's B6 (host C++) against the TPU kernel's body in interpret
    mode, B = 4, 20 steps of 1 substep from the scene's pose with seeded
    velocities. At each step the host kernel starts from the JAX kernel's
    state: free running, the box-box scene parts after a few steps where an
    edge-edge candidate's overlap sits within rounding of 0.99 times the
    least face overlap (a cube resting on a cube turned 5 degrees: 1.110e-3
    against 1.107e-3) and XLA's fused multiply-adds decide the other way
    (the port's plain version and the JAX op path agree there: q 2e-6).
    Tolerances: q atol 1e-6, qd atol 1e-4, net atol 0.05 N (rtol 1e-4).
    Measured worst: q 1.2e-7 in each scene; qd 6.9e-6, 1.4e-5, 1.1e-6 and
    net 6.1e-5, 1.5e-2, 4.3e-6 N (box-box, capsule-box, sphere-box): the
    capsule's ternary-search point moves with XLA's fused multiply-adds (see
    the module docstring). The JAX scene, sim parameters and batch are those
    of tests/test_fused.py's box-kind checks, so the interpret-mode compile
    is the same computation."""
    jm, pose = box_pair_scene(kind, jax_load_urdf, jax_compose)
    tm, _ = box_pair_scene(kind, load_urdf, compose)
    n = 4
    jstep = jax.jit(jax_fused.build_fused_step_fn(jm, JSimParams(**BOX_SP), interpret=True))
    step = fused.build_fused_step_fn(tm, SimParams(**BOX_SP))
    assert step.pair_mode == 2
    rng = np.random.default_rng({"boxbox": 0, "capbox": 1, "spherebox": 2}[kind])
    q = np.tile(np.asarray(pose, np.float32), (n, 1))
    qd = (rng.normal(size=(n, tm.nv)) * 0.05).astype(np.float32)
    jp, jc, jw = jm.default_params().batch(n), jax_zero_controls(jm, n), jnp.zeros((n, jm.nb, 6))
    tp, tc, tw = tm.default_params().batch(n), zero_controls(tm, n), torch.zeros(n, tm.nb, 6)
    touched = 0.0
    for _ in range(20):
        out = jstep(jp, jnp.asarray(q), jnp.asarray(qd), jc, jw)
        got = _host_call(host_kernel, step, tp, torch.as_tensor(q), torch.as_tensor(qd), tc, tw)
        for g, w, atol in zip(got, out, (1e-6, 1e-4, 0.05)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-4)
        q, qd = np.asarray(out[0]), np.asarray(out[1])
        touched = max(touched, float(np.abs(np.asarray(out[2])).max()))
    assert touched > 1.0                        # the pair is in contact


def test_aba_extra_body_inertia_matches_jax():
    jt, tt = JBallBalance(num_envs=4), BallBalance(num_envs=4, device="cpu")
    jm, tm = jt.model, tt.model
    rng = np.random.default_rng(3)
    n = 4
    q = np.zeros((n, tm.nq), np.float32)
    q[:, 0:3] = rng.normal(size=(n, 3))
    q[:, 3:7] = _quat(rng, n, 0.3)
    q[:, 7:10] = rng.normal(size=(n, 3))
    q[:, 10:14] = _quat(rng, n, 0.3)
    q[:, 14:] = rng.uniform(-0.5, 0.5, (n, tm.nj))
    qd = (rng.normal(size=(n, tm.nv)) * 0.5).astype(np.float32)
    tau = rng.normal(size=(n, tm.nj)).astype(np.float32)
    f_ext = rng.normal(size=(n, tm.nb, 6)).astype(np.float32)
    A = rng.normal(size=(n, tm.nb, 6, 6))
    extra = (np.einsum("nbij,nbkj->nbik", A, A) * 0.05 + 0.01 * np.eye(6)).astype(np.float32)
    g = np.tile(np.array([0, 0, -9.81], np.float32), (n, 1))
    jp, tp = jm.default_params().batch(n), tm.default_params().batch(n)
    want = jax.jit(jax.vmap(lambda p, *a: jax_dyn.aba(jm, p, *a[:5], extra_body_inertia=a[5])))(
        jp, *(jnp.asarray(x) for x in (q, qd, tau, f_ext, g, extra)))
    t = [torch.as_tensor(x) for x in (q, qd, tau, f_ext, g, extra)]
    got = dyn.aba(tm, tp, *t[:5], extra_body_inertia=t[5])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-4)
    without = dyn.aba(tm, tp, *t[:5])
    assert float((got - without).abs().max()) > 1e-2          # the term is felt


@pytest.mark.parametrize("other", ["box_sphere", "box_capsule", "box_box", "tendon", "cap"])
def test_unported_pairs_raise(other):
    """What the kernel does not cover raises at build time: a model above the
    pair-candidate cap. The box kinds and fixed tendons are ported: their
    models build the wrapper, with the box instance (pair_mode 2) or with
    the tendon table (the round pairs' instance, pair_mode 1)."""
    sp = SimParams()
    if other == "tendon":
        m = compose([(load_urdf(BALL), (0, 0, 1, 1, 0, 0, 0), "a/"),
                     (load_urdf(SMALL_BALL), (0, 0, 0, 1, 0, 0, 0), "b/")])
        m = dataclasses.replace(m, tendons=(((),) + (-1.0, 1.0, "t"),))
        assert check_supported(m) == 0.0
        step = fused.build_fused_step_fn(m, sp)
        mi, mf = step._tables
        assert step.pair_mode == 1 and (mi[42], mi[43]) == (1, step.rows["tstiff"])
        assert mi[-2:].tolist() == [0, 0] and mf[-2:].tolist() == [-1.0, 1.0]   # no terms; lo, hi
        return
    elif other == "cap":
        # 33 x 33 sphere pairs between two one-link actors: above 1024 candidates
        spheres = "".join(f'<collision><origin xyz="{0.01 * i} 0 0"/><geometry><sphere '
                          f'radius="0.01"/></geometry></collision>' for i in range(33))
        urdf = (f'<robot name="cluster"><link name="c"><inertial><mass value="1"/><inertia '
                f'ixx="1" iyy="1" izz="1" ixy="0" ixz="0" iyz="0"/></inertial>{spheres}'
                f'</link></robot>')
        m = compose([(load_urdf(urdf), (0, 0, 1, 1, 0, 0, 0), "a/"),
                     (load_urdf(urdf), (0, 0, 0, 1, 0, 0, 0), "b/")])
        assert collide.pair_candidate_count(m) > fused.MAX_PAIR_CANDIDATES
        check_supported(m)                 # round pairs: supported by the op path
    else:
        a = {"box_sphere": BALL, "box_capsule": CAP, "box_box": BOX}[other]
        m = compose([(load_urdf(a), (0, 0, 1, 1, 0, 0, 0), "a/"),
                     (load_urdf(BOX), (0, 0, 0, 1, 0, 0, 0), "b/")])
        assert check_supported(m) == 0.0 and collide.has_box_pairs(m)
        step = fused.build_fused_step_fn(m, sp)
        assert step.pair_mode == 2 and step._tables[0][39] == 1      # one pair
        return
    with pytest.raises(NotImplementedError):
        fused.build_fused_step_fn(m, sp)          # the wrapper: at build, before any launch


# the box instance's pair cull (ops/fused.py pairs_apart, csrc/fused_step.cu):
# one geom of each kind (a first, as collide.pairs orders them), and the
# direction in each geom's frame along which it reaches its bounding radius
CAN = _body("can", '<cylinder radius="0.05" length="0.1"/>')     # rim sqrt(2) r from its centre
CULL_PAIRS = {"sphere_sphere": (BALL, SMALL_BALL), "sphere_capsule": (BALL, CAP),
              "sphere_cylinder": (BALL, CAN), "sphere_box": (BALL, BOX),
              "capsule_capsule": (CAP, CAP), "capsule_box": (CAP, BOX), "box_box": (BOX, BOX)}


def _reach_dir(g):
    s = np.asarray(g.size, float)
    e = {1: (0.0, 0.0, 1.0), 2: s, 3: (s[0], 0.0, s[1] if len(s) > 1 else 0.0)}.get(g.gtype, (1.0, 0.0, 0.0))
    return np.asarray(e, float) / np.linalg.norm(e)


def _aim(e, t, spin):
    """wxyz quaternions (n, 4) turning the unit vector e onto the unit vectors
    t (n, 3), then about t by `spin` radians."""
    axis = np.cross(e, t)
    c = t @ e
    q = np.concatenate([(1.0 + c)[:, None], axis], 1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = np.concatenate([np.cos(spin / 2)[:, None], t * np.sin(spin / 2)[:, None]], 1)
    return _qmul(s, q)


@pytest.mark.parametrize("where", ["at_margin", "inside_margin"])
@pytest.mark.parametrize("kind", sorted(CULL_PAIRS))
def test_box_cull_apart_pairs_have_no_contact(kind, where):
    """Wherever the box instance's cull calls a pair apart, every candidate of
    the plain narrowphase has depth <= 0: random poses of each kind, half of
    them turned so each geom reaches its bounding radius along the line of
    centres (a box's corner, a capsule's tip, a cylinder's rim), the centres
    just beyond the cull's threshold (the sum of the bounding radii plus 1 mm
    plus 1e-5 of the distance: the cull says apart) and half the margin
    inside it (it says near; the bounding spheres are still apart)."""
    a, b = CULL_PAIRS[kind]
    m = compose([(load_urdf(a), (0, 0, 1, 1, 0, 0, 0), "a/"), (load_urdf(b), (0, 0, 0, 1, 0, 0, 0), "b/")])
    (ia, ib, _), = collide.pairs(m)
    ga, gb = m.geoms[ia], m.geoms[ib]
    assert (ga.body, gb.body) == (0, 1)
    reach = float(fused.pair_reach(m)[0])
    n, half = 64, 32
    rng = np.random.default_rng(sorted(CULL_PAIRS).index(kind))
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    if where == "at_margin":
        d = (reach + fused.CULL_MARGIN) / (1.0 - fused.CULL_REL) + 1e-6
    else:
        d = reach + 0.5 * fused.CULL_MARGIN
    q = np.zeros((n, 14))
    q[:, 0:3] = rng.uniform(-0.5, 0.5, (n, 3))
    q[:, 7:10] = q[:, 0:3] + u * d
    q[:, 3:7] = _quat(rng, n, 1.0)
    q[:, 10:14] = _quat(rng, n, 1.0)
    ea, eb = _reach_dir(ga), _reach_dir(gb)
    q[half:, 3:7] = _aim(ea, u[half:], rng.uniform(0, 2 * np.pi, n - half))
    q[half:, 10:14] = _aim(eb, -u[half:], rng.uniform(0, 2 * np.pi, n - half))
    # the aimed geoms' farthest points lie d - reach apart on the line of centres
    tip_a = q[half:, 0:3] + _rot(q[half:, 3:7], np.tile(ea * fused.bounding_radius(ga), (n - half, 1)))
    tip_b = q[half:, 7:10] + _rot(q[half:, 10:14], np.tile(eb * fused.bounding_radius(gb), (n - half, 1)))
    np.testing.assert_allclose(np.linalg.norm(tip_b - tip_a, axis=1), d - reach, atol=1e-6)
    qt = torch.as_tensor(q, dtype=torch.float32)
    frames = forward_kinematics(m, qt, torch.zeros(n, m.nv))
    apart = fused.pairs_apart(m, frames)[:, 0]
    assert bool(apart.all()) if where == "at_margin" else not bool(apart.any())
    depth = torch.stack([c[5] for c in collide.candidates(m, frames)], -1)
    assert bool((depth <= 0).all()), float(depth.max())
