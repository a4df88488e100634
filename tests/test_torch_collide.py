"""Port parity for ops/collide.py (actor-pair contact, round kinds) and the
added-inertia input of ops/dynamics.aba, against the JAX package on identical
inputs.

- Candidates (normal n, depth, contact point cp) and forces (f_ext_w, dIA,
  net) against JAX ``collide._candidates`` / ``pairwise_contact_forces``, fed
  the same body frames (the JAX forward kinematics' output): sphere vs
  cylinder in every branch (inside face-first and wall-first on both faces,
  outside above and below the face and beyond the rim, apart), sphere vs sphere,
  sphere vs capsule and capsule vs capsule. float32 with the same formulas:
  geometry atol 1e-5, forces and dIA atol 1e-3 / rtol 1e-4.
- ``aba(extra_body_inertia=...)`` against JAX on BallBalance's forest with a
  random symmetric positive-definite term: qdd atol 1e-3 / rtol 1e-4.
- Box kinds (sphere vs box, capsule vs box, box vs box), a tendon model and
  a model above the pair-candidate cap raise at build time."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.models import load_urdf as jax_load_urdf
from thormang_isaacgym_tpu.models.scene import compose as jax_compose
from thormang_isaacgym_tpu.ops import collide as jax_collide
from thormang_isaacgym_tpu.ops import dynamics as jax_dyn
from thormang_isaacgym_tpu.ops.kinematics import forward_kinematics as jax_fk
from thormang_isaacgym_tpu.tasks.ball_balance import BallBalance as JBallBalance
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.ops import collide, fused
from thormang_isaacgym_tpu_torch.ops import dynamics as dyn
from thormang_isaacgym_tpu_torch.ops.kinematics import BodyFrames
from thormang_isaacgym_tpu_torch.ops.sim import SimParams, check_supported
from thormang_isaacgym_tpu_torch.tasks.ball_balance import BallBalance

from test_torch_fused import PAIR_POSES, pair_capsule_scene

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


def _case(name):
    """(JAX scene, port scene, q (B, nq), qd (B, nv)), seeded numpy."""
    rng = np.random.default_rng({"cylinder": 0, "spheres": 1, "capsules": 2}[name])
    if name == "capsules":
        jm, tm = pair_capsule_scene(jax_load_urdf, jax_compose), pair_capsule_scene(load_urdf, compose)
        q = np.tile(np.concatenate(PAIR_POSES[:3]), (B, 1))
        q += rng.normal(size=q.shape) * 0.01 * np.tile([1, 1, 1, 0, 0, 0, 0], 3)
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


@pytest.mark.parametrize("name", ["cylinder", "spheres", "capsules"])
def test_pair_candidates_match_jax(name):
    jm, tm, q, qd = _case(name)
    jf, tf = _frames(jm, q, qd)
    jc = jax.vmap(lambda f: [c[4:] for c in jax_collide._candidates(jm, f)])(jf)
    tc = collide.candidates(tm, tf)
    assert [c[:4] for c in tc] == [c[:4] for c in jax_collide._candidates(
        jm, jax.tree.map(lambda x: x[0], jf))]
    for (_, _, _, _, n, depth, cp), (jn, jd, jcp) in zip(tc, jc, strict=True):
        for got, want in ((n, jn), (depth, jd), (cp, jcp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    depth = torch.stack([c[5] for c in tc], -1)
    if name == "cylinder":
        # every branch: depth ra + face gap / wall gap inside, ra - distance outside
        n = tc[0][4].numpy()
        tray_q = q[:, 10:14]
        expect = np.array([[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0], [0, -1.0, 0]])
        np.testing.assert_allclose(n[:4], -_rot(tray_q[:4], expect), atol=1e-5)
        np.testing.assert_allclose(depth[:4, 0].numpy(), [0.106, 0.104, 0.104, 0.103], atol=1e-5)
        assert (depth[[4, 5, 7], 0] > 0).all() and depth[6, 0] < 0
    else:
        assert (depth > 0).any() and (depth < 0).any()


@pytest.mark.parametrize("name", ["cylinder", "spheres", "capsules"])
def test_pair_forces_match_jax(name):
    jm, tm, q, qd = _case(name)
    jf, tf = _frames(jm, q, qd)
    rng = np.random.default_rng(7)
    fric = rng.uniform(0.5, 1.5, (B, tm.ng)).astype(np.float32)
    jp = dataclasses.replace(jm.default_params().batch(B), geom_friction=jnp.asarray(fric))
    tp = dataclasses.replace(tm.default_params().batch(B), geom_friction=torch.as_tensor(fric))
    want = jax.vmap(lambda p, f: jax_collide.pairwise_contact_forces(jm, p, f, **KW))(jp, jf)
    got = collide.pairwise_contact_forces(tm, tp, tf, **KW)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4)
    assert float(got[1].abs().max()) > 1.0 and float(got[2].abs().max()) > 1.0


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
    sp = SimParams()
    if other == "tendon":
        m = compose([(load_urdf(BALL), (0, 0, 1, 1, 0, 0, 0), "a/"),
                     (load_urdf(SMALL_BALL), (0, 0, 0, 1, 0, 0, 0), "b/")])
        m = dataclasses.replace(m, tendons=(((),) + (-1.0, 1.0, "t"),))
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
        with pytest.raises(NotImplementedError):
            check_supported(m)
    with pytest.raises(NotImplementedError):
        fused.build_fused_step_fn(m, sp)          # the wrapper: at build, before any launch
