"""Port parity for ops/inertia.py: jacobians, the mass matrix and RNEA.

Each function of ``thormang_isaacgym_tpu_torch.ops.inertia`` (batched over
envs) against its JAX counterpart (single env, under ``jax.vmap``) on the
same states, made by numpy from a seed, at B = 3: on the Franka arm (fixed
base, the Factory and FrankaCabinet controllers' model), on FrankaCubeStack's
scene (a fixed arm and two floating cubes: the root columns in body order)
and on the floating double pendulum (one floating root with joints below
it). Float32 tolerances: jacobians atol 1e-5 (entries up to ~1), the mass
matrix and world inertias atol 1e-5 / rtol 1e-5, RNEA torques atol 1e-4 /
rtol 1e-5 (sums of tens of terms of up to ~10 N m). Also the identities the
JAX tests check: J qd is FK's body velocity, and H qdd + bias = tau against
the port's ABA."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.models import load_urdf as jax_load_urdf
from thormang_isaacgym_tpu.models.franka import load_franka as jax_load_franka
from thormang_isaacgym_tpu.ops import inertia as jdi
from thormang_isaacgym_tpu.ops.kinematics import forward_kinematics as jax_fk
from thormang_isaacgym_tpu.tasks.franka_cube_stack import FrankaCubeStack as JCubeStack
from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.franka import load_franka
from thormang_isaacgym_tpu_torch.ops import inertia as di
from thormang_isaacgym_tpu_torch.ops.dynamics import aba
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.tasks.franka_cube_stack import FrankaCubeStack

B = 3
PENDULUM = "assets/double_pendulum.urdf"


def _models(which):
    """(port model, JAX model) of the same asset."""
    if which == "franka":
        return load_franka(), jax_load_franka()
    if which == "cube_stack":
        return FrankaCubeStack(num_envs=B, device="cpu").model, JCubeStack(num_envs=B).model
    return load_urdf(PENDULUM), jax_load_urdf(PENDULUM)


def _state(model, seed):
    """(q, qd, qdd) float32 numpy, (B, nq), (B, nv), (B, nj): joints and
    velocities 0.5 x normal, floating roots at unit quaternions."""
    rng = np.random.default_rng(seed)
    q = 0.5 * rng.normal(size=(B, model.nq))
    for f in range(model.n_floating):
        quat = q[:, 7 * f + 3:7 * f + 7] + [1.0, 0.0, 0.0, 0.0]
        q[:, 7 * f + 3:7 * f + 7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qd = 0.5 * rng.normal(size=(B, model.nv))
    qdd = rng.normal(size=(B, model.nj))
    return tuple(x.astype(np.float32) for x in (q, qd, qdd))


def _params(model, jmodel):
    return model.default_params("cpu").batch(B), jmodel.default_params().batch(B)


MODELS = ["franka", "cube_stack", "pendulum"]
BODY_OFFSET = (0.01, -0.02, 0.1034)       # point_jacobian's point, on the last body


@functools.lru_cache(maxsize=None)
def _jax(which):
    """The JAX functions' outputs on `_state(.., 0)` and `_state(.., 1)`,
    under one jit (one compile per model)."""
    _, jmodel = _models(which)
    body = jmodel.nb - 1

    def one(p, q0, q, qd, qdd, root_qdd):
        frames = jax_fk(jmodel, q0, jnp.zeros(jmodel.nv))
        out = dict(J=jdi.body_jacobians(jmodel, q0),
                   P=jdi.point_jacobian(jmodel, q0, body, BODY_OFFSET),
                   I=jdi.world_spatial_inertia(jmodel, p, frames),
                   H=jdi.mass_matrix(jmodel, p, q0),
                   tau=jdi.inverse_dynamics(jmodel, p, q, qd, joint_qdd=qdd),
                   g=jdi.gravity_compensation(jmodel, p, q))
        if jmodel.n_floating == 1:
            out["tau_r"] = jdi.inverse_dynamics(jmodel, p, q, qd, root_qdd=root_qdd)
        return out

    q0, _, _ = _state(jmodel, 0)
    q, qd, qdd = _state(jmodel, 1)
    args = [jnp.asarray(x) for x in (q0, q, qd, qdd, _root_qdd())]
    out = jax.jit(jax.vmap(one))(jmodel.default_params().batch(B), *args)
    return {k: np.asarray(v) for k, v in out.items()}


def _root_qdd():
    return np.random.default_rng(2).normal(size=(B, 6)).astype(np.float32)


@pytest.mark.parametrize("which", MODELS)
def test_jacobians_and_mass_matrix_match_jax(which):
    model, jmodel = _models(which)
    want = _jax(which)
    q, _, _ = _state(model, 0)
    tq = torch.as_tensor(q)
    assert di.num_cols(model) == jdi.num_cols(jmodel)
    J = di.body_jacobians(model, tq)
    assert tuple(J.shape) == (B, model.nb, 6, di.num_cols(model))
    np.testing.assert_allclose(J.numpy(), want["J"], atol=1e-5)
    P = di.point_jacobian(model, tq, model.nb - 1, BODY_OFFSET)
    np.testing.assert_allclose(P.numpy(), want["P"], atol=1e-5)
    params = model.default_params("cpu").batch(B)
    frames = forward_kinematics(model, tq, torch.zeros(B, model.nv))
    I = di.world_spatial_inertia(model, params, frames)
    np.testing.assert_allclose(I.numpy(), want["I"], atol=1e-5, rtol=1e-5)
    H = di.mass_matrix(model, params, tq)
    np.testing.assert_allclose(H.numpy(), want["H"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(H.numpy(), H.transpose(1, 2).numpy(), atol=1e-6)


@pytest.mark.parametrize("which", MODELS)
def test_inverse_dynamics_matches_jax(which):
    model, _ = _models(which)
    want = _jax(which)
    q, qd, qdd = (torch.as_tensor(x) for x in _state(model, 1))
    params = model.default_params("cpu").batch(B)
    tau = di.inverse_dynamics(model, params, q, qd, joint_qdd=qdd)
    np.testing.assert_allclose(tau.numpy(), want["tau"], atol=1e-4, rtol=1e-5)
    g = di.gravity_compensation(model, params, q)
    np.testing.assert_allclose(g.numpy(), want["g"], atol=1e-4, rtol=1e-5)
    if model.n_floating == 1:
        tau_r = di.inverse_dynamics(model, params, q, qd, root_qdd=torch.as_tensor(_root_qdd()))
        np.testing.assert_allclose(tau_r.numpy(), want["tau_r"], atol=1e-4, rtol=1e-5)


def test_identities_on_the_franka():
    """J qd is FK's world velocity (fixed base: the columns are the joint
    rates), and H qdd + C qd + g = tau for the ABA's qdd (the ABA drives no
    armature-free joint differently: armature joins H's diagonal)."""
    model = load_franka(disable_gravity=False)
    q, qd, _ = (torch.as_tensor(x) for x in _state(model, 3))
    frames = forward_kinematics(model, q, qd)
    v = di.body_jacobians(model, q) @ qd[:, None, :, None]
    np.testing.assert_allclose(v[..., :3, 0].numpy(), frames.omega.numpy(), atol=1e-5)
    np.testing.assert_allclose(v[..., 3:, 0].numpy(), frames.vel.numpy(), atol=1e-5)
    params = model.default_params("cpu").batch(B)
    tau = torch.as_tensor(np.random.default_rng(4).normal(size=(B, model.nj)), dtype=torch.float32)
    qdd = aba(model, params, q, qd, tau, torch.zeros(B, model.nb, 6), params.gravity)
    H = di.mass_matrix(model, params, q)
    bias = di.inverse_dynamics(model, params, q, qd)
    rhs = (H @ qdd[..., None])[..., 0] + bias
    np.testing.assert_allclose(rhs.numpy(), tau.numpy(), atol=2e-3, rtol=1e-3)
    assert bool(torch.allclose(Q.rotate(frames.quat[:, 0], torch.tensor([0.0, 0, 1.0]).expand(B, 3)),
                               torch.tensor([0.0, 0, 1.0]).expand(B, 3)))
