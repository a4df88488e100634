"""The JAX functions whose twins the port lacked until its last slice, each
against its JAX twin, and the audit that none is missing any more.

- Every ``.py`` of the JAX package has a twin at the same relative path in
  the port, and no public top-level name of a JAX module is missing from
  its twin.
- Every public method of every public JAX class, inherited ones included,
  has a counterpart in the port's class of the same name: a method of the
  same name (the port's may be inherited from its own base class, as
  ``MAPPO`` and ``AMPPPO`` take ``PPO.rollout`` with their ``_record``
  hooks where JAX overrides ``rollout``), ``forward`` for ``__call__``
  (flax's modules against torch's), or an entry of ``RESTRUCTURED``, which
  names the counterpart and must name a method the port lacks.
  ``RobotModel.np_topology`` and ``MotionLib.total_length`` against JAX's.
- ``sloped_terrain``, ``stepping_stones_terrain``, ``perlin_terrain`` and
  ``_perlin``: bit-equal on the same ``np.random`` generator.
- ``geom_world_poses`` on Ant and ShadowHand states (atol 1e-5; the
  quaternion up to its sign); ``joint_reflected_inertia`` and
  ``articulated_joint_inertia`` on HumanoidMJCF and ShadowHand parameters
  off their defaults, with locked joints (rtol 1e-5).
- ``mask_select_with`` on a tree of tensors; ``amp_tpose_path`` names
  JAX's file, in the repository's ``assets/amp/``;
  ``fused_eligible`` and ``LEG_INNER`` are JAX's.
- The harness: ``record_trajectory`` gives JAX's arrays and shapes and is
  deterministic; ``save_golden`` / ``check_or_record`` record then match,
  and a drift raises.
"""
import ast
import functools
import importlib
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.engine import env as jenv
from thormang_isaacgym_tpu.engine import terrain as jterrain
from thormang_isaacgym_tpu.learn import poselib as jposelib
from thormang_isaacgym_tpu.models import load_urdf
from thormang_isaacgym_tpu.models.mjcf import load_mjcf
from thormang_isaacgym_tpu.ops import dynamics as jdyn
from thormang_isaacgym_tpu.ops import fused as jfused
from thormang_isaacgym_tpu.ops import kinematics as jkin
from thormang_isaacgym_tpu.parity import harness as jharness
from thormang_isaacgym_tpu.tasks import ant as jant
from thormang_isaacgym_tpu.tasks import ball_balance as jbb
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.engine import env as tenv
from thormang_isaacgym_tpu_torch.engine import terrain as tterrain
from thormang_isaacgym_tpu_torch.learn import poselib as tposelib
from thormang_isaacgym_tpu_torch.ops import dynamics as tdyn
from thormang_isaacgym_tpu_torch.ops import fused as tfused
from thormang_isaacgym_tpu_torch.ops import kinematics as tkin
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.parity import harness as tharness
from thormang_isaacgym_tpu_torch.tasks import ball_balance as tbb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JROOT = os.path.join(ROOT, "thormang_isaacgym_tpu")
TROOT = os.path.join(ROOT, "thormang_isaacgym_tpu_torch")


def _public(path):
    out = set()
    for n in ast.parse(open(path).read()).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return {x for x in out if not x.startswith("_")}


def test_every_jax_module_and_public_name_has_a_twin():
    missing = {}
    for d, _, files in os.walk(JROOT):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), JROOT)
            twin = os.path.join(TROOT, rel)
            if not os.path.exists(twin):
                missing[rel] = "no twin"
                continue
            lack = _public(os.path.join(d, f)) - _public(twin)
            if lack:
                missing[rel] = sorted(lack)
    assert missing == {}


# JAX class.method (path below the package) -> the port's counterpart
RESTRUCTURED = {
    "engine.terrain.Heightfield.clustered_fn":
        "Heightfield.height_and_grad_fn: on a GPU the plain gather is the fast form "
        "(port engine/terrain.py's docstring)",
}


def _methods(cls, pkg):
    """The public methods (and ``__call__``) of `cls` defined in `pkg`'s
    classes along its MRO."""
    out = set()
    for k in cls.__mro__:
        if not k.__module__.startswith(pkg + "."):
            continue
        for n, v in vars(k).items():
            if (not n.startswith("_") or n == "__call__") and \
                    (inspect.isfunction(v) or isinstance(v, (staticmethod, classmethod))):
                out.add(n)
    return out


def test_every_public_method_of_every_jax_class_has_a_twin():
    missing, restructured = {}, set()
    for d, _, files in os.walk(JROOT):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f[:-3]), JROOT).replace(os.sep, ".")
            rel = rel[:-len(".__init__")] if rel.endswith("__init__") else rel
            jmod = importlib.import_module(f"thormang_isaacgym_tpu.{rel}".rstrip("."))
            tmod = importlib.import_module(f"thormang_isaacgym_tpu_torch.{rel}".rstrip("."))
            for name, jcls in vars(jmod).items():
                if name.startswith("_") or not inspect.isclass(jcls) or \
                        jcls.__module__ != jmod.__name__:
                    continue
                tcls = getattr(tmod, name)
                mine = _methods(tcls, "thormang_isaacgym_tpu_torch")
                if hasattr(tcls, "forward"):
                    mine.add("__call__")
                for m in sorted(_methods(jcls, "thormang_isaacgym_tpu") - mine):
                    key = f"{rel}.{name}.{m}"
                    if key in RESTRUCTURED:
                        restructured.add(key)
                    else:
                        missing.setdefault(f"{rel}.{name}", []).append(m)
    assert missing == {}
    assert restructured == set(RESTRUCTURED)


def test_np_topology_and_total_length_match_jax():
    from thormang_isaacgym_tpu.models import franka as jfranka
    from thormang_isaacgym_tpu_torch.models import franka as tfranka
    for g, w in zip(tfranka.load_franka().np_topology(), jfranka.load_franka().np_topology()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    from thormang_isaacgym_tpu.learn import motion_lib as jml
    from thormang_isaacgym_tpu_torch.learn import motion_lib as tml
    clips = [jml.make_gait_clip(fps=30, n_cycles=n) for n in (1, 2)]
    want = jml.MotionLib(clips, weights=[1.0, 3.0]).total_length()
    got = tml.MotionLib([tml.make_gait_clip(fps=30, n_cycles=n) for n in (1, 2)],
                        weights=[1.0, 3.0]).total_length()
    assert isinstance(got, float) and got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("case", ["sloped", "stepping_stones", "perlin", "perlin_raw"])
def test_terrain_generators_bit_equal(case):
    def run(mod):
        rng = np.random.RandomState(11)
        if case == "sloped":
            return mod.sloped_terrain((17, 9), 0.013)
        if case == "stepping_stones":
            return mod.stepping_stones_terrain((40, 30), 4, 2, 0.2, -1.0, rng)
        if case == "perlin":
            return mod.perlin_terrain((64, 128), res=(2, 4), octaves=3, rng=rng)
        return mod._perlin((32, 64), (4, 8), rng)
    got, want = run(tterrain), run(jterrain)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "perlin":       # the default generator too
        np.testing.assert_array_equal(tterrain.perlin_terrain((32, 64)),
                                      jterrain.perlin_terrain((32, 64)))


def _states(name, n, seed):
    env = tgt.make(name, num_envs=n, seed=0, device="cpu")
    m = env.task.model
    rng = np.random.default_rng(seed)
    q = env.reset(0).q.numpy().copy()
    q[:, 7 * m.n_floating:] += rng.normal(size=(n, m.nj)).astype(np.float32) * 0.3
    if m.n_floating:
        quat = rng.normal(size=(n, 4)).astype(np.float32)
        q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qd = rng.normal(size=(n, m.nv)).astype(np.float32)
    return env, m, q, qd


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """The JAX task's model, built once a module: Ant's and HumanoidMJCF's
    from the loaders their constructors call (which then set drive defaults
    and solve the spawn height, op by op, ~5 s a task; the geoms, the
    kinematic tree and the inertias are the loader's)."""
    if name == "Ant":
        return load_urdf(jant.make_ant_urdf(), name="ant")
    if name == "HumanoidMJCF":
        return load_mjcf(os.path.join(ROOT, "assets", "mjcf", "nv_humanoid.xml"))
    return tgx.make(name, num_envs=2, seed=0).task.model


# The JAX references below are jitted: op by op, each of their primitives
# compiles alone on its first call (ShadowHand's forward kinematics ~9 s)


@pytest.mark.parametrize("name", ["Ant", "ShadowHand"])
def test_geom_world_poses_match_jax(name):
    env, m, q, qd = _states(name, 3, 1)
    jm = _jax_model(name)
    got = tkin.geom_world_poses(m, tkin.forward_kinematics(m, torch.as_tensor(q),
                                                           torch.as_tensor(qd)))
    poses = jax.jit(lambda q, qd: jkin.geom_world_poses(jm, jkin.forward_kinematics(jm, q, qd)))
    for b in range(3):
        want = poses(jnp.asarray(q[b]), jnp.asarray(qd[b]))
        for k, (g, w) in enumerate(zip(got, want)):
            g, w = g[b].numpy(), np.asarray(w)
            if k == 1:
                w = np.where(np.sum(g * w, -1, keepdims=True) < 0, -w, w)
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=str(k))


@pytest.mark.parametrize("name", ["HumanoidMJCF", "ShadowHand"])
def test_joint_inertias_match_jax(name):
    env, m, q, _ = _states(name, 2, 2)
    jm = _jax_model(name)
    rng = np.random.default_rng(3)
    p = {k: np.asarray(v) for k, v in jm.default_params().__dict__.items()}
    p["body_mass"] = p["body_mass"] * rng.uniform(0.8, 1.2, p["body_mass"].shape).astype(np.float32)
    p["dof_armature"] = rng.uniform(0.0, 0.05, p["dof_armature"].shape).astype(np.float32)
    locked = np.zeros(m.nj, np.float32)
    locked[::3] = 1.0
    p["dof_locked"] = locked
    jparams = type(jm.default_params())(**{k: jnp.asarray(v) for k, v in p.items()})
    tparams = convert.model_params(p).batch(2)
    jq = q[:, 7 * m.n_floating:]
    got_r = tdyn.joint_reflected_inertia(m, tparams)
    got_a = tdyn.articulated_joint_inertia(m, tparams, torch.as_tensor(jq))
    want_r = jax.jit(lambda p: jdyn.joint_reflected_inertia(jm, p))(jparams)
    articulated = jax.jit(lambda p, q: jdyn.articulated_joint_inertia(jm, p, q))
    for b in range(2):
        np.testing.assert_allclose(got_r[b].numpy(), np.asarray(want_r), rtol=1e-5, atol=1e-9)
        want_a = articulated(jparams, jnp.asarray(jq[b]))
        np.testing.assert_allclose(got_a[b].numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-9)
    # a locked child passes its subtree on: the apparent inertia exceeds the child's
    assert bool((got_a >= got_r - 1e-6).all()) and bool((got_a > got_r * 1.5).any())


def test_mask_select_with_and_small_twins():
    rng = np.random.default_rng(4)
    mask = rng.uniform(size=5) < 0.5
    f = np.float32
    new = {"a": rng.normal(size=(5, 3)).astype(f), "b": (rng.normal(size=5).astype(f),)}
    old = {"a": rng.normal(size=(5, 3)).astype(f), "b": (rng.normal(size=5).astype(f),)}
    want = jenv.mask_select_with(jnp.asarray(mask), jax.tree.map(jnp.asarray, new),
                                 jax.tree.map(jnp.asarray, old), 5)
    t = lambda tree: {"a": torch.as_tensor(tree["a"]),  # noqa: E731
                      "b": (torch.as_tensor(tree["b"][0]),)}
    got = tenv.mask_select_with(torch.as_tensor(mask), t(new), t(old), 5)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))
    # the same file, in the repository's assets (the JAX path is the reference's)
    assert os.path.basename(tposelib.amp_tpose_path()) == \
        os.path.basename(jposelib.amp_tpose_path()) == "amp_humanoid_tpose.npy"
    assert tposelib.amp_tpose_path() == os.path.join(ROOT, "assets", "amp",
                                                     "amp_humanoid_tpose.npy")
    assert tbb.LEG_INNER == jbb.LEG_INNER
    for name, ground in (("Ant", 0.0), ("Ant", None), ("Ant", lambda p: p[..., 0] * 0)):
        tm = tgt.make(name, num_envs=2, seed=0, device="cpu").task.model
        jm = _jax_model(name)
        assert tfused.fused_eligible(tm, ground, None) == jfused.fused_eligible(jm, ground, None)


def test_harness_recorder(tmp_path):
    env = tgt.make("Cartpole", num_envs=4, seed=0, device="cpu")
    a = tharness.record_trajectory(env, steps=6, seed=3)
    b = tharness.record_trajectory(env, steps=6, seed=3)
    want = jharness.record_trajectory(tgx.make("Cartpole", num_envs=4, seed=0), steps=6, seed=3)
    assert sorted(a) == sorted(want)
    for k in want:
        assert a[k].shape == want[k].shape and a[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])
    root = str(tmp_path)
    assert tharness.check_or_record("cp", env, steps=6, seed=3, root=root) == "recorded"
    assert os.path.exists(tharness.golden_path("cp", root))
    assert tharness.check_or_record("cp", env, steps=6, seed=3, root=root) == "matched"
    drift = dict(a, final_q=a["final_q"] + 0.1)
    tharness.save_golden("cp", drift, root=root)
    with pytest.raises(AssertionError, match="golden-trajectory drift in cp:final_q"):
        tharness.check_or_record("cp", env, steps=6, seed=3, root=root)
