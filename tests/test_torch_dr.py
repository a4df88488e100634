"""Port parity for engine/dr.py and the domain randomisation of
engine/env.py: the randomization_params schema, schedules, samplers,
buckets, masks, the actor scale, observation / action noise and the
frequency-gated events of ``step_fn``.

The JAX package draws its standard samples from threefry keys, the port
from its counter-based streams; where a result is compared, the JAX
package's standard samples, rebuilt from its key structure, are fed to the
port's apply step. Tolerances: parameters and noise atol 1e-6 / rtol 1e-6
(float32, the same formulas); after a physics step q, qd and obs atol 1e-5.
The port's own samplers are held by their bounds and moments."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.engine import dr as jdr
from thormang_isaacgym_tpu.engine.env import _env_keys
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.engine import dr
from thormang_isaacgym_tpu_torch.engine.env import EnvRandom
from thormang_isaacgym_tpu_torch.parity import convert

SHADOWLIKE = {
    "frequency": 10,
    "observations": {
        "range": [0, 0.002], "range_correlated": [0, 0.001],
        "operation": "additive", "distribution": "gaussian",
        "schedule": "linear", "schedule_steps": 40000,
    },
    "actions": {
        "range": [0.0, 0.05], "range_correlated": [0, 0.015],
        "operation": "additive", "distribution": "gaussian",
        "schedule": "linear", "schedule_steps": 40000,
    },
    "sim_params": {"gravity": {
        "range": [0, 0.4], "operation": "additive",
        "distribution": "gaussian", "schedule": "linear",
        "schedule_steps": 40000}},
    "actor_params": {"hand": {
        "rigid_body_properties": {"mass": {
            "range": [0.5, 1.5], "operation": "scaling",
            "distribution": "uniform", "setup_only": True}},
        "rigid_shape_properties": {"friction": {
            "num_buckets": 8, "range": [0.7, 1.3],
            "operation": "scaling", "distribution": "uniform"}},
        "dof_properties": {"damping": {
            "range": [0.3, 3.0], "operation": "scaling",
            "distribution": "loguniform"}},
        "scale": {"range": [0.95, 1.05], "operation": "scaling",
                  "distribution": "uniform", "setup_only": True},
    }},
}
# every distribution, operation and schedule kind on Cartpole (one actor):
# uniform action noise with its correlated part, a constant schedule, a
# gaussian additive dof bound, loguniform damping, bucketed friction, and
# the setup-only mass and scale
STEP_DR = {
    "frequency": 10,
    "observations": {"range": [0, 0.02], "range_correlated": [0, 0.01],
                     "operation": "additive", "distribution": "gaussian",
                     "schedule": "linear", "schedule_steps": 40},
    "actions": {"range": [-0.1, 0.1], "range_correlated": [-0.05, 0.05],
                "operation": "additive", "distribution": "uniform",
                "schedule": "constant", "schedule_steps": 20},
    "sim_params": {"gravity": {"range": [0, 0.4], "operation": "additive",
                               "distribution": "gaussian"}},
    "actor_params": {"cartpole": {
        "rigid_body_properties": {"mass": {"range": [0.5, 1.5], "operation": "scaling",
                                           "distribution": "uniform", "setup_only": True}},
        "rigid_shape_properties": {"friction": {"num_buckets": 8, "range": [0.7, 1.3],
                                                "operation": "scaling",
                                                "distribution": "uniform"}},
        "dof_properties": {
            "damping": {"range": [0.3, 3.0], "operation": "scaling",
                        "distribution": "loguniform", "schedule": "linear",
                        "schedule_steps": 100},
            "lower": {"range": [0, 0.01], "operation": "additive",
                      "distribution": "gaussian"}},
        "scale": {"range": [0.95, 1.05], "operation": "scaling",
                  "distribution": "uniform", "setup_only": True},
    }},
}
B = 8
TOL = dict(atol=1e-6, rtol=1e-6)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want, atol=1e-6, rtol=1e-6, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol, err_msg=msg)


def _close_params(got, want, **tol):
    for f in dataclasses.fields(got):
        _close(getattr(got, f.name), getattr(want, f.name), msg=f.name, **tol)


def _is_gauss(spec):
    return spec.get("distribution", "uniform") in dr.GAUSSIAN


def _jax_std(spec, key, shape):
    return (jax.random.normal if _is_gauss(spec) else jax.random.uniform)(key, shape)


def _jax_draws(entries, keys, base, setup):
    """The JAX package's standard samples of one event per env: entry i of
    env n from fold_in(keys[n], i), shaped like the unbatched leaf."""
    out = {}
    for i, e in enumerate(entries):
        if e["setup_only"] and not setup:
            continue
        leaf = "body_mass" if e["leaf"] == "__scale__" else e["leaf"]
        shape = np.shape(getattr(base, leaf))
        out[i] = jax.vmap(lambda k: _jax_std(e["spec"], jax.random.fold_in(k, i), shape))(keys)
    return out


def _torch_draws(draws):
    return {i: torch.as_tensor(np.array(x)) for i, x in draws.items()}


def _cartpole(cfg_dr=SHADOWLIKE):
    cfg = {"task": {"randomize": True, "randomization_params": cfg_dr}}
    return tgx.make("Cartpole", num_envs=B, seed=0, cfg=cfg), \
        tgt.make("Cartpole", num_envs=B, seed=0, cfg=cfg, device="cpu")


# ---- the schema ----
def test_parse_full_schema():
    jenv, env = _cartpole()
    jent, jobs, jact, jfreq = jdr.parse_randomization_params(SHADOWLIKE, jenv.task.model)
    ent, obs, act, freq = dr.parse_randomization_params(SHADOWLIKE, env.task.model)
    assert sorted(e["leaf"] for e in ent) == ["__scale__", "body_mass", "dof_damping",
                                               "geom_friction", "gravity"]
    assert [(e["leaf"], e["setup_only"], e["mask"]) for e in ent] == \
        [(e["leaf"], e["setup_only"], e["mask"]) for e in jent]
    assert (obs, act, freq) == (jobs, jact, jfreq) and freq == 10


def test_setup_only_and_buckets():
    _, env = _cartpole()
    fn, active = dr.make_dr_fn(SHADOWLIKE, env.task.model)
    assert active and fn.running(True) == [0, 1, 2, 3, 4] and fn.running(False) == [0, 2, 3]
    base = env.task.model.default_params().batch(64)
    ep = torch.arange(64)
    p_setup = fn(EnvRandom(0, ep, 23), base, base, 0, setup=True)
    p_reset = fn(EnvRandom(0, ep, 29), base, base, 0, setup=False)
    assert not torch.allclose(p_setup.body_mass, base.body_mass)
    assert torch.equal(p_reset.body_mass, base.body_mass)
    # friction buckets: 64 x 2 samples land on at most num_buckets values
    ratio = (p_reset.geom_friction / base.geom_friction).numpy()
    assert len(set(np.round(ratio.ravel(), 6))) <= 8
    grid = 0.7 + np.arange(8) * 0.6 / 7
    assert np.abs(ratio.ravel()[:, None] - grid[None]).min(1).max() < 1e-6


@pytest.mark.parametrize("spec", [
    dict(SHADOWLIKE["observations"]),
    dict(STEP_DR["actions"]),
    {"range": [0.3, 3.0], "operation": "scaling", "distribution": "loguniform",
     "schedule": "linear", "schedule_steps": 100},
    {"range": [0.3, 3.0], "operation": "scaling", "distribution": "loguniform"},
    {"range": [0.9, 0.2], "operation": "scaling", "distribution": "gaussian",
     "schedule": "constant", "schedule_steps": 50},
    {"range": [0.7, 1.3], "operation": "scaling", "distribution": "uniform",
     "schedule": "linear", "schedule_steps": 30},
], ids=["obs_linear", "act_constant", "loguniform_linear", "loguniform_none",
        "gaussian_scaling_constant", "uniform_scaling_linear"])
@pytest.mark.parametrize("gs", [0, 7, 60, 40000])
def test_schedules_match_jax(spec, gs):
    """_sched_scale and _sched_range, a Python float without a schedule
    (the loguniform branch's lo ** s) and a tensor with one."""
    js = jdr._sched_scale(spec, jnp.asarray(gs, jnp.int32))
    s = dr._sched_scale(spec, torch.tensor(gs))
    assert isinstance(s, float) == isinstance(js, float)
    _close(s, js, **TOL)
    for key in ("range", "range_correlated"):
        if key in spec:
            for got, want in zip(dr._sched_range(spec, spec[key], s),
                                 jdr._sched_range(spec, spec[key], js)):
                _close(got, want, **TOL)


def test_sample_bucketize_apply_masked_match_jax():
    """_sample on fed standard samples, _bucketize, _apply, and the batched
    _masked against the JAX package's per-env one: a (k,) mask on a
    (B, k, 3) leaf lines up with axis 1."""
    rng = np.random.default_rng(0)
    u = rng.uniform(size=(B, 5, 3)).astype(np.float32)
    z = rng.normal(size=(B, 5, 3)).astype(np.float32)
    base = rng.uniform(0.5, 2.0, (B, 5, 3)).astype(np.float32)
    old = rng.uniform(0.5, 2.0, (B, 5, 3)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    for spec, std in (({"distribution": "uniform", "num_buckets": 250}, u),
                      ({"distribution": "loguniform"}, u), ({"distribution": "gaussian"}, z)):
        lo, hi = (0.7, 1.3) if spec["distribution"] != "gaussian" else (0.0, 0.4)
        got = dr._bucketize(dr._sample(spec, torch.as_tensor(std), lo, hi), spec, lo, hi)
        # the JAX package's _sample formula on the same standard samples
        d = spec["distribution"]
        ref = lo + std * (hi - lo) if d == "uniform" else \
            np.exp(np.log(np.float32(lo)) + std * (np.log(np.float32(hi)) - np.log(np.float32(lo)))) \
            if d == "loguniform" else lo + std * hi
        want = jdr._bucketize(jnp.asarray(ref, jnp.float32), spec, lo, hi)
        _close(got, want, atol=2e-6, rtol=1e-6, msg=d)
        for op in ("scaling", "additive"):
            new = dr._apply(op, torch.as_tensor(base), got)
            _close(new, jdr._apply(op, jnp.asarray(base), want), atol=2e-6, rtol=1e-6)
            m = dr._masked(torch.as_tensor(old), new, mask)
            jm = jax.vmap(lambda o, n: jdr._masked(o, n, mask))(jnp.asarray(old), jnp.asarray(_np(new)))
            np.testing.assert_array_equal(_np(m), np.asarray(jm))
            np.testing.assert_array_equal(_np(m)[:, mask == 0], old[:, mask == 0])
    with pytest.raises(ValueError):
        dr._apply("multiply", torch.ones(1), torch.ones(1))


def test_scale_entry_matches_jax():
    """The actor scale s: mass s^3, inertia s^5, com s, on fed draws."""
    jenv, env = _cartpole()
    spec = {"range": [0.8, 1.2], "operation": "scaling", "distribution": "uniform"}
    rp = {"actor_params": {"cartpole": {"scale": spec}}}
    jfn, _ = jdr.make_dr_fn(rp, jenv.task.model)
    fn, _ = dr.make_dr_fn(rp, env.task.model)
    jbase = jenv.task.model.default_params().batch(B)
    keys = jax.random.split(jax.random.key(3), B)
    want = jax.vmap(lambda k, p, b: jfn(k, p, b, 0, setup=True))(keys, jbase, jbase)
    base = convert.model_params(jax.tree.map(np.asarray, jbase))
    draws = _torch_draws(_jax_draws(fn.entries, keys, jenv.task.model.default_params(), True))
    got = fn.apply(draws, base, base, 0, setup=True)
    _close_params(got, convert.model_params(jax.tree.map(np.asarray, want)), **TOL)
    s = 0.8 + draws[0] * 0.4
    _close(got.body_mass, base.body_mass * s ** 3, **TOL)
    _close(got.body_com, base.body_com * s[..., None], **TOL)


@pytest.mark.parametrize("name", ["observations", "actions"])
@pytest.mark.parametrize("gs", [5, 30])
def test_noise_fn_matches_jax(name, gs):
    """make_noise_fn with a fed corr and the JAX package's standard
    samples."""
    spec = STEP_DR[name]
    jfn, fn = jdr.make_noise_fn(spec), dr.make_noise_fn(spec)
    rng = np.random.default_rng(gs)
    x = rng.normal(size=(B, 4)).astype(np.float32)
    corr = (rng.normal(size=(B, 4)) if _is_gauss(spec) else rng.uniform(size=(B, 4)))
    corr = corr.astype(np.float32)
    key = jax.random.key(gs)
    want = jfn(key, jnp.asarray(x), jnp.asarray(corr), jnp.asarray(gs, jnp.int32))
    std = torch.as_tensor(np.asarray(_jax_std(spec, key, x.shape)))
    got = fn.apply(std, torch.as_tensor(x), torch.as_tensor(corr), torch.tensor(gs))
    _close(got, want, **TOL)
    assert dr.make_noise_fn(None) is None and dr.make_noise_fn({"operation": "additive"}) is None


def test_linear_schedule_ramps():
    fn = dr.make_noise_fn(SHADOWLIKE["observations"])
    x = torch.ones(4, 6)
    rng = EnvRandom(0, torch.zeros(4, dtype=torch.int64), 37)
    early = fn(rng, x, None, torch.tensor(0)) - 1.0
    late = fn(rng, x, None, torch.tensor(40000)) - 1.0
    assert early.abs().max() < 1e-6
    assert late.abs().max() > 1e-5


def test_correlated_noise_fixed_between_events():
    fn = dr.make_noise_fn(dict(SHADOWLIKE["observations"], schedule=None))
    x = torch.zeros(4, 6)
    corr = torch.randn(4, 6, generator=torch.Generator().manual_seed(2))
    ep = torch.zeros(4, dtype=torch.int64)
    a = fn(EnvRandom(0, ep, 3), x, corr, 0)
    b = fn(EnvRandom(0, ep, 4), x, corr, 0)
    assert not torch.allclose(a, b)
    np.testing.assert_allclose(_np((a + b) / 2), _np(corr) * 0.001, atol=3 * 0.002)


def test_samplers_bounds_and_moments():
    """The port's own draws: U[0, 1) and N(0, 1) by bounds and moments over
    4096 envs x 64 (standard errors 0.0006 and 0.002), loguniform inside its
    range, and a uniform of exactly 0 gives a finite normal."""
    ep = torch.arange(4096)
    u = dr.standard_draw("uniform", EnvRandom(7, ep, 29), (8, 8))
    z = dr.standard_draw("gaussian", EnvRandom(7, ep, 29), (64,))
    assert u.shape == (4096, 8, 8) and z.shape == (4096, 64)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 4e-3 and abs(float(u.var()) - 1 / 12) < 4e-3
    assert abs(float(z.mean())) < 1e-2 and abs(float(z.var()) - 1.0) < 2e-2
    assert abs(float((z ** 3).mean())) < 5e-2 and abs(float((z ** 4).mean()) - 3.0) < 0.1
    lu = dr._sample({"distribution": "loguniform"}, u, 0.3, 3.0)
    assert float(lu.min()) >= 0.3 - 1e-6 and float(lu.max()) <= 3.0
    assert abs(float(torch.log(lu).mean()) - 0.5 * (np.log(0.3) + np.log(3.0))) < 1e-2
    assert torch.isfinite(dr.standard_normal(torch.zeros(3), torch.zeros(3))).all()
    with pytest.raises(ValueError):
        dr.standard_draw("poisson", EnvRandom(7, ep, 29), (2,))


# ---- masks ----
def test_tendon_mask_per_actor():
    """Per-actor tendon masks select the named actor's tendons (t[3])."""
    _, env = _cartpole()
    m = env.task.model
    m = dataclasses.replace(
        m, body_names=tuple("a/" + n for n in m.body_names),
        joint_names=tuple("a/" + n for n in m.joint_names),
        tendons=(((1.0,) * m.nj, -0.1, 0.1, "a/t0"), ((1.0,) * m.nj, -0.1, 0.1, "b/t1")))
    masks = dr._actor_masks(m, "a")
    np.testing.assert_array_equal(masks["tendon"], [1.0, 0.0])
    np.testing.assert_array_equal(masks["body"], [1.0] * m.nb)


@pytest.fixture(scope="module")
def hands():
    """The JAX and port ShadowHand with its YAML's block (randomize)."""
    from thormang_isaacgym_tpu.tasks.shadow_hand import ShadowHand as JShadowHand
    from thormang_isaacgym_tpu_torch.tasks.shadow_hand import ShadowHand
    return JShadowHand(num_envs=4, randomize=True), ShadowHand(num_envs=4, device="cpu",
                                                                randomize=True)


def test_shadow_hand_scene_masks_match_jax(hands):
    """ShadowHand's scene names its hand bodies without a prefix and its
    cube "obj/": the YAML's actors "hand" and "object" match no prefix and
    apply everywhere, in both packages; "obj" selects the cube alone."""
    jt, t = hands
    assert t.model.body_names == jt.model.body_names
    assert [tuple(x[1:]) for x in t.model.tendons] == [tuple(x[1:]) for x in jt.model.tendons]
    for actor in ("hand", "object", "obj", "obj/"):
        got, want = dr._actor_masks(t.model, actor), jdr._actor_masks(jt.model, actor)
        for k in ("body", "geom", "dof", "tendon"):
            assert (got[k] is None) == (want[k] is None), (actor, k)
            if got[k] is not None:
                np.testing.assert_array_equal(got[k], want[k])
    obj = dr._actor_masks(t.model, "obj")
    assert obj["body"].sum() == 1 and obj["dof"].sum() == 0 and obj["tendon"].sum() == 0
    assert t.dr_config == jt.dr_config
    ent, _, _, freq = dr.parse_randomization_params(t.dr_config, t.model)
    jent, _, _, jfreq = jdr.parse_randomization_params(jt.dr_config, jt.model)
    assert [(e["leaf"], e["setup_only"]) for e in ent] == \
        [(e["leaf"], e["setup_only"]) for e in jent] and freq == jfreq == 720


@pytest.mark.parametrize("setup", [True, False])
def test_shadow_hand_dr_fn_matches_jax(hands, setup):
    """ShadowHand's whole block (tendon, dof, mass, friction, gravity, object
    scale) on fed draws, from randomised parameters: entries on one leaf
    replace each other, as in the JAX package."""
    jt, t = hands
    jfn, _ = jdr.make_dr_fn(jt.dr_config, jt.model)
    fn, _ = dr.make_dr_fn(t.dr_config, t.model)
    jbase = jt.model.default_params().batch(4)
    jcur = jax.tree.map(lambda x: x * 1.01 if x.dtype == jnp.float32 else x, jbase)
    keys = jax.random.split(jax.random.key(5), 4)
    gs = 123
    # one jit for JAX's event and its draws
    want, draws = jax.jit(lambda ks, p, b: (
        jax.vmap(lambda k, p1, b1: jfn(k, p1, b1, gs, setup=setup))(ks, p, b),
        _jax_draws(fn.entries, ks, jt.model.default_params(), setup)))(keys, jcur, jbase)
    got = fn.apply(_torch_draws(draws), convert.model_params(jax.tree.map(np.asarray, jcur)),
                   convert.model_params(jax.tree.map(np.asarray, jbase)), torch.tensor(gs), setup)
    _close_params(got, convert.model_params(jax.tree.map(np.asarray, want)), atol=1e-5, rtol=1e-6)


# ---- through make and the env ----
def test_dr_end_to_end_env():
    _, env = _cartpole()
    state = env.reset(0)
    assert torch.unique(state.params.body_mass[:, -1]).numel() > 1
    assert set(state.dr_corr) == {"obs", "act"}
    for _ in range(3):
        state = env.step(state, torch.zeros(B, 1))
    assert torch.isfinite(state.obs).all()


def test_yaml_dr_block_roundtrip():
    txt = """
task:
  randomize: true
  randomization_params:
    frequency: 600
    actor_params:
      cartpole:
        rigid_body_properties:
          mass: {range: [0.8, 1.2], operation: scaling, distribution: uniform}
"""
    env = tgt.make("Cartpole", num_envs=4, seed=1, cfg=yaml.safe_load(txt), device="cpu")
    state = env.reset(1)
    assert torch.unique(state.params.body_mass[:, -1]).numel() > 1
    assert state.dr_corr == {}
    off = tgt.make("Cartpole", num_envs=4, seed=1, device="cpu",
                   cfg={"task": {"randomize": False,
                                 "randomization_params": yaml.safe_load(txt)["task"]
                                 ["randomization_params"]}})
    assert off.task.dr_config is None and not off._dr_any


@pytest.mark.parametrize("task, yaml_name", [
    ("ShadowHand", "ShadowHand"), ("AllegroHand", "AllegroHand"), ("Ant", "Ant"),
    ("Anymal", "Anymal"), ("HumanoidMJCF", "Humanoid"), ("HumanoidAMP", "HumanoidAMP")])
def test_make_with_randomize_matches_jax(task, yaml_name):
    """make with the task YAML and task.randomize: true takes the YAML's
    block over the task's own dr_config, as the JAX make does, and parses
    it into the JAX parser's entries on the same scene; the setup DR runs."""
    with open(f"cfg/task/{yaml_name}.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["task"]["randomize"] = True
    block = copy.deepcopy(cfg["task"]["randomization_params"])
    env = tgt.make(task, num_envs=4, seed=0, cfg=cfg, device="cpu")
    assert env.task.dr_config == block
    got = [(e["leaf"], e["setup_only"], None if e["mask"] is None else tuple(e["mask"]))
           for e in env._dr_fn.entries]
    want = [(e["leaf"], e["setup_only"], None if e["mask"] is None else tuple(e["mask"]))
            for e in jdr.parse_randomization_params(block, env.task.model)[0]]
    assert got == want and got
    assert env._dr_freq == int(block.get("frequency", 600))
    state = env.reset(0)
    assert sorted(state.dr_corr) == sorted(
        n for n, k in (("act", "actions"), ("obs", "observations"))
        if "range_correlated" in (block.get(k) or {}))
    assert all(bool(torch.isfinite(getattr(state.params, f.name).float()).all())
               for f in dataclasses.fields(state.params))


def test_humanoid_mjcf_randomize_sets_jax_dr_config(monkeypatch):
    """HumanoidMJCF(randomize=True) takes the JAX class's mass
    randomisation: every 600 steps, mass x U(0.9, 1.1). (The JAX
    constructor's spawn-height solve, seconds of jit and not read here, is
    stubbed.)"""
    from thormang_isaacgym_tpu.tasks import common as jcommon
    from thormang_isaacgym_tpu.tasks.humanoid import HumanoidMJCF as JHumanoidMJCF
    from thormang_isaacgym_tpu_torch.tasks.humanoid import HumanoidMJCF
    monkeypatch.setattr(jcommon, "solve_spawn_height", lambda *a, **k: 1.0)
    t = HumanoidMJCF(num_envs=4, device="cpu", randomize=True)
    assert t.dr_config == JHumanoidMJCF(num_envs=4, randomize=True).dr_config
    assert HumanoidMJCF(num_envs=4, device="cpu").dr_config is None
    env = tgt.make("HumanoidMJCF", num_envs=4, device="cpu", randomize=True)
    ratio = env.reset(0).params.body_mass / env.base_params("cpu", 4).body_mass
    assert float(ratio.min()) >= 0.9 and float(ratio.max()) <= 1.1
    assert torch.unique(ratio[:, 1]).numel() == 4


def _port_state(env, js):
    """The port EnvState holding JAX state `js`'s values (Cartpole)."""
    t = convert._leaf
    ts = env.init_fn(0)
    return dataclasses.replace(
        ts, q=t(js.q, "cpu"), qd=t(js.qd, "cpu"), obs=t(js.obs, "cpu"),
        params=convert.model_params(jax.tree.map(np.asarray, js.params)),
        reward=t(js.reward, "cpu"), done=t(js.done, "cpu"), timeout=t(js.timeout, "cpu"),
        progress=t(js.progress, "cpu", torch.int64), episode=t(js.episode, "cpu", torch.int64),
        global_step=t(js.global_step, "cpu", torch.int64),
        last_rand=t(js.last_rand, "cpu", torch.int64),
        episode_return=t(js.episode_return, "cpu"),
        last_episode_return=t(js.last_episode_return, "cpu"),
        dr_corr={k: t(v, "cpu") for k, v in js.dr_corr.items()})


@pytest.fixture(scope="module")
def step_pair():
    """JAX and port Cartpole under STEP_DR, the reset made deterministic in
    both (the packages' reset draws differ by design)."""
    jenv, env = _cartpole(STEP_DR)
    q0 = np.array([0.05, -0.1], np.float32)
    qd0 = np.array([0.2, 0.3], np.float32)
    jenv.task.reset_fn = lambda key, params, task: (jnp.asarray(q0), jnp.asarray(qd0),
                                                     params, task)
    env.task.reset_fn = lambda rng, params, task: (
        torch.as_tensor(q0).expand(B, 2).clone(), torch.as_tensor(qd0).expand(B, 2).clone(),
        params, task)
    return jenv, env, jax.jit(jenv.init_fn)(jax.random.key(4))


def test_init_matches_jax_with_fed_draws(step_pair, monkeypatch):
    """init_fn's setup DR (every entry, setup_only too) and its correlated
    samples, on the JAX package's draws."""
    jenv, env, js = step_pair
    k, _ = jax.random.split(jax.random.key(4))
    keys = _env_keys(k, jnp.zeros(B, jnp.int32), 0)
    base = jenv.task.model.default_params()
    draws = _torch_draws(_jax_draws(env._dr_fn.entries, keys, base, True))
    corr = {n: torch.as_tensor(np.asarray(_jax_std(
        STEP_DR[full], jax.random.fold_in(jax.random.fold_in(k, 31), salt), (B, dim))))
        for n, full, salt, dim in (("obs", "observations", 101, 4), ("act", "actions", 102, 1))}
    monkeypatch.setattr(env, "dr_draws", lambda rng, base_, setup: draws if setup else None)
    monkeypatch.setattr(env, "corr_draws", lambda seed, episode: corr)
    state = env.init_fn(0)
    _close_params(state.params, convert.model_params(jax.tree.map(np.asarray, js.params)), **TOL)
    for n in ("obs", "act"):
        _close(state.dr_corr[n], js.dr_corr[n], atol=0, rtol=0)
    _close(state.obs, js.obs, atol=1e-5)
    assert int(state.global_step) == 0 and not bool(state.last_rand.any())


def test_step_matches_jax_with_fed_draws(step_pair, monkeypatch):
    """One step_fn at global_step 25 with envs 0, 1, 3, 4 and 6 resetting,
    envs 1 and 4 randomised less than `frequency` (10) steps ago: due,
    the event's parameters (from the defaults, not compounding), last_rand,
    the redrawn correlated samples of the due envs, the action noise before
    the clip and the observation noise before the clip, on the JAX
    package's draws."""
    jenv, env, js = step_pair
    done = np.array([1, 1, 0, 1, 1, 0, 1, 0], np.float32)
    last = np.array([0, 20, 0, 5, 18, 0, 0, 3], np.int32)
    js = dataclasses.replace(js, done=jnp.asarray(done), last_rand=jnp.asarray(last),
                             global_step=jnp.asarray(25, jnp.int32),
                             episode=jnp.arange(B, dtype=jnp.int32),
                             progress=jnp.full(B, 7, jnp.int32))
    actions = np.linspace(-1.2, 1.2, B, dtype=np.float32)[:, None]
    js2 = jax.jit(jenv.step_fn)(js, jnp.asarray(actions))
    # the JAX package's draws of this step
    key = jax.random.fold_in(js.key, 1)
    episode = js.episode + (js.done > 0).astype(jnp.int32)
    dr_keys = _env_keys(jax.random.fold_in(key, 23), episode, 29)
    draws = _torch_draws(_jax_draws(env._dr_fn.entries, dr_keys,
                                    jenv.task.model.default_params(), False))
    ck = jax.random.fold_in(key, 37)
    corr = {n: torch.as_tensor(np.asarray(_jax_std(STEP_DR[full], jax.random.fold_in(ck, salt),
                                                   (B, dim))))
            for n, full, salt, dim in (("obs", "observations", 101, 4), ("act", "actions", 102, 1))}
    noise = {n: torch.as_tensor(np.asarray(_jax_std(STEP_DR[full], jax.random.fold_in(key, salt),
                                                    shape)))
             for n, full, salt, shape in (("act", "actions", 5, (B, 1)),
                                          ("obs", "observations", 7, (B, 4)))}
    s0 = _port_state(env, js)
    monkeypatch.setattr(env, "dr_draws", lambda rng, base, setup: draws)
    monkeypatch.setattr(env, "corr_draws", lambda seed, ep: corr)
    monkeypatch.setattr(env, "noise_draw", lambda name, rng, x: noise[name])
    s1 = env.step_fn(s0, torch.as_tensor(actions))
    due = np.array([1, 0, 0, 1, 0, 0, 1, 0], bool)
    np.testing.assert_array_equal(_np(s1.last_rand), np.where(due, 25, last))
    np.testing.assert_array_equal(_np(s1.last_rand), np.asarray(js2.last_rand))
    assert int(s1.global_step) == int(js2.global_step) == 26
    _close_params(s1.params, convert.model_params(jax.tree.map(np.asarray, js2.params)), **TOL)
    # not due: the parameters stay as they were
    for f in dataclasses.fields(s1.params):
        np.testing.assert_array_equal(_np(getattr(s1.params, f.name))[~due],
                                      _np(getattr(s0.params, f.name))[~due])
    for n in ("obs", "act"):
        _close(s1.dr_corr[n], js2.dr_corr[n], atol=0, rtol=0)
        np.testing.assert_array_equal(_np(s1.dr_corr[n])[~due], _np(s0.dr_corr[n])[~due])
    for f in ("q", "qd", "obs", "reward", "done", "timeout"):
        _close(getattr(s1, f), getattr(js2, f), atol=1e-5, rtol=1e-5, msg=f)


def test_noise_changes_every_step():
    """The per-step noise streams are keyed on global_step: two steps of one
    episode from the same state draw different noise, a replay the same."""
    spec = {"observations": {"range": [0, 0.5], "operation": "additive",
                             "distribution": "gaussian"},
            "actions": {"range": [0, 0.5], "operation": "additive",
                        "distribution": "gaussian"}}
    env = tgt.make("Cartpole", num_envs=4, seed=0, device="cpu",
                   cfg={"task": {"randomize": True, "randomization_params": spec}})
    s = env.reset(0)
    a = torch.zeros(4, 1)
    o1 = env.step(s, a).obs
    o1b = env.step(s, a).obs
    o2 = env.step(dataclasses.replace(s, global_step=s.global_step + 1), a).obs
    assert torch.equal(o1, o1b)
    assert (o1 - o2).abs().min() > 1e-4
    r1 = env.step_random(s, "obs_noise").uniform(3)
    r2 = env.step_random(dataclasses.replace(s, global_step=s.global_step + 1),
                         "obs_noise").uniform(3)
    assert not torch.equal(r1, r2)
