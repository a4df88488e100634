"""Domain randomisation. Port of ``thormang_isaacgym_tpu/engine/dr.py``.

The reference's ``randomization_params`` schema (``vec_task.py:496-768``):
distributions (gaussian / uniform / loguniform), operations (additive /
scaling), linear and constant schedules, correlated and uncorrelated
observation / action noise, ``setup_only``, friction ``num_buckets``, actor
``scale``, the gravity of ``sim_params`` and the per-actor rigid_body /
rigid_shape / dof / tendon blocks. Every randomisation is a masked update of
a batched ``ModelParams`` leaf, applied to all envs at once.

The JAX package maps a single-env function over the envs; here every
function works on the whole env axis: a leaf is (B, ...), a per-actor mask
(k,) lines up with the leaf's axis 1. Each entry is split in two:

- a *draw*: the standard samples of one event, (B, *leaf shape), U[0, 1)
  for uniform and loguniform, N(0, 1) for gaussian, from the per-env
  counter-based streams of ``engine/env.py``'s ``EnvRandom``;
- an *apply*: schedule, range, bucketing and the operation on the model's
  default parameters, so repeated events never compound.

The JAX package draws the same standard samples from threefry keys; the
tests feed those to the apply step.

Property name -> ModelParams leaf is ``_LEAF_MAP``; ``scale`` maps to
mass s^3, inertia s^5, com s (the collision geometry stays unscaled, as in
the JAX package: the contact tables hold static geom sizes).
``geom_restitution`` is randomised as a leaf but no physics reads it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.models.robot import ModelParams, RobotModel

# (group, prop) -> (leaf name, mask kind): the model index space the
# per-actor mask lives in
_LEAF_MAP = {
    ("rigid_body_properties", "mass"): ("body_mass", "body"),
    ("rigid_shape_properties", "friction"): ("geom_friction", "geom"),
    ("rigid_shape_properties", "restitution"): ("geom_restitution", "geom"),
    ("dof_properties", "damping"): ("dof_damping", "dof"),
    ("dof_properties", "stiffness"): ("drive_stiffness", "dof"),
    ("dof_properties", "friction"): ("dof_friction", "dof"),
    ("dof_properties", "armature"): ("dof_armature", "dof"),
    ("dof_properties", "lower"): ("dof_lower", "dof"),
    ("dof_properties", "upper"): ("dof_upper", "dof"),
    ("dof_properties", "velocity"): ("dof_velocity_limit", "dof"),
    ("tendon_properties", "stiffness"): ("tendon_stiffness", "tendon"),
    ("tendon_properties", "damping"): ("tendon_damping", "tendon"),
}
GAUSSIAN = ("gaussian", "normal")
_DISTRIBUTIONS = ("uniform", "loguniform") + GAUSSIAN


def _sched_scale(spec: dict, global_step):
    """The schedule's factor (vec_task.py:584-590): linear ramps 0 -> 1 over
    schedule_steps, constant switches 0 -> 1 at schedule_steps; 1.0 (a
    Python float) without a schedule."""
    sched = spec.get("schedule")
    if sched is None:
        return 1.0
    steps = float(spec.get("schedule_steps", 1))
    gs = torch.as_tensor(global_step).to(torch.float32)
    if sched == "linear":
        return torch.clamp(gs / steps, max=1.0)
    if sched == "constant":
        return (gs >= steps).to(torch.float32)
    raise ValueError(f"unknown schedule {sched!r}")


def _sched_range(spec: dict, rng, s):
    """The range under the schedule (vec_task.py:592-605, 624-637): additive
    ranges scale toward 0, scaling ranges toward the identity 1."""
    lo, hi = float(rng[0]), float(rng[1])
    op = spec.get("operation", "scaling")
    dist = spec.get("distribution", "uniform")
    if op == "additive":
        return lo * s, hi * s
    if dist in GAUSSIAN:
        # (mu, var): mu -> lerp to 1, var -> scale down
        return lo * s + (1.0 - s), hi * s
    if dist == "loguniform":
        if isinstance(s, float):
            return lo ** s, hi ** s
        return (torch.exp(torch.log(torch.tensor(lo, dtype=torch.float32)) * s),
                torch.exp(torch.log(torch.tensor(hi, dtype=torch.float32)) * s))
    return lo * s + (1.0 - s), hi * s + (1.0 - s)


def standard_normal(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Box-Muller on two uniforms in [0, 1): 1 - u1 lies in (0, 1], so the
    log is finite where a uniform is exactly 0."""
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos((2.0 * math.pi) * u2)


def standard_draw(dist: str, rng, shape: tuple) -> torch.Tensor:
    """(B, *shape) standard samples of `dist` from `rng` (an EnvRandom):
    N(0, 1) for gaussian, else U[0, 1)."""
    if dist not in _DISTRIBUTIONS:
        raise ValueError(f"unknown distribution {dist}")
    n = int(np.prod(shape, dtype=np.int64))
    if dist in GAUSSIAN:
        u = rng.uniform(2 * n)
        z = standard_normal(u[:, :n], u[:, n:])
    else:
        z = rng.uniform(n)
    return z.reshape((z.shape[0],) + tuple(shape))


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _sample(spec: dict, std: torch.Tensor, lo, hi) -> torch.Tensor:
    """The sample of `spec`'s distribution over (lo, hi) from its standard
    sample (the JAX package's ``_sample`` with its draw given)."""
    dist = spec.get("distribution", "uniform")
    if dist == "uniform":
        return lo + std * (hi - lo)
    if dist in GAUSSIAN:
        return lo + std * hi
    if dist == "loguniform":
        llo, lhi = torch.log(_f32(lo, std)), torch.log(_f32(hi, std))
        return torch.exp(llo + std * (lhi - llo))
    raise ValueError(f"unknown distribution {dist}")


def _bucketize(sample, spec: dict, lo, hi):
    """Friction ``num_buckets``: the sample rounded onto n evenly spaced
    values over [lo, hi] (the reference's material-count cap)."""
    n = int(spec.get("num_buckets", 0))
    if n <= 0:
        return sample
    edges = torch.round((sample - lo) / (hi - lo + 1e-12) * (n - 1))
    return lo + edges * (hi - lo) / (n - 1)


def _apply(op: str, base, sample):
    if op == "scaling":
        return base * sample
    if op == "additive":
        return base + sample
    raise ValueError(f"unknown operation {op}")


def _actor_masks(model: RobotModel | None, actor_name: str) -> dict:
    """Index masks (body / geom / dof / tendon) of one named actor: bodies
    and joints whose names start with ``<actor>/``, tendons whose name
    (``t[3]``) does. A single-actor model or an unmatched name applies
    everywhere (None)."""
    none = {k: None for k in ("body", "geom", "dof", "tendon")}
    if model is None:
        return none
    prefix = actor_name.rstrip("/") + "/"
    body_m = np.array([1.0 if bn.startswith(prefix) else 0.0
                       for bn in model.body_names], np.float32)
    if body_m.sum() == 0:
        return none
    geom_m = np.array([body_m[g.body] for g in model.geoms], np.float32)
    dof_m = np.array([1.0 if jn.startswith(prefix) else 0.0
                      for jn in model.joint_names], np.float32)
    tendon_m = np.array([1.0 if (len(t) > 3 and str(t[3]).startswith(prefix)) else 0.0
                         for t in model.tendons], np.float32)
    return {"body": body_m, "geom": geom_m, "dof": dof_m, "tendon": tendon_m}


def _masked(base: torch.Tensor, new: torch.Tensor, mask) -> torch.Tensor:
    """`new` where the (k,) mask is set, else `base`; both (B, k, ...): the
    mask lines up with axis 1, (1, k, 1, ...)."""
    if mask is None:
        return new
    m = torch.as_tensor(mask, device=base.device)
    m = m.reshape((1,) + tuple(m.shape) + (1,) * (base.dim() - 1 - m.dim()))
    return torch.where(m > 0, new, base)


def parse_randomization_params(rp: dict, model: RobotModel | None = None):
    """A reference-shaped ``randomization_params`` block -> (entries,
    obs_spec, act_spec, frequency); entries are dicts {leaf, spec, mask,
    setup_only}, the actor scale's leaf ``__scale__``."""
    entries = []
    sim = rp.get("sim_params", {})
    if "gravity" in sim:
        entries.append(dict(leaf="gravity", spec=sim["gravity"], mask=None,
                            setup_only=bool(sim["gravity"].get("setup_only", False))))
    for actor, groups in rp.get("actor_params", {}).items():
        masks = _actor_masks(model, actor)
        for group, props in groups.items():
            if group == "color":
                continue   # visual only
            if group == "scale":
                spec = props if isinstance(props, dict) else {}
                if "range" in spec:
                    entries.append(dict(leaf="__scale__", spec=spec, mask=masks["body"],
                                        setup_only=bool(spec.get("setup_only", False))))
                continue
            if not isinstance(props, dict):
                continue
            for prop, spec in props.items():
                if not isinstance(spec, dict) or "range" not in spec:
                    continue
                hit = _LEAF_MAP.get((group, prop))
                if hit is None:
                    continue
                leaf, kind = hit
                entries.append(dict(leaf=leaf, spec=spec, mask=masks[kind],
                                    setup_only=bool(spec.get("setup_only", False))))
    return (entries, rp.get("observations"), rp.get("actions"),
            int(rp.get("frequency", 600)))


def _entry_shape(e: dict, base_params: ModelParams) -> tuple:
    """The per-env shape of an entry's draw."""
    leaf = "body_mass" if e["leaf"] == "__scale__" else e["leaf"]
    return tuple(getattr(base_params, leaf).shape[1:])


def _apply_entry(e: dict, std: torch.Tensor, params: ModelParams,
                 base_params: ModelParams, global_step) -> dict:
    spec = e["spec"]
    s = _sched_scale(spec, global_step)
    lo, hi = _sched_range(spec, spec["range"], s)
    m = e["mask"]
    if e["leaf"] == "__scale__":
        sc = _sample(spec, std, lo, hi)
        return {
            "body_mass": _masked(params.body_mass, base_params.body_mass * sc ** 3, m),
            "body_inertia": _masked(params.body_inertia,
                                    base_params.body_inertia * (sc ** 5)[..., None, None], m),
            "body_com": _masked(params.body_com, base_params.body_com * sc[..., None], m),
        }
    base = getattr(base_params, e["leaf"])
    sample = _bucketize(_sample(spec, std, lo, hi), spec, lo, hi)
    new = _apply(spec.get("operation", "scaling"), base, sample)
    return {e["leaf"]: _masked(getattr(params, e["leaf"]), new.to(base.dtype), m)}


class DRFn:
    """The parameter randomisation of a config: ``draw`` then ``apply``, or
    both in one call. An event at init (``setup``) also runs the
    ``setup_only`` entries."""

    def __init__(self, entries: list):
        self.entries = entries

    def running(self, setup: bool) -> list:
        """Indices of the entries an event runs."""
        return [i for i, e in enumerate(self.entries) if setup or not e["setup_only"]]

    def draw(self, rng, base_params: ModelParams, setup: bool = False) -> dict:
        """{entry index: (B, *leaf shape) standard samples} from `rng`."""
        return {i: standard_draw(self.entries[i]["spec"].get("distribution", "uniform"), rng,
                                 _entry_shape(self.entries[i], base_params))
                for i in self.running(setup)}

    def apply(self, draws: dict, params: ModelParams, base_params: ModelParams,
              global_step=0, setup: bool = False) -> ModelParams:
        """Each entry writes its leaf from the defaults; where its mask is
        clear it keeps `params`' value, as it was before the event (a later
        entry on the same leaf replaces an earlier one, as in the JAX
        package)."""
        updates = {}
        for i in self.running(setup):
            updates.update(_apply_entry(self.entries[i], draws[i], params, base_params,
                                        global_step))
        return dataclasses.replace(params, **updates) if updates else params

    def __call__(self, rng, params: ModelParams, base_params: ModelParams,
                 global_step=0, setup: bool = False) -> ModelParams:
        return self.apply(self.draw(rng, base_params, setup), params, base_params,
                          global_step, setup)


def make_dr_fn(dr_config: dict | None, model: RobotModel | None = None):
    """-> (DRFn, whether it has any entry). `dr_config` is a reference
    ``randomization_params`` block (or the flat dict of its sim_params /
    actor_params)."""
    entries, _, _, _ = parse_randomization_params(dr_config or {}, model)
    return DRFn(entries), len(entries) > 0


class NoiseFn:
    """Observation or action noise (vec_task.py:576-646): gaussian or
    uniform, additive or scaling, under its schedule, plus the correlated
    part ``corr`` (the per-env standard sample held between DR events)."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.op = spec.get("operation", "additive")
        self.dist = spec.get("distribution", "uniform")

    def draw(self, rng, x: torch.Tensor) -> torch.Tensor:
        """Standard samples shaped like `x` (B, ...) from `rng`."""
        return standard_draw(self.dist, rng, tuple(x.shape[1:]))

    def apply(self, std: torch.Tensor, x: torch.Tensor, corr=None, global_step=0):
        spec = self.spec
        s = _sched_scale(spec, global_step)
        lo, hi = _sched_range(spec, spec["range"], s)
        noise = _sample(spec, std, lo, hi)
        if corr is not None and "range_correlated" in spec:
            clo, chi = _sched_range(spec, spec["range_correlated"], s)
            if self.dist in GAUSSIAN:
                noise = noise + corr * chi + clo
            else:
                noise = noise + corr * (chi - clo) + clo
        return _apply(self.op, x, noise)

    def __call__(self, rng, x, corr=None, global_step=0):
        return self.apply(self.draw(rng, x), x, corr, global_step)


def make_noise_fn(noise_cfg: dict | None) -> NoiseFn | None:
    if not noise_cfg or "range" not in noise_cfg:
        return None
    return NoiseFn(noise_cfg)
