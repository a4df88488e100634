"""Multi-actor scene composition. Port of ``thormang_isaacgym_tpu/models/scene.py``.

N single-actor RobotModels compose into ONE forest-structured RobotModel
whose sweeps run unchanged: bodies are renumbered so that every actor's root
comes first (depth 0) and each deeper level stays contiguous (depth-major,
actor-minor, original order last).

State layout of the composed model:
  q  = [7 values per FLOATING root (actor order), all joint_q]
  qd = [6 values per floating root, all joint_qd]
Fixed-base actors contribute no root state; their pose is the static
``base_pose`` given at composition (``root_base_pose``).
"""
from __future__ import annotations

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.models.robot import Geom, RobotModel

_BODY_KEYS = ("body_mass", "body_com", "body_inertia", "body_gravity_scale")
_JOINT_KEYS = ("dof_armature", "dof_damping", "dof_friction", "dof_lower",
               "dof_upper", "dof_velocity_limit", "drive_mode",
               "drive_stiffness", "drive_damping", "drive_effort_limit",
               "dof_locked", "dof_locked_pos")
_GEOM_KEYS = ("geom_friction", "geom_restitution")


def _depths(m: RobotModel) -> np.ndarray:
    d = np.zeros(m.nb, np.int32)
    for b in range(m.nb):
        if m.parent[b] >= 0:
            d[b] = d[m.parent[b]] + 1
    return d


def compose(actors, name: str = "scene") -> RobotModel:
    """actors: list of (model, base_pose) or (model, base_pose, prefix).

    base_pose: 7-tuple (pos3, quat4 wxyz): the static pose of a fixed-base
    actor, the default pose of a floating one. Body, joint, geom and site
    names get ``prefix`` (default: ``{model.name}{i}/`` when names collide,
    else none)."""
    models = [a[0] for a in actors]
    poses = [tuple(a[1]) for a in actors]
    prefixes = [a[2] if len(a) > 2 else None for a in actors]
    all_names = [n for m in models for n in m.body_names + m.joint_names]
    need_prefix = len(set(all_names)) != len(all_names)
    for i, m in enumerate(models):
        if prefixes[i] is None:
            prefixes[i] = f"{m.name}{i}/" if need_prefix else ""

    depths = [_depths(m) for m in models]
    max_depth = max(int(d.max()) for d in depths)
    order = [(ai, b) for dep in range(max_depth + 1)
             for ai, m in enumerate(models) for b in range(m.nb) if depths[ai][b] == dep]
    new_index = {ab: i for i, ab in enumerate(order)}

    body_names, parent, body_actor = [], [], []
    jnames, jtype, jaxis, jpos, jquat = [], [], [], [], []
    dnew = {k: [] for k in _BODY_KEYS + _JOINT_KEYS + _GEOM_KEYS}
    joint_new = {}                      # (actor, old joint) -> new joint
    for ai, b in order:
        m, pfx = models[ai], prefixes[ai]
        body_names.append(pfx + m.body_names[b])
        body_actor.append(ai)
        p = m.parent[b]
        parent.append(-1 if p < 0 else new_index[(ai, p)])
        for k in _BODY_KEYS:
            dnew[k].append(np.asarray(m._defaults[k])[b])
        if p >= 0:
            j = b - m.n_roots
            joint_new[(ai, j)] = len(jnames)
            jnames.append(pfx + m.joint_names[j])
            jtype.append(m.joint_type[j])
            jaxis.append(m.joint_axis[j])
            jpos.append(m.joint_pos[j])
            jquat.append(m.joint_quat[j])
            for k in _JOINT_KEYS:
                dnew[k].append(np.asarray(m._defaults[k])[j])

    geoms, sites = [], {}
    for ai, m in enumerate(models):
        pfx = prefixes[ai]
        for g in m.geoms:
            geoms.append(Geom(body=new_index[(ai, g.body)], gtype=g.gtype, size=g.size,
                              pos=g.pos, quat=g.quat, name=pfx + g.name, ground=g.ground))
        for k in _GEOM_KEYS:
            dnew[k].extend(np.asarray(m._defaults[k]).tolist())
        for sname, (b, p, qt) in (m.sites or {}).items():
            sites[pfx + sname] = (new_index[(ai, b)], p, qt)

    defaults = {k: np.asarray(v, np.int32 if k == "drive_mode" else np.float32)
                for k, v in dnew.items()}
    defaults["gravity"] = np.asarray(models[0]._defaults["gravity"], np.float32)

    # fixed tendons: each actor's coefficient vectors in the composed joint
    # numbering; per-tendon parameters concatenated in actor order
    nj = len(jnames)
    tendons, t_stiff, t_damp = [], [], []
    for ai, m in enumerate(models):
        nt = len(m.tendons)
        t_stiff.extend(np.asarray(m._defaults.get("tendon_stiffness", np.zeros(nt))).tolist())
        t_damp.extend(np.asarray(m._defaults.get("tendon_damping", np.zeros(nt))).tolist())
        for coef, lo, hi, tname in m.tendons:
            new_coef = np.zeros(nj, np.float32)
            for j_old, c in enumerate(np.asarray(coef)):
                if c != 0.0:
                    new_coef[joint_new[(ai, j_old)]] = c
            tendons.append((tuple(new_coef.tolist()), lo, hi, prefixes[ai] + tname))
    defaults["tendon_stiffness"] = np.asarray(t_stiff, np.float32)
    defaults["tendon_damping"] = np.asarray(t_damp, np.float32)

    root_floating = tuple(bool(m.roots_floating[0]) for m in models)
    return RobotModel(
        name=name, body_names=tuple(body_names), parent=tuple(parent),
        joint_names=tuple(jnames), joint_type=tuple(jtype), joint_axis=tuple(jaxis),
        joint_pos=tuple(jpos), joint_quat=tuple(jquat), dof_index=tuple(range(nj)),
        floating=root_floating[0], geoms=tuple(geoms), sites=sites,
        tendons=tuple(tendons), _defaults=defaults, n_roots=len(models),
        root_floating=root_floating, root_base_pose=tuple(poses),
        body_actor=tuple(body_actor))


def scene_q(model: RobotModel, root_states, joint_q, device="cpu") -> torch.Tensor:
    """One q vector: ``root_states`` are the 7-vectors of the FLOATING roots
    in actor order (fixed actors skipped), then ``joint_q``."""
    parts = [np.asarray(r, np.float32).reshape(7) for r in root_states]
    q = np.concatenate(parts + [np.asarray(joint_q, np.float32).reshape(-1)])
    if q.shape[0] != model.nq:
        raise ValueError(f"scene_q: {q.shape[0]} values for nq = {model.nq}")
    return torch.as_tensor(q, device=device)
