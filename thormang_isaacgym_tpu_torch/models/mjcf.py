"""MJCF (MuJoCo XML) -> RobotModel compiler (numpy/XML only).

Port of ``thormang_isaacgym_tpu/models/mjcf.py``; the arithmetic is
unchanged, so both packages compile an asset to the same defaults. It covers
the subset the classic models (``assets/mjcf/nv_humanoid.xml``,
``nv_ant.xml``) use:

- ``<compiler angle="degree|radian">``, nested ``<default>`` classes for
  joint / geom / motor (class attribute + childclass scoping)
- a recursive ``<body>`` tree with pos / quat / euler frames
- ``<joint type="hinge|slide|free">`` with axis / range / damping /
  armature / stiffness; several 1-DOF joints on one body (abdomen_z/y/x)
  expand into a chain of near-massless intermediate links
- ``<geom type="sphere|capsule|box|cylinder">`` from size or fromto;
  ``<inertial>`` when present, else mass from geom volume x density
- ``<actuator><motor joint=... gear=...>`` -> ``model.motor_efforts``, the
  per-DOF effort scale the tasks read
"""
from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET

import numpy as np

from thormang_isaacgym_tpu_torch.models.robot import (
    Geom, GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE, RobotModel,
    make_defaults,
)

_GEOM_TYPES = {"sphere": GEOM_SPHERE, "capsule": GEOM_CAPSULE,
               "box": GEOM_BOX, "cylinder": GEOM_CYLINDER}


def _floats(s, n=None):
    v = [float(x) for x in s.split()]
    return v if n is None else (v + [0.0] * n)[:n]


def _quat_from_euler_deg(e, degree):
    r, p, y = [(math.radians(a) if degree else a) for a in e]
    cr, sr = math.cos(r / 2), math.sin(r / 2)
    cp, sp = math.cos(p / 2), math.sin(p / 2)
    cy, sy = math.cos(y / 2), math.sin(y / 2)
    return [cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy]


def _merge(base: dict, el) -> dict:
    out = dict(base)
    out.update(el.attrib)
    return out


class _Ctx:
    """Default-class resolution (MJCF <default> nesting)."""

    def __init__(self):
        self.classes = {None: {"joint": {}, "geom": {}, "motor": {}}}

    def load(self, el, parent=None, name=None):
        cls = {k: dict(v) for k, v in self.classes[parent].items()}
        for tag in ("joint", "geom", "motor"):
            sub = el.find(tag)
            if sub is not None:
                cls[tag].update(sub.attrib)
        self.classes[name] = cls
        for child in el.findall("default"):
            self.load(child, parent=name, name=child.get("class"))

    def get(self, tag, el, childclass):
        cls = el.get("class", childclass)
        base = self.classes.get(cls, self.classes[None])[tag]
        return _merge(base, el)


def load_mjcf(path_or_string: str, *, name: str | None = None,
              armature: float = 0.0, fix_base_link: bool = False,
              default_density: float = 1000.0) -> RobotModel:
    if os.path.exists(path_or_string):
        root_el = ET.parse(path_or_string).getroot()
        default_name = os.path.splitext(os.path.basename(path_or_string))[0]
    else:
        root_el = ET.fromstring(path_or_string)
        default_name = root_el.get("model", "mjcf")
    model_name = name or root_el.get("model", default_name)

    comp = root_el.find("compiler")
    degree = (comp is None) or comp.get("angle", "degree") == "degree"
    ctx = _Ctx()
    for d in root_el.findall("default"):
        ctx.load(d, name=d.get("class"))

    bodies = []          # dicts: name, parent(idx), jpos, jquat, jaxis, jtype...
    geoms_out = []
    motor_table = {}     # joint name -> gear

    def parse_geom(gel, body_idx, childclass, density_accum, shift=None):
        g = ctx.get("geom", gel, childclass)
        gt = g.get("type", "sphere")
        if gt not in _GEOM_TYPES:
            return
        density = float(g.get("density", default_density))
        shift = np.zeros(3) if shift is None else shift
        pos = np.array(_floats(g.get("pos", "0 0 0"), 3))
        quat = np.array([1.0, 0, 0, 0])
        size = _floats(g.get("size", "0"))
        if "fromto" in g:
            ft = _floats(g["fromto"], 6)
            a, b = np.array(ft[:3]), np.array(ft[3:])
            pos = (a + b) / 2 + shift
            d = b - a
            length = float(np.linalg.norm(d))
            if length > 1e-9:
                z = d / length
                # quat rotating local z onto d
                ref = np.array([0.0, 0, 1.0])
                v = np.cross(ref, z)
                c = float(ref @ z)
                if np.linalg.norm(v) < 1e-9:
                    quat = np.array([1.0, 0, 0, 0]) if c > 0 \
                        else np.array([0.0, 1.0, 0, 0])
                else:
                    s = math.sqrt((1 + c) * 2)
                    quat = np.array([s / 2, *(v / s)])
            r = size[0]
            gsize = (r, length / 2)
            # cylinder volume has no end caps; capsule adds the sphere
            vol = math.pi * r * r * length
            if gt != "cylinder":
                vol += (4 / 3) * math.pi * r ** 3
            gtype = _GEOM_TYPES[gt] if gt in ("capsule", "cylinder") \
                else GEOM_CAPSULE
        else:
            if gt == "sphere":
                r = size[0]
                gsize, vol = (r,), (4 / 3) * math.pi * r ** 3
            elif gt in ("capsule", "cylinder"):
                r, hl = size[0], size[1]
                gsize = (r, hl)
                vol = math.pi * r * r * 2 * hl + (4 / 3) * math.pi * r ** 3
            else:
                hx, hy, hz = size[0], size[1], size[2]
                gsize, vol = (hx, hy, hz), 8 * hx * hy * hz
            gtype = _GEOM_TYPES[gt]
            pos = pos + shift
        geoms_out.append(Geom(body=body_idx, gtype=gtype,
                              size=tuple(gsize), pos=tuple(pos.tolist()),
                              quat=tuple(np.asarray(quat).tolist()),
                              name=g.get("name", "")))
        density_accum.append((vol * density, pos))

    floating = [False]

    def parse_body(el, parent_idx, childclass, depth, parent_anchor):
        """parent_anchor: the parent BODY-frame offset consumed by the
        parent's joint anchor (MJCF joints rotate about `joint pos` in the
        body frame; our RobotModel puts the child frame AT the joint, so
        geoms/children shift by -anchor)."""
        childclass = el.get("childclass", childclass)
        bname = el.get("name", f"body{len(bodies)}")
        bpos = np.array(_floats(el.get("pos", "0 0 0"), 3)) - parent_anchor
        if "quat" in el.attrib:
            bquat = np.array(_floats(el.get("quat"), 4))  # mjcf: wxyz
        elif "euler" in el.attrib:
            bquat = np.array(_quat_from_euler_deg(
                _floats(el.get("euler"), 3), degree))
        else:
            bquat = np.array([1.0, 0, 0, 0])

        joints = []
        for jel in el.findall("joint"):
            j = ctx.get("joint", jel, childclass)
            jtype = j.get("type", "hinge")
            if jtype == "free":
                floating[0] = True
                continue
            rng = _floats(j.get("range", "0 0"), 2)
            if degree:
                rng = [math.radians(a) for a in rng] \
                    if jtype == "hinge" else rng
            limited = j.get("limited", "true" if "range" in j else "false")
            if limited == "false" or rng == [0.0, 0.0]:
                rng = [-1e9, 1e9] if jtype == "slide" \
                    else [-math.pi * 2, math.pi * 2]
            joints.append(dict(
                name=j.get("name", f"{bname}_j{len(joints)}"),
                type=jtype,
                axis=np.array(_floats(j.get("axis", "0 0 1"), 3)),
                pos=np.array(_floats(j.get("pos", "0 0 0"), 3)),
                lo=rng[0], hi=rng[1],
                damping=float(j.get("damping", 0.0)),
                armature=float(j.get("armature", armature)),
                stiffness=float(j.get("stiffness", 0.0)),
            ))

        density_accum = []
        idx_self = None
        # shared joint anchor (composite joints in the classic models share
        # one anchor; the first joint's pos is used for all)
        anchor = joints[0]["pos"] if joints else np.zeros(3)
        # multi-joint bodies expand: chain of intermediates, real body last
        chain_parent = parent_idx
        n = max(len(joints), 1)
        for k in range(n):
            last = k == n - 1
            nm = bname if last else f"{bname}__j{k}"
            jt = joints[k] if joints else None
            # `pos` is the full joint-frame offset in the parent link's
            # frame: the shared anchor is folded in for the FIRST chain
            # link; subsequent composite links sit at their own joint pos
            # relative to the shared anchor (zero when anchors coincide,
            # as in the classic nv_* models). Assembly below uses `pos`
            # directly — j['pos'] must NOT be added again (it is already
            # accounted for here).
            bodies.append(dict(
                name=nm, parent=chain_parent,
                pos=(bpos + anchor) if k == 0
                else (joints[k]["pos"] - anchor),
                quat=bquat if k == 0 else np.array([1.0, 0, 0, 0]),
                joint=jt, mass=0.0, com=np.zeros(3), inertia=np.zeros(3),
                real=last,
            ))
            chain_parent = len(bodies) - 1
            if last:
                idx_self = chain_parent

        inert = el.find("inertial")
        for gel in el.findall("geom"):
            parse_geom(gel, idx_self, childclass, density_accum,
                       shift=-anchor)
        b = bodies[idx_self]
        if inert is not None:
            b["mass"] = float(inert.get("mass"))
            b["com"] = np.array(_floats(inert.get("pos", "0 0 0"), 3)) \
                - anchor
            diag = _floats(inert.get("diaginertia", "0 0 0"), 3)
            b["inertia"] = np.array(diag)
        elif density_accum:
            m = sum(mm for mm, _ in density_accum)
            com = sum(mm * p for mm, p in density_accum) / max(m, 1e-9)
            b["mass"] = m
            b["com"] = com
            # crude shape-lumped inertia: solid sphere of bounding radius
            r2 = max(float(np.linalg.norm(p - com)) ** 2 + 1e-4
                     for _, p in density_accum)
            b["inertia"] = np.full(3, 0.4 * m * r2)
        for child in el.findall("body"):
            parse_body(child, idx_self, childclass, depth + 1, anchor)

    world = root_el.find("worldbody")
    roots = world.findall("body")
    if len(roots) != 1:
        raise ValueError(f"single-robot MJCF expected, found {len(roots)} root bodies")
    parse_body(roots[0], -1, None, 0, np.zeros(3))

    for act in root_el.findall("actuator"):
        for m in act.findall("motor"):
            mm = ctx.get("motor", m, None)
            motor_table[m.get("joint")] = float(mm.get("gear", 1.0))

    # ---- reorder bodies depth-major (the banded ABA sweep requires
    # BFS-contiguous levels, ops/levels.py; parse order is DFS) ----
    nb = len(bodies)
    depth = [0] * nb
    for i, b in enumerate(bodies):
        if b["parent"] >= 0:
            depth[i] = depth[b["parent"]] + 1
    order = sorted(range(nb), key=lambda i: (depth[i], i))
    remap = {old: new for new, old in enumerate(order)}
    bodies = [bodies[i] for i in order]
    for b in bodies:
        if b["parent"] >= 0:
            b["parent"] = remap[b["parent"]]
    geoms_out = [
        Geom(body=remap[g.body], gtype=g.gtype, size=g.size, pos=g.pos,
             quat=g.quat, name=g.name) for g in geoms_out]

    # ---- assemble RobotModel arrays (movable-joint tree) ----
    body_names = tuple(b["name"] for b in bodies)
    parent = tuple(b["parent"] for b in bodies)
    jnames, jtypes, jaxes, jpos, jquat = [], [], [], [], []
    lo, hi, damp, arma = [], [], [], []
    for b in bodies[1:]:
        j = b["joint"]
        if j is None:
            # jointless child body: welded via a locked slide joint
            jnames.append(b["name"] + "_weld")
            jtypes.append(2)
            jaxes.append((0.0, 0.0, 1.0))
            jpos.append(tuple(b["pos"].tolist()))
            jquat.append(tuple(b["quat"].tolist()))
            lo.append(0.0)
            hi.append(0.0)
            damp.append(0.0)
            arma.append(0.0)
            continue
        jnames.append(j["name"])
        jtypes.append(1 if j["type"] == "hinge" else 2)
        jaxes.append(tuple((j["axis"] / np.linalg.norm(j["axis"])).tolist()))
        # joint-frame offset: b['pos'] already includes the joint anchor
        # (folded in during parse_body); adding j['pos'] again would count
        # the anchor twice
        jpos.append(tuple(b["pos"].tolist()))
        jquat.append(tuple(b["quat"].tolist()))
        lo.append(j["lo"])
        hi.append(j["hi"])
        damp.append(j["damping"])
        arma.append(j["armature"])

    nj = nb - 1
    mass = np.array([max(b["mass"], 1e-3) for b in bodies], np.float32)
    com = np.stack([b["com"] for b in bodies]).astype(np.float32)
    inertia = np.zeros((nb, 3, 3), np.float32)
    for i, b in enumerate(bodies):
        d = np.asarray(b["inertia"], np.float64)
        if (d <= 0).all():
            d = np.full(3, max(mass[i] * 2.5e-3, 1e-7))
        inertia[i] = np.diag(np.maximum(d, 1e-7))

    defaults = make_defaults(
        nb, nj, len(geoms_out),
        body_mass=mass, body_com=com, body_inertia=inertia,
        dof_lower=np.array(lo, np.float32),
        dof_upper=np.array(hi, np.float32),
        dof_velocity_limit=np.full(nj, 100.0, np.float32),
        dof_damping=np.array(damp, np.float32),
        armature=armature,
    )
    defaults["dof_armature"] = np.array(arma, np.float32)
    # weld + zero-range joints lock
    locked = (np.array(hi) - np.array(lo)) <= 0.0
    defaults["dof_locked"] = locked.astype(np.float32)

    model = RobotModel(
        name=model_name,
        body_names=body_names,
        parent=parent,
        joint_names=tuple(jnames),
        joint_type=tuple(jtypes),
        joint_axis=tuple(jaxes),
        joint_pos=tuple(jpos),
        joint_quat=tuple(jquat),
        dof_index=tuple(range(nj)),
        floating=bool(floating[0]) and not fix_base_link,
        geoms=tuple(geoms_out),
        _defaults=defaults,
    )
    # motor efforts in DOF order (humanoid.py:161-162 motor_efforts)
    model_motor = np.array(
        [motor_table.get(n, 0.0) for n in jnames], np.float32)
    object.__setattr__(model, "motor_efforts", model_motor)
    return model
