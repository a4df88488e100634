"""URDF -> RobotModel compiler (numpy/XML only).

Port of ``thormang_isaacgym_tpu/models/urdf.py``; the arithmetic is
unchanged, so both packages compile an asset to the same defaults. Fixed
joints merge into the parent body (merged links stay addressable as sites);
mesh collision geometry is replaced via `mesh_overrides`, approximated by a
bounding sphere with `approx_meshes=True`, or skipped.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from thormang_isaacgym_tpu_torch.models.robot import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE,
    Geom, PRISMATIC, REVOLUTE, RobotModel, make_defaults,
)


# ---------------------------------------------------------------------------
# small numpy-side rotation helpers (compile time only)
# ---------------------------------------------------------------------------

def _rpy_to_matrix(rpy):
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _matrix_to_quat(R):
    # Shepperd's method (numpy scalar version)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _parse_floats(s, default=None, n=3):
    if s is None:
        return np.zeros(n) if default is None else np.asarray(default, dtype=float)
    return np.array([float(x) for x in s.split()])


# ---------------------------------------------------------------------------
# intermediate link/joint records
# ---------------------------------------------------------------------------

class _Link:
    def __init__(self, name):
        self.name = name
        self.mass = 0.0
        self.com = np.zeros(3)
        self.inertia = np.zeros((3, 3))  # about com, link frame
        self.geoms = []  # list of (gtype, size, pos, quat, name)

    def parse_inertial(self, el):
        inertial = el.find("inertial")
        if inertial is None:
            return
        o = inertial.find("origin")
        if o is not None:
            xyz = _parse_floats(o.get("xyz"))
            rpy = _parse_floats(o.get("rpy"))
            R = _rpy_to_matrix(rpy)
        else:
            xyz = np.zeros(3)
            R = np.eye(3)
        m_el = inertial.find("mass")
        self.mass = float(m_el.get("value")) if m_el is not None else 0.0
        i_el = inertial.find("inertia")
        if i_el is not None:
            ixx = float(i_el.get("ixx", 0)); iyy = float(i_el.get("iyy", 0)); izz = float(i_el.get("izz", 0))
            ixy = float(i_el.get("ixy", 0)); ixz = float(i_el.get("ixz", 0)); iyz = float(i_el.get("iyz", 0))
            I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        else:
            I = np.zeros((3, 3))
        self.com = xyz
        self.inertia = R @ I @ R.T  # rotate inertia axes into link frame


def _combine_inertia(mass_a, com_a, I_a, mass_b, com_b, I_b):
    """Combine two rigid bodies expressed in the same frame."""
    m = mass_a + mass_b
    if m <= 0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    com = (mass_a * com_a + mass_b * com_b) / m

    def shift(I, mass, c, new_c):
        d = c - new_c
        return I + mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, com, shift(I_a, mass_a, com_a, com) + shift(I_b, mass_b, com_b, com)


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------

def load_urdf(
    path_or_string: str,
    *,
    fix_base_link: bool = False,
    armature: float = 0.0,
    mesh_overrides: dict | None = None,
    approx_meshes: bool = False,
    default_density: float = 1000.0,
    name: str | None = None,
    disable_gravity: bool = False,
) -> RobotModel:
    """Parse a URDF file (or XML string) into a RobotModel.

    mesh_overrides maps a link name to a Geom-spec dict
    ``{"type": "cylinder", "size": (r, half_w), "pos": ..., "quat": ...}``
    replacing that link's mesh collision geometry.
    """
    if os.path.exists(path_or_string):
        tree = ET.parse(path_or_string)
        root_el = tree.getroot()
        default_name = os.path.splitext(os.path.basename(path_or_string))[0]
    else:
        root_el = ET.fromstring(path_or_string)
        default_name = root_el.get("name", "robot")
    robot_name = name or root_el.get("name", default_name)
    mesh_overrides = mesh_overrides or {}

    # ---- parse links ----
    links: dict[str, _Link] = {}
    for link_el in root_el.findall("link"):
        ln = _Link(link_el.get("name"))
        ln.parse_inertial(link_el)
        for col in link_el.findall("collision"):
            cname = col.get("name", "")
            pos, q = _parse_origin_el(col)
            geo = col.find("geometry")
            if geo is None:
                continue
            parsed = _parse_geometry(geo, ln.name, mesh_overrides, approx_meshes)
            if parsed is None:
                continue
            gtype, size, extra_pos, extra_quat = parsed
            pos = pos + _quat_to_matrix(q) @ np.asarray(extra_pos)
            q = _quat_mul(q, np.asarray(extra_quat))
            ln.geoms.append((gtype, size, pos, q, cname or ln.name))
        if not ln.geoms and ln.name in mesh_overrides:
            # override may ADD collision to a link that declares none
            # (e.g. thormang3.urdf carries no <collision> tags at all)
            ov = mesh_overrides[ln.name]
            gt = {"sphere": GEOM_SPHERE, "capsule": GEOM_CAPSULE,
                  "box": GEOM_BOX, "cylinder": GEOM_CYLINDER}[ov["type"]]
            ln.geoms.append((gt, tuple(ov["size"]),
                             np.asarray(ov.get("pos", (0, 0, 0)), dtype=float),
                             np.asarray(ov.get("quat", (1, 0, 0, 0)), dtype=float),
                             ln.name))
        links[ln.name] = ln

    # ---- parse joints ----
    joints = []
    child_of = {}
    for j_el in root_el.findall("joint"):
        jname = j_el.get("name")
        jtype = j_el.get("type")
        parent = j_el.find("parent").get("link")
        child = j_el.find("child").get("link")
        pos, q = _parse_origin_el(j_el)
        axis_el = j_el.find("axis")
        axis = _parse_floats(axis_el.get("xyz")) if axis_el is not None else np.array([1.0, 0, 0])
        nrm = np.linalg.norm(axis)
        axis = axis / nrm if nrm > 0 else np.array([1.0, 0, 0])
        lim_el = j_el.find("limit")
        lower = float(lim_el.get("lower", -np.inf)) if lim_el is not None else -np.inf
        upper = float(lim_el.get("upper", np.inf)) if lim_el is not None else np.inf
        effort = float(lim_el.get("effort", np.inf)) if lim_el is not None else np.inf
        velocity = float(lim_el.get("velocity", np.inf)) if lim_el is not None else np.inf
        if jtype == "continuous":
            lower, upper = -np.inf, np.inf
        dyn_el = j_el.find("dynamics")
        damping = float(dyn_el.get("damping", 0.0)) if dyn_el is not None else 0.0
        friction = float(dyn_el.get("friction", 0.0)) if dyn_el is not None else 0.0
        joints.append(dict(
            name=jname, type=jtype, parent=parent, child=child, pos=pos, quat=q,
            axis=axis, lower=lower, upper=upper, effort=effort, velocity=velocity,
            damping=damping, friction=friction,
        ))
        child_of[child] = joints[-1]

    # ---- find root link ----
    all_children = set(child_of.keys())
    roots = [n for n in links if n not in all_children]
    if len(roots) != 1:
        # pick the root that actually owns joints (URDFs sometimes carry stray links)
        roots = [r for r in roots if any(j["parent"] == r for j in joints)] or roots
    root_link = roots[0]

    # ---- merge fixed joints bottom-up; build movable tree ----
    # We walk the tree from the root. Every link reached through only-fixed
    # joints collapses into its movable ancestor.
    children_map: dict[str, list] = {}
    for j in joints:
        children_map.setdefault(j["parent"], []).append(j)

    body_names = [root_link]
    body_link = {root_link: 0}       # movable body index per link name
    # pose of each merged link within its movable body frame
    link_pose = {root_link: (np.zeros(3), np.array([1.0, 0, 0, 0]))}
    bodies = [dict(mass=links[root_link].mass, com=links[root_link].com.copy(),
                   inertia=links[root_link].inertia.copy())]
    geoms: list[Geom] = []
    sites = {}
    out_joints = []  # dicts with parent body idx etc.

    def add_geoms_of(link_name, body_idx, pos_in_body, quat_in_body):
        R = _quat_to_matrix(quat_in_body)
        for gtype, size, gpos, gquat, gname in links[link_name].geoms:
            geoms.append(Geom(
                body=body_idx, gtype=gtype, size=tuple(float(s) for s in size),
                pos=tuple((pos_in_body + R @ gpos).tolist()),
                quat=tuple(_quat_mul(quat_in_body, gquat).tolist()),
                name=gname,
            ))

    add_geoms_of(root_link, 0, np.zeros(3), np.array([1.0, 0, 0, 0]))

    # BFS
    stack = [root_link]
    while stack:
        parent_link = stack.pop(0)
        p_body = body_link[parent_link]
        p_pos, p_quat = link_pose[parent_link]
        pR = _quat_to_matrix(p_quat)
        for j in children_map.get(parent_link, []):
            child = j["child"]
            # joint frame in movable-body coordinates
            j_pos = p_pos + pR @ j["pos"]
            j_quat = _quat_mul(p_quat, j["quat"])
            if j["type"] == "fixed":
                # merge child into p_body
                body_link[child] = p_body
                link_pose[child] = (j_pos, j_quat)
                cl = links[child]
                R = _quat_to_matrix(j_quat)
                com_in_body = j_pos + R @ cl.com
                I_in_body = R @ cl.inertia @ R.T
                b = bodies[p_body]
                b["mass"], b["com"], b["inertia"] = _combine_inertia(
                    b["mass"], b["com"], b["inertia"], cl.mass, com_in_body, I_in_body)
                add_geoms_of(child, p_body, j_pos, j_quat)
                sites[child] = (p_body, tuple(j_pos.tolist()), tuple(j_quat.tolist()))
                stack.append(child)
            elif j["type"] in ("revolute", "continuous", "prismatic"):
                idx = len(body_names)
                body_names.append(child)
                body_link[child] = idx
                link_pose[child] = (np.zeros(3), np.array([1.0, 0, 0, 0]))
                cl = links[child]
                bodies.append(dict(mass=cl.mass, com=cl.com.copy(), inertia=cl.inertia.copy()))
                out_joints.append(dict(
                    name=j["name"],
                    type=REVOLUTE if j["type"] in ("revolute", "continuous") else PRISMATIC,
                    parent=p_body, pos=j_pos, quat=j_quat, axis=j["axis"],
                    lower=j["lower"], upper=j["upper"], effort=j["effort"],
                    velocity=j["velocity"], damping=j["damping"], friction=j["friction"],
                ))
                add_geoms_of(child, idx, np.zeros(3), np.array([1.0, 0, 0, 0]))
                stack.append(child)
            else:
                raise ValueError(f"unsupported joint type {j['type']} ({j['name']})")

    # NOTE: out_joints were appended in BFS order (parent idx < child idx),
    # but long FIXED-joint chains can delay a shallow movable body until
    # after deeper ones were emitted (the queue interleaves fixed-merge
    # traversal with movable creation), breaking the level-contiguous body
    # order the banded ABA sweeps require (ops/levels.py). Re-sort bodies
    # depth-major with a stable key — a no-op for assets that were already
    # contiguous, same normalization as models/mjcf.py.
    nb = len(body_names)
    nj = len(out_joints)
    parent_idx = [-1] + [j["parent"] for j in out_joints]
    depth = [0] * nb
    for i in range(1, nb):
        depth[i] = depth[parent_idx[i]] + 1
    order = sorted(range(nb), key=lambda i: (depth[i], i))
    if order != list(range(nb)):
        remap = {old: new for new, old in enumerate(order)}
        body_names = [body_names[i] for i in order]
        bodies = [bodies[i] for i in order]
        # joint k belongs to body k+1; reorder joints by their child body
        out_joints = [out_joints[i - 1] for i in order[1:]]
        for j in out_joints:
            j["parent"] = remap[j["parent"]]
        parent_idx = [-1] + [j["parent"] for j in out_joints]
        geoms = [Geom(body=remap[g.body], gtype=g.gtype, size=g.size,
                      pos=g.pos, quat=g.quat, name=g.name) for g in geoms]
        sites = {k: (remap[b], p, qv) for k, (b, p, qv) in sites.items()}

    defaults = make_defaults(
        nb, nj, len(geoms),
        body_mass=np.array([max(b["mass"], 1e-6) for b in bodies]),
        body_com=np.stack([b["com"] for b in bodies]) if nb else np.zeros((0, 3)),
        body_inertia=np.stack([b["inertia"] for b in bodies]) if nb else np.zeros((0, 3, 3)),
        dof_lower=np.array([j["lower"] for j in out_joints], dtype=np.float32) if nj else np.zeros(0),
        dof_upper=np.array([j["upper"] for j in out_joints], dtype=np.float32) if nj else np.zeros(0),
        dof_velocity_limit=np.array([min(j["velocity"], 1e9) for j in out_joints], dtype=np.float32) if nj else np.zeros(0),
        dof_damping=np.array([j["damping"] for j in out_joints], dtype=np.float32) if nj else np.zeros(0),
        dof_friction=np.array([j["friction"] for j in out_joints], dtype=np.float32) if nj else np.zeros(0),
        armature=armature,
        gravity_scale=0.0 if disable_gravity else 1.0,
    )
    # effort limits from URDF
    defaults["drive_effort_limit"] = np.array(
        [min(j["effort"], 1e9) for j in out_joints], dtype=np.float32) if nj else np.zeros(0, np.float32)

    return RobotModel(
        name=robot_name,
        body_names=tuple(body_names),
        parent=tuple(parent_idx),
        joint_names=tuple(j["name"] for j in out_joints),
        joint_type=tuple(j["type"] for j in out_joints),
        joint_axis=tuple(tuple(j["axis"].tolist()) for j in out_joints),
        joint_pos=tuple(tuple(j["pos"].tolist()) for j in out_joints),
        joint_quat=tuple(tuple(j["quat"].tolist()) for j in out_joints),
        dof_index=tuple(range(nj)),
        floating=not fix_base_link,
        geoms=tuple(geoms),
        sites=sites,
        _defaults=defaults,
    )


def _parse_origin_el(el):
    o = el.find("origin")
    if o is None:
        return np.zeros(3), np.array([1.0, 0, 0, 0])
    xyz = _parse_floats(o.get("xyz"))
    rpy = _parse_floats(o.get("rpy"))
    return xyz, _matrix_to_quat(_rpy_to_matrix(rpy))


def _parse_geometry(geo_el, link_name, mesh_overrides, approx_meshes):
    """Returns (gtype, size, extra_pos, extra_quat) or None to skip."""
    ident = np.array([1.0, 0, 0, 0])
    if link_name in mesh_overrides:
        ov = mesh_overrides[link_name]
        gt = {"sphere": GEOM_SPHERE, "capsule": GEOM_CAPSULE,
              "box": GEOM_BOX, "cylinder": GEOM_CYLINDER}[ov["type"]]
        return gt, tuple(ov["size"]), np.asarray(ov.get("pos", (0, 0, 0))), np.asarray(ov.get("quat", (1, 0, 0, 0)))
    sphere = geo_el.find("sphere")
    if sphere is not None:
        return GEOM_SPHERE, (float(sphere.get("radius")),), np.zeros(3), ident
    box = geo_el.find("box")
    if box is not None:
        size = _parse_floats(box.get("size"))
        return GEOM_BOX, tuple((size / 2).tolist()), np.zeros(3), ident
    cyl = geo_el.find("cylinder")
    if cyl is not None:
        # URDF cylinder axis = local z
        return GEOM_CYLINDER, (float(cyl.get("radius")), float(cyl.get("length")) / 2), np.zeros(3), ident
    cap = geo_el.find("capsule")
    if cap is not None:
        return GEOM_CAPSULE, (float(cap.get("radius")), float(cap.get("length")) / 2), np.zeros(3), ident
    mesh = geo_el.find("mesh")
    if mesh is not None:
        if approx_meshes:
            # cheap bounding sphere from the vertex cloud if the file exists
            fn = mesh.get("filename", "")
            scale = _parse_floats(mesh.get("scale"), default=[1, 1, 1])
            verts = _try_load_obj_vertices(fn)
            if verts is not None and len(verts):
                v = verts * scale
                center = (v.max(0) + v.min(0)) / 2
                r = float(np.linalg.norm(v - center, axis=1).max())
                return GEOM_SPHERE, (r,), center, ident
        return None
    return None


# mesh search order: the path as given, then the repo's own assets folder
# (upstream reference assets are optional and not looked for)
_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets")


def _try_load_obj_vertices(filename):
    for path in (filename, os.path.join(_ASSET_DIR, filename)):
        if filename and os.path.exists(path):
            vs = []
            with open(path) as f:
                for line in f:
                    if line.startswith("v "):
                        vs.append([float(x) for x in line.split()[1:4]])
            return np.array(vs) if vs else None
    return None
