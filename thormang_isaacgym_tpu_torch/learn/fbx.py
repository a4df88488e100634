"""Binary FBX (Kaydara 7.x) animation reader, numpy only. Port of
``thormang_isaacgym_tpu/learn/fbx.py``, the JAX package's code kept as its
own copy.

It replaces the reference's Autodesk-SDK FBX backend
(``tasks/amp/poselib/skeleton/backend/fbx/``) for the subset a mocap
skeleton export uses: the node-record tree, ``Properties70`` blocks, the
Model (LimbNode) hierarchy, AnimationCurveNode / AnimationCurve keys and the
Connections table. ``load_fbx_motion`` assembles a ``poselib.SkeletonMotion``
(local joint rotations and the root's translation at a uniform fps), as the
reference's ``SkeletonMotion.from_fbx`` does.

Binary layout:
  header  "Kaydara FBX Binary  \\x00", u8, u16, u32 version
  node    end offset, property count, property-list length (u32 each
          before version 7500, u64 from it on), u8 name length, name,
          properties, nested nodes, then a null record (13 or 25 bytes)
  props   'Y' i16 | 'C' u8 | 'I' i32 | 'F' f32 | 'D' f64 | 'L' i64
          | 'S' / 'R' u32-length bytes
          | 'f', 'd', 'l', 'i', 'b' arrays: u32 length, u32 encoding,
            u32 compressed length, data (zlib where the encoding is 1)

A node's local transform is T Rpre R(euler, order) Rpost^-1; pivots and
offsets must be absent (mocap exports leave them out). Euler order XYZ
composes R = Rz Ry Rx (X first). Time is in KTime ticks, 46,186,158,000 a
second.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from thormang_isaacgym_tpu_torch.learn.poselib import Skeleton, SkeletonMotion, _qmul, _qnorm

KTIME_PER_SEC = 46186158000
_MAGIC = b"Kaydara FBX Binary  \x00"

_ARRAY_TYPES = {
    b"f": (np.float32, 4), b"d": (np.float64, 8), b"l": (np.int64, 8),
    b"i": (np.int32, 4), b"b": (np.uint8, 1),
}
_SCALAR_TYPES = {b"Y": ("<h", 2), b"C": ("<B", 1), b"I": ("<i", 4),
                 b"F": ("<f", 4), b"D": ("<d", 8), b"L": ("<q", 8)}
# RotationOrder code -> the axes in the order they apply
_ORDERS = {0: (0, 1, 2), 1: (0, 2, 1), 2: (1, 0, 2), 3: (1, 2, 0), 4: (2, 0, 1), 5: (2, 1, 0)}


class FbxNode:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props, children):
        self.name = name
        self.props = props
        self.children = children

    def all(self, name):
        return [c for c in self.children if c.name == name]

    def first(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _parse_props(data, pos, count):
    props = []
    for _ in range(count):
        t = data[pos:pos + 1]
        pos += 1
        if t in _SCALAR_TYPES:
            fmt, sz = _SCALAR_TYPES[t]
            props.append(struct.unpack_from(fmt, data, pos)[0])
            pos += sz
        elif t in (b"S", b"R"):
            n = struct.unpack_from("<I", data, pos)[0]
            props.append(data[pos + 4:pos + 4 + n])
            pos += 4 + n
        elif t in _ARRAY_TYPES:
            dt, isz = _ARRAY_TYPES[t]
            n, enc, clen = struct.unpack_from("<III", data, pos)
            pos += 12
            size = clen if enc else n * isz
            raw = data[pos:pos + size]
            pos += size
            if enc:
                raw = zlib.decompress(raw)
            props.append(np.frombuffer(raw, dtype=dt, count=n))
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
    return props, pos


def _parse_node(data, pos, big):
    """(node, end) of the record at `pos`; (None, pos after it) at a null
    record."""
    if big:
        end, nprops, _ = struct.unpack_from("<QQQ", data, pos)
        nlen = data[pos + 24]
        pos += 25
    else:
        end, nprops, _ = struct.unpack_from("<III", data, pos)
        nlen = data[pos + 12]
        pos += 13
    if end == 0:
        return None, pos
    name = data[pos:pos + nlen].decode("latin1")
    pos += nlen
    props, pos = _parse_props(data, pos, nprops)
    children = []
    # nested nodes end with a null record; a node without them has none
    while pos < end:
        child, pos = _parse_node(data, pos, big)
        if child is None:
            break
        children.append(child)
    return FbxNode(name, props, children), end


def parse_fbx(path: str) -> FbxNode:
    """The file's top-level nodes under a "(root)" node."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:21] != _MAGIC:
        raise ValueError(f"{path}: not a binary FBX file")
    big = struct.unpack_from("<I", data, 23)[0] >= 7500
    pos = 27
    top = []
    while pos < len(data):
        node, pos = _parse_node(data, pos, big)
        if node is None:
            break
        top.append(node)
    return FbxNode("(root)", [], top)


def _props70(node) -> dict:
    """Properties70 -> {name: tuple of values}."""
    p70 = node.first("Properties70")
    if p70 is None:
        return {}
    return {p.props[0].decode("latin1"): tuple(p.props[4:]) for p in p70.all("P")}


def _euler_to_quat_deg(e_deg, order=(0, 1, 2)):
    """(F, 3) Euler degrees -> (F, 4) wxyz, the axes applied first to last
    in `order` (XYZ: q = qz qy qx)."""
    e = np.deg2rad(np.asarray(e_deg, np.float64))
    axes = np.eye(3)
    q = None
    for ax in order:
        half = 0.5 * e[:, ax]
        qa = np.concatenate([np.cos(half)[:, None], np.sin(half)[:, None] * axes[ax][None]],
                            axis=1)
        q = qa if q is None else _qmul(qa, q)
    return q


def _sample_curve(times, values, grid):
    """One animation curve resampled linearly onto the KTime grid."""
    if len(times) == 1:
        return np.full(len(grid), values[0], np.float64)
    return np.interp(grid, times.astype(np.float64), values.astype(np.float64))


def load_fbx_motion(path: str, fps: float | None = None,
                    root_name: str | None = None) -> SkeletonMotion:
    """A binary FBX mocap file -> SkeletonMotion: the LimbNode skeleton
    under the first parentless Model (or `root_name`), in depth-first
    order, scene wrappers above it left out; fps the file's key rate unless
    given."""
    root = parse_fbx(path)
    objects = root.first("Objects")
    conns = root.first("Connections")
    if objects is None or conns is None:
        raise ValueError(f"{path}: no Objects or Connections")

    models = {}       # id -> name, class, Lcl Translation / Rotation, pre / post rotation, order
    curve_nodes = {}  # id -> channel defaults (d|X, d|Y, d|Z), curves by axis, target
    curves = {}       # id -> (key times, key values)
    for o in objects.children:
        if o.name == "Model":
            oid, full, mclass = o.props[0], o.props[1], o.props[2]
            p = _props70(o)

            def get3(key, p=p):
                return np.array(p.get(key, (0.0, 0.0, 0.0)), np.float64)

            for bad in ("RotationPivot", "ScalingPivot", "RotationOffset", "ScalingOffset"):
                if bad in p and np.abs(np.array(p[bad])).max() > 1e-8:
                    raise NotImplementedError(f"FBX {bad} unsupported")
            models[oid] = dict(
                name=full.decode("latin1").split("\x00")[0], cls=mclass.decode("latin1"),
                lcl_t=get3("Lcl Translation"), lcl_r=get3("Lcl Rotation"),
                pre_rot=get3("PreRotation"), post_rot=get3("PostRotation"),
                order=_ORDERS[int(p.get("RotationOrder", (0,))[0])], parent=None, channels={})
        elif o.name == "AnimationCurveNode":
            p = _props70(o)
            curve_nodes[o.props[0]] = dict(
                defaults={k[-1]: v[0] for k, v in p.items() if k.startswith("d|")},
                curves={}, target=None, prop=None)
        elif o.name == "AnimationCurve":
            kt, kv = o.first("KeyTime"), o.first("KeyValueFloat")
            if kt is not None and kv is not None:
                curves[o.props[0]] = (kt.props[0], kv.props[0])

    for c in conns.all("C"):
        kind = c.props[0].decode("latin1")
        src, dst = c.props[1], c.props[2]
        if kind == "OO" and src in models and dst in models:
            models[src]["parent"] = dst
        elif kind == "OP":
            prop = c.props[3].decode("latin1")
            if src in curve_nodes and dst in models:
                curve_nodes[src]["target"] = dst
                curve_nodes[src]["prop"] = prop
                models[dst]["channels"][prop] = src
            elif src in curves and dst in curve_nodes:
                curve_nodes[dst]["curves"][prop[-1]] = src

    # the skeleton: the Models under the first LimbNode below the parentless
    # root, depth first (the reference importer's order); scene-wrapper
    # Nulls above it (the CMU takes' "-90 about x" node) are not joints
    kids = {}
    for oid, m in models.items():
        kids.setdefault(m["parent"], []).append(oid)
    roots = [oid for oid, m in models.items()
             if m["parent"] is None and (root_name is None or m["name"] == root_name)]
    if not roots:
        raise ValueError(f"{path}: no root model")
    top = roots[0]
    while models[top]["cls"] != "LimbNode":
        limb_kids = [k for k in kids.get(top, ()) if models[k]["cls"] == "LimbNode"] \
            or kids.get(top, ())
        if not limb_kids:
            raise ValueError(f"{path}: no LimbNode under the scene root")
        top = limb_kids[0]
    order_ids = []

    def dfs(oid):
        order_ids.append(oid)
        for k in kids.get(oid, []):
            dfs(k)

    dfs(top)
    idx = {oid: i for i, oid in enumerate(order_ids)}
    J = len(order_ids)

    # one sampling grid over every key time of the skeleton's curves
    all_times = [curves[cid][0] for cn in curve_nodes.values() if cn["target"] in idx
                 for cid in cn["curves"].values()]
    if not all_times:
        raise ValueError(f"{path}: no animation curves target the skeleton")
    t0 = min(float(t[0]) for t in all_times)
    t1 = max(float(t[-1]) for t in all_times)
    if fps is None:
        # the native rate: the median key spacing of the densest curve
        dens = max(all_times, key=len)
        fps = float(np.round(KTIME_PER_SEC / np.median(np.diff(dens.astype(np.float64)))))
    F = max(2, int(round((t1 - t0) * fps / KTIME_PER_SEC)) + 1)
    grid = t0 + np.arange(F) * (KTIME_PER_SEC / fps)

    def channel(m, prop, defaults3):
        """(F, 3) sampled values of 'Lcl Rotation' / 'Lcl Translation'."""
        out = np.broadcast_to(defaults3, (F, 3)).copy()
        cn_id = m["channels"].get(prop)
        if cn_id is None:
            return out
        cn = curve_nodes[cn_id]
        for k, ax in (("X", 0), ("Y", 1), ("Z", 2)):
            if k in cn["curves"]:
                tt, vv = curves[cn["curves"][k]]
                out[:, ax] = _sample_curve(tt, vv, grid)
            elif k in cn["defaults"]:
                out[:, ax] = cn["defaults"][k]
        return out

    local_rot = np.zeros((F, J, 4))
    names, parents, local_t = [], [], []
    root_translation = None
    for oid in order_ids:
        m = models[oid]
        names.append(m["name"])
        parents.append(idx[m["parent"]] if m["parent"] in idx else -1)
        local_t.append(m["lcl_t"])
        q = _euler_to_quat_deg(channel(m, "Lcl Rotation", m["lcl_r"]), m["order"])
        pre = _euler_to_quat_deg(m["pre_rot"][None])[0]
        post_inv = _euler_to_quat_deg(m["post_rot"][None])[0] * np.array([1.0, -1, -1, -1])
        q = _qmul(_qmul(np.broadcast_to(pre, q.shape), q), np.broadcast_to(post_inv, q.shape))
        if parents[-1] == -1:
            root_translation = channel(m, "Lcl Translation", m["lcl_t"])
        local_rot[:, idx[oid]] = q

    skel = Skeleton(node_names=names, parent_indices=np.asarray(parents, np.int64),
                    local_translation=np.asarray(local_t, np.float64))
    return SkeletonMotion(skel, _qnorm(local_rot), root_translation, float(fps))
