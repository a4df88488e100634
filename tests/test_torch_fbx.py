"""Port parity for learn/fbx.py, the binary FBX reader, and the .fbx paths
of learn/poselib.py and learn/motion_lib.py, against the JAX package (both
numpy: equal bit for bit).

No FBX file is in the repository, so the test writes its own (``_Writer``,
the binary layout of learn/fbx.py's docstring): a scene-wrapper Null above
a 3-bone LimbNode chain with ``Lcl Translation``, ``PreRotation`` and
``RotationOrder``, one animation stack and layer with rotation and
translation curves (one curve of a single key, one axis left to its
curve node's default, one key array zlib-compressed), at version 7400 (u32
record headers) and 7500 (u64). A second file carries the AMP humanoid's
walk clip (assets/amp/motions) as Euler curves on its 15 joints, so
``load_motion_file`` and ``default_motion_lib`` read an .fbx to a clip.
JAX tests/test_fbx.py's CMU cases stay guarded on the reference's files."""
import os
import struct
import zlib

import numpy as np
import pytest

from thormang_isaacgym_tpu.learn import fbx as jfbx
from thormang_isaacgym_tpu.learn import motion_lib as jml
from thormang_isaacgym_tpu.learn import poselib as jpl
from thormang_isaacgym_tpu_torch.learn import fbx as tfbx
from thormang_isaacgym_tpu_torch.learn import motion_lib as tml
from thormang_isaacgym_tpu_torch.learn import poselib as tpl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALK = os.path.join(ROOT, "assets", "amp", "motions", "amp_humanoid_walk.npy")
TICK = tfbx.KTIME_PER_SEC // 30           # one frame at 30 fps in KTime


class _I32(int):
    """An 'I' (int32) property; a plain int is written as 'L' (int64)."""


class _Writer:
    """A minimal binary FBX writer: nodes are (name, props, children)."""

    def __init__(self, version: int):
        self.version = version
        self.big = version >= 7500

    def _prop(self, v) -> bytes:
        if isinstance(v, (bytes, str)):
            b = v.encode("latin1") if isinstance(v, str) else v
            return b"S" + struct.pack("<I", len(b)) + b
        if isinstance(v, _I32):
            return b"I" + struct.pack("<i", int(v))
        if isinstance(v, int):
            return b"L" + struct.pack("<q", v)
        if isinstance(v, float):
            return b"D" + struct.pack("<d", v)
        arr, compress = v if isinstance(v, tuple) else (v, False)
        code = {np.dtype(np.float64): b"d", np.dtype(np.float32): b"f",
                np.dtype(np.int64): b"l", np.dtype(np.int32): b"i"}[arr.dtype]
        raw = np.ascontiguousarray(arr).tobytes()
        data = zlib.compress(raw) if compress else raw
        return code + struct.pack("<III", len(arr), int(compress), len(data)) + data

    def _null(self) -> bytes:
        return bytes(25 if self.big else 13)

    def _node(self, out: bytearray, name, props, children) -> None:
        plist = b"".join(self._prop(p) for p in props)
        head = len(out)
        fmt = "<QQQ" if self.big else "<III"
        out += struct.pack(fmt, 0, len(props), len(plist)) + bytes([len(name)])
        out += name.encode("latin1") + plist
        for child in children:
            self._node(out, *child)
        if children:
            out += self._null()
        struct.pack_into(fmt[:2], out, head, len(out))

    def write(self, path, nodes) -> None:
        out = bytearray(b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", self.version))
        for node in nodes:
            self._node(out, *node)
        out += self._null()
        with open(path, "wb") as f:
            f.write(bytes(out))


def _p70(*entries):
    """Properties70 of (name, type, values)."""
    return ("Properties70", [], [("P", [n, t, "", "A", *vals], []) for n, t, vals in entries])


def _model(oid, name, cls, *p70):
    return ("Model", [oid, f"{name}\x00\x01Model", cls], [_p70(*p70)] if p70 else [])


def _scene(models, channels, frames):
    """FBX nodes of `models` [(id, name, class, parent id or None,
    [Properties70 entries])] and `channels` {(model id, prop): {axis: (key
    times, values, zlib)}, or {axis: default} for an axis without a
    curve}: one stack, one layer, a curve node per channel."""
    objects, conns = [], []
    for oid, name, cls, parent, p70 in models:
        objects.append(_model(oid, name, cls, *p70))
        if parent is not None:
            conns.append(("C", ["OO", oid, parent], []))
    objects += [("AnimationStack", [900, "Take 001\x00\x01AnimStack", ""],
                 [_p70(("LocalStop", "KTime", [frames * TICK]))]),
                ("AnimationLayer", [901, "BaseLayer\x00\x01AnimLayer", ""], [])]
    conns.append(("C", ["OO", 901, 900], []))
    nid = 1000
    for (mid, prop), axes in channels.items():
        cn = nid
        defaults = [(f"d|{ax}", "Number", [float(v if not isinstance(v, tuple) else v[1][0])])
                    for ax, v in axes.items()]
        objects.append(("AnimationCurveNode", [cn, f"{prop[4]}\x00\x01AnimCurveNode", ""],
                        [_p70(*defaults)]))
        conns += [("C", ["OO", cn, 901], []), ("C", ["OP", cn, mid, prop], [])]
        for ax, v in axes.items():
            nid += 1
            if not isinstance(v, tuple):
                continue
            times, values, compress = v
            objects.append(("AnimationCurve", [nid, "\x00\x01AnimCurve", ""], [
                ("Default", [0.0], []),
                ("KeyTime", [np.asarray(times, np.int64)], []),
                ("KeyValueFloat", [(np.asarray(values, np.float32), compress)], [])]))
            conns.append(("C", ["OP", nid, cn, f"d|{ax}"], []))
        nid += 1
    return [("FBXHeaderExtension", [], [("FBXVersion", [_I32(7400)], [])]),
            ("Objects", [], objects), ("Connections", [], conns)]


def _chain_file(path, version):
    """The wrapper Null "Take" (-90 about x) over Hips -> Spine -> Head."""
    F = 12
    t = np.arange(F) * TICK
    k = np.arange(F, dtype=np.float64)
    models = [
        (10, "Take", "Null", None, [("Lcl Rotation", "Lcl Rotation", [-90.0, 0.0, 0.0])]),
        (11, "Hips", "LimbNode", 10, [("Lcl Translation", "Lcl Translation", [0.0, 0.0, 17.5])]),
        (12, "Spine", "LimbNode", 11, [
            ("Lcl Translation", "Lcl Translation", [0.0, 0.5, 4.0]),
            ("PreRotation", "Vector3D", [5.0, -10.0, 20.0]),
            ("RotationOrder", "enum", [_I32(4)]),
            ("Lcl Rotation", "Lcl Rotation", [1.0, 2.0, 3.0])]),
        (13, "Head", "LimbNode", 12, [
            ("Lcl Translation", "Lcl Translation", [0.0, 0.0, 3.2]),
            ("PostRotation", "Vector3D", [0.0, 15.0, 0.0]),
            ("Lcl Rotation", "Lcl Rotation", [0.0, 0.0, 45.0])]),
    ]
    channels = {
        (11, "Lcl Translation"): {"X": (t, 0.4 * k, False), "Y": (t, np.sin(k / 3), True),
                                  "Z": (t, 17.5 + 0.1 * np.cos(k), False)},
        (11, "Lcl Rotation"): {"X": (t, 10 * np.sin(k / 4), False),
                               "Y": (t[::2], 5 * k[::2], False), "Z": -3.0},
        (12, "Lcl Rotation"): {"X": (t, 30 * np.cos(k / 5), True), "Y": (t[:1], [7.0], False),
                               "Z": (t, -2 * k, False)},
    }
    _Writer(version).write(path, _scene(models, channels, F))


def _quat_to_euler_xyz_deg(q):
    """wxyz -> XYZ Euler degrees with R = Rz Ry Rx."""
    w, x, y, z = np.moveaxis(q, -1, 0)
    rx = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    ry = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    rz = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.rad2deg(np.stack([rx, ry, rz], -1))


def _walk_file(path, version):
    """The walk clip's 15 joints as LimbNodes with XYZ Euler curves and the
    pelvis' translation curves, at 30 fps."""
    walk = tpl.SkeletonMotion.from_file(WALK)
    sk = walk.skeleton
    F = walk.num_frames
    t = np.arange(F) * TICK
    euler = _quat_to_euler_xyz_deg(walk.local_rotation)
    models, channels = [], {}
    for j, name in enumerate(sk.node_names):
        p = int(sk.parent_indices[j])
        models.append((100 + j, name, "LimbNode", None if p < 0 else 100 + p,
                       [("Lcl Translation", "Lcl Translation",
                         [float(x) for x in sk.local_translation[j]])]))
        channels[(100 + j, "Lcl Rotation")] = {
            ax: (t, euler[:, j, i], j == 0) for i, ax in enumerate("XYZ")}
    channels[(100, "Lcl Translation")] = {
        ax: (t, walk.root_translation[:, i], False) for i, ax in enumerate("XYZ")}
    _Writer(version).write(path, _scene(models, channels, F))
    return walk


def _same_motion(got, want):
    assert got.skeleton.node_names == want.skeleton.node_names
    for a, b in ((got.skeleton.parent_indices, want.skeleton.parent_indices),
                 (got.skeleton.local_translation, want.skeleton.local_translation),
                 (got.local_rotation, want.local_rotation),
                 (got.root_translation, want.root_translation)):
        np.testing.assert_array_equal(a, b)
    assert got.fps == want.fps


@pytest.mark.parametrize("version", [7400, 7500])
def test_load_fbx_motion_matches_jax(tmp_path, version):
    path = str(tmp_path / f"chain_{version}.fbx")
    _chain_file(path, version)
    got, want = tfbx.load_fbx_motion(path), jfbx.load_fbx_motion(path)
    _same_motion(got, want)
    assert got.skeleton.node_names == ["Hips", "Spine", "Head"]       # the wrapper left out
    assert list(got.skeleton.parent_indices) == [-1, 0, 1]
    assert got.fps == 30.0 and got.num_frames == 12
    np.testing.assert_allclose(got.root_translation[:, 0], 0.4 * np.arange(12), atol=1e-5)
    # Head: Lcl Rotation (0, 0, 45) then PostRotation (0, 15, 0) inverted
    q = tfbx._qmul(tfbx._euler_to_quat_deg([[0.0, 0.0, 45.0]]),
                   tfbx._euler_to_quat_deg([[0.0, 15.0, 0.0]]) * [1, -1, -1, -1])
    np.testing.assert_allclose(got.local_rotation[:, 2], np.repeat(q, 12, 0), atol=1e-12)
    # the tree parses alike at both header widths, the zlib array included
    for a, b in zip(_walk_nodes(tfbx.parse_fbx(path)), _walk_nodes(jfbx.parse_fbx(path))):
        assert a[0] == b[0] and len(a[1]) == len(b[1])
        for x, y in zip(a[1], b[1]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _walk_nodes(node):
    yield node.name, node.props
    for c in node.children:
        yield from _walk_nodes(c)


def test_header_widths_parse_alike(tmp_path):
    """The same scene at 7400 and 7500 gives one motion."""
    a, b = str(tmp_path / "a.fbx"), str(tmp_path / "b.fbx")
    _chain_file(a, 7400)
    _chain_file(b, 7500)
    assert os.path.getsize(b) > os.path.getsize(a)
    _same_motion(tfbx.load_fbx_motion(a), tfbx.load_fbx_motion(b))
    with open(a, "r+b") as f:
        f.write(b"Kaydara FBX ASCII   ")
    with pytest.raises(ValueError):
        tfbx.load_fbx_motion(a)


@pytest.mark.parametrize("version", [7400, 7500])
def test_fbx_clip_through_poselib_and_motion_lib(tmp_path, version):
    """An .fbx of the AMP skeleton through load_motion_file and
    default_motion_lib (a file and a directory) in both packages."""
    d = tmp_path / "clips"
    d.mkdir()
    path = str(d / "walk.fbx")
    walk = _walk_file(path, version)
    motion = tfbx.load_fbx_motion(path)
    _same_motion(motion, jfbx.load_fbx_motion(path))
    assert motion.num_frames == walk.num_frames and motion.fps == walk.fps
    np.testing.assert_allclose(motion.root_translation, walk.root_translation, atol=1e-6)
    # the Euler round trip of the rotations, at float32 key values
    dots = np.abs(np.sum(motion.local_rotation * walk.local_rotation, -1))
    assert dots.min() > 1 - 1e-5
    got, want = tpl.load_motion_file(path), jpl.load_motion_file(path)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for target in (path, str(d)):
        lib, jlib = tml.default_motion_lib(target), jml.default_motion_lib(target)
        assert lib.num_motions() == jlib.num_motions() == 1
        np.testing.assert_array_equal(lib.dof_pos.numpy(), np.asarray(jlib.dof_pos))
        np.testing.assert_array_equal(lib.root_pos.numpy(), np.asarray(jlib.root_pos))
