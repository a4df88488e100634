"""poselib-compatible motion ingestion: SkeletonTree / State / Motion ``.npy``
I/O and retargeting onto the 28-DOF AMP humanoid. Port of
``thormang_isaacgym_tpu/learn/poselib.py``; numpy only, the JAX package's
code kept as its own copy.

It replaces the reference's ``tasks/amp/poselib/`` stack on the AMP
ingestion path: load a motion recorded on any skeleton in the reference
``.npy`` format, retarget it onto the AMP humanoid's skeleton with the
reference's algorithm, collapse elbows and knees to hinges
(``project_joints``), and canonicalize it into the MotionLib clip layout
(``learn/motion_lib.canonicalize_clip``).

Format notes:
- files are pickled dicts; tensors are stored as {"arr": ndarray,
  "context": {"dtype": ...}} wrappers
- ``__name__`` is "SkeletonState" or "SkeletonMotion"
- quaternions are XYZW on disk (poselib's rotation3d convention); this
  module uses wxyz and converts at the file boundary
- SkeletonState: rotation (J, 4) local, root_translation (3,),
  skeleton_tree {node_names, parent_indices, local_translation}
- SkeletonMotion: rotation (F, J, 4), root_translation (F, 3), fps, and
  derived velocity fields this loader ignores (recomputed downstream)

Retargeting follows the reference's ``skeleton3d.py`` ``retarget_to``:
align the source with a fixed rotation, scale the root-translation delta,
transfer per-joint global-rotation deltas relative to the source tpose onto
the target tpose (unmapped target joints inherit their nearest mapped
ancestor), then ``retarget_motion.py``'s ``project_joints`` and the
feet-on-ground shift plus ``root_height_offset``.

A binary ``.fbx`` mocap file goes through ``learn/fbx.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

# ---------------------------------------------------------------------------
# numpy quaternion helpers (wxyz)
# ---------------------------------------------------------------------------


def _qmul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def _qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _qnorm(q):
    return q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)


def _qrot(q, v):
    qv = q[..., 1:4]
    t = 2.0 * np.cross(qv, v)
    return v + q[..., 0:1] * t + np.cross(qv, t)


def _from_angle_axis(angle, axis):
    axis = np.asarray(axis, np.float64)
    axis = axis / (np.linalg.norm(axis, axis=-1, keepdims=True) + 1e-12)
    half = np.asarray(angle)[..., None] * 0.5
    return np.concatenate([np.cos(half), np.sin(half) * axis], axis=-1)


def _xyzw_to_wxyz(q):
    return np.concatenate([q[..., 3:4], q[..., 0:3]], axis=-1)


def _wxyz_to_xyzw(q):
    return np.concatenate([q[..., 1:4], q[..., 0:1]], axis=-1)


# ---------------------------------------------------------------------------
# file format
# ---------------------------------------------------------------------------


def _unwrap(x):
    if isinstance(x, dict) and "arr" in x:
        return np.asarray(x["arr"])
    return x


def _wrap(a):
    a = np.asarray(a)
    return {"arr": a, "context": {"dtype": str(a.dtype)}}


@dataclasses.dataclass
class Skeleton:
    node_names: list
    parent_indices: np.ndarray       # (J,)
    local_translation: np.ndarray    # (J,3)

    def index(self, name):
        return self.node_names.index(name)


@dataclasses.dataclass
class SkeletonMotion:
    """A SkeletonState (F absent -> single frame) or SkeletonMotion.

    local_rotation: (F,J,4) wxyz; root_translation: (F,3); fps float."""
    skeleton: Skeleton
    local_rotation: np.ndarray
    root_translation: np.ndarray
    fps: float = 30.0

    @property
    def num_frames(self):
        return self.local_rotation.shape[0]

    # -- FK ------------------------------------------------------------
    def fk(self):
        """(F,J,4) global rotations + (F,J,3) global translations."""
        J = len(self.skeleton.node_names)
        F = self.num_frames
        g_rot = np.zeros((F, J, 4))
        g_pos = np.zeros((F, J, 3))
        for j in range(J):
            p = int(self.skeleton.parent_indices[j])
            if p < 0:
                g_rot[:, j] = self.local_rotation[:, j]
                g_pos[:, j] = self.root_translation
            else:
                g_rot[:, j] = _qmul(g_rot[:, p], self.local_rotation[:, j])
                g_pos[:, j] = g_pos[:, p] + _qrot(
                    g_rot[:, p], self.skeleton.local_translation[j][None])
        return _qnorm(g_rot), g_pos

    # -- I/O -----------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "SkeletonMotion":
        d = np.load(path, allow_pickle=True).item()
        tree = d["skeleton_tree"]
        skel = Skeleton(
            node_names=list(tree["node_names"]),
            parent_indices=_unwrap(tree["parent_indices"]).astype(np.int64),
            local_translation=_unwrap(tree["local_translation"]).astype(
                np.float64),
        )
        rot = _unwrap(d["rotation"]).astype(np.float64)
        trans = _unwrap(d["root_translation"]).astype(np.float64)
        if rot.ndim == 2:                 # SkeletonState: single frame
            rot = rot[None]
            trans = trans[None]
        rot = _qnorm(_xyzw_to_wxyz(rot))
        if not d.get("is_local", True):
            # stored as GLOBAL rotations (e.g. cmu_tpose.npy):
            # L[j] = conj(G[parent]) * G[j]
            glob = rot
            rot = glob.copy()
            for j in range(len(skel.node_names)):
                p = int(skel.parent_indices[j])
                if p >= 0:
                    rot[:, j] = _qmul(_qconj(glob[:, p]), glob[:, j])
        fps = float(_unwrap(d.get("fps", 30.0)))
        return cls(skel, rot, trans, fps)

    def to_file(self, path: str):
        single = self.num_frames == 1
        rot = _wxyz_to_xyzw(self.local_rotation)
        trans = self.root_translation
        if single:
            rot, trans = rot[0], trans[0]
        d = {
            "rotation": _wrap(rot.astype(np.float32)),
            "root_translation": _wrap(trans.astype(np.float32)),
            "skeleton_tree": {
                "node_names": list(self.skeleton.node_names),
                "parent_indices": _wrap(self.skeleton.parent_indices),
                "local_translation": _wrap(
                    self.skeleton.local_translation.astype(np.float32)),
                "__name__": "SkeletonTree",
            },
            "is_local": True,
            "__name__": "SkeletonState" if single else "SkeletonMotion",
        }
        if not single:
            d["fps"] = self.fps
        np.save(path, d, allow_pickle=True)


# ---------------------------------------------------------------------------
# retargeting (skeleton3d.py retarget_to semantics)
# ---------------------------------------------------------------------------


def retarget(source: SkeletonMotion, source_tpose: SkeletonMotion,
             target_tpose: SkeletonMotion, joint_mapping: dict,
             rotation_xyzw, scale: float,
             root_height_offset: float = 0.0,
             trim: tuple = (-1, -1)) -> SkeletonMotion:
    """Retarget `source` onto the target skeleton. joint_mapping maps
    source node names -> target node names (retarget config schema,
    `data/configs/retarget_cmu_to_amp.json`)."""
    R = _xyzw_to_wxyz(np.asarray(rotation_xyzw, np.float64))

    b, e = trim
    b = 0 if b == -1 else b
    e = source.num_frames if e == -1 else e
    src = SkeletonMotion(source.skeleton, source.local_rotation[b:e],
                         source.root_translation[b:e], source.fps)

    # STEP 2: rotate source (state + tpose) into the target orientation
    def rotated(m):
        rot = m.local_rotation.copy()
        rot[:, 0] = _qmul(np.broadcast_to(R, rot[:, 0].shape), rot[:, 0])
        return SkeletonMotion(
            m.skeleton, _qnorm(rot),
            _qrot(np.broadcast_to(R, m.root_translation.shape[:-1] + (4,)),
                  m.root_translation), m.fps)

    src = rotated(src)
    stp = rotated(source_tpose)

    # STEP 3: root-translation delta, scaled to the target skeleton
    t_diff = (src.root_translation - stp.root_translation) * scale

    # STEP 4: per-joint global-rotation delta re-applied to the target
    # tpose. Unmapped target joints inherit the nearest mapped ancestor's
    # rotation delta (skeleton3d.py:960-968).
    g_src, _ = src.fk()
    g_stp, _ = stp.fk()
    g_ttp, _ = target_tpose.fk()
    tskel = target_tpose.skeleton
    F = src.num_frames
    J_t = len(tskel.node_names)
    inv_map = {v: k for k, v in joint_mapping.items()}
    new_global = np.zeros((F, J_t, 4))
    for tj, tname in enumerate(tskel.node_names):
        # nearest self-or-ancestor with a mapped source joint
        name = tname
        while name not in inv_map:
            pi = int(tskel.parent_indices[tskel.index(name)])
            assert pi >= 0, f"no mapped ancestor for target joint {tname}"
            name = tskel.node_names[pi]
        sj = src.skeleton.index(inv_map[name])
        diff = _qmul(g_src[:, sj], _qconj(g_stp[0, sj])[None])
        new_global[:, tj] = _qmul(diff, np.broadcast_to(
            g_ttp[0, tskel.index(name)], diff.shape))
    new_global = _qnorm(new_global)

    # STEP 5: globals -> locals on the target tree
    new_local = np.zeros_like(new_global)
    for tj in range(J_t):
        p = int(tskel.parent_indices[tj])
        if p < 0:
            new_local[:, tj] = new_global[:, tj]
        else:
            new_local[:, tj] = _qmul(_qconj(new_global[:, p]),
                                     new_global[:, tj])
    root_t = target_tpose.root_translation[0][None] + t_diff
    out = SkeletonMotion(tskel, _qnorm(new_local), root_t, src.fps)

    # feet on the ground + root height offset (retarget_motion.py:260-270)
    _, g_pos = out.fk()
    foot_ids = [tskel.index(n) for n in tskel.node_names
                if n.endswith("foot")]
    if foot_ids:
        min_h = float(g_pos[:, foot_ids, 2].min())
        out.root_translation[:, 2] += -min_h + root_height_offset
    return out


def project_joints(motion: SkeletonMotion) -> SkeletonMotion:
    """Collapse 3-DOF elbows/knees to pure hinges about local y, moving
    the residual swing into the shoulder/hip (retarget_motion.py:52-216)."""
    sk = motion.skeleton
    g_rot, g_pos = motion.fk()
    new_local = motion.local_rotation.copy()

    def _collapse(upper, lower, end, sign):
        iu, il, ie = sk.index(upper), sk.index(lower), sk.index(end)
        d0 = g_pos[:, iu] - g_pos[:, il]
        d1 = g_pos[:, ie] - g_pos[:, il]
        d0 /= np.linalg.norm(d0, axis=-1, keepdims=True) + 1e-12
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True) + 1e-12
        dot = np.clip(np.sum(-d0 * d1, axis=-1), -1.0, 1.0)
        theta = np.arccos(dot)
        hinge_q = _from_angle_axis(sign * np.abs(theta), (0.0, 1.0, 0.0))
        # residual twist about the bone axis joins the parent joint
        local_dir = sk.local_translation[ie]
        local_dir = local_dir / (np.linalg.norm(local_dir) + 1e-12)
        prev_rot = motion.local_rotation[:, il]
        dir0 = _qrot(prev_rot, local_dir[None])
        dir1 = _qrot(hinge_q, local_dir[None])
        adot = np.clip(np.sum(dir0 * dir1, axis=-1), -1.0, 1.0)
        atheta = np.arccos(adot)
        atheta = np.where(dir0[..., 1] <= 0 if sign < 0 else
                          dir0[..., 1] >= 0, atheta, -atheta)
        twist_q = _from_angle_axis(atheta, local_dir)
        new_local[:, iu] = _qnorm(_qmul(motion.local_rotation[:, iu],
                                        twist_q))
        new_local[:, il] = np.broadcast_to(hinge_q, new_local[:, il].shape)

    _collapse("right_upper_arm", "right_lower_arm", "right_hand", -1.0)
    _collapse("left_upper_arm", "left_lower_arm", "left_hand", -1.0)
    _collapse("right_thigh", "right_shin", "right_foot", 1.0)
    _collapse("left_thigh", "left_shin", "left_foot", 1.0)
    # hands: identity (retarget_motion.py:200-201)
    for n in ("right_hand", "left_hand"):
        if n in sk.node_names:
            new_local[:, sk.index(n)] = np.array([1.0, 0, 0, 0])
    return SkeletonMotion(sk, new_local, motion.root_translation.copy(),
                          motion.fps)


# ---------------------------------------------------------------------------
# AMP clip conversion
# ---------------------------------------------------------------------------


def to_amp_clip(motion: SkeletonMotion) -> dict:
    """SkeletonMotion on the amp_humanoid skeleton -> MotionLib clip dict
    (learn/motion_lib.canonicalize_clip layout)."""
    from thormang_isaacgym_tpu_torch.learn.motion_lib import canonicalize_clip
    from thormang_isaacgym_tpu_torch.models import amp_humanoid as AH

    sk = motion.skeleton
    F = motion.num_frames
    local = np.zeros((F, len(AH._JOINTS), 4))
    for j, (name, _, _, _) in enumerate(AH._JOINTS):
        local[:, j] = motion.local_rotation[:, sk.index(name)]
    root_rot = motion.local_rotation[:, sk.index("pelvis")]
    return canonicalize_clip(motion.root_translation, root_rot, local,
                             motion.fps)


def amp_tpose_path() -> str:
    """Where the reference's AMP humanoid T-pose (a SkeletonState .npy,
    which the repository does not hold yet) belongs: ``assets/amp/``."""
    return os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", "assets", "amp",
                                         "amp_humanoid_tpose.npy"))


def load_motion_file(path: str, retarget_cfg: str | dict | None = None):
    """Load a SkeletonMotion npy or a binary .fbx mocap file -> MotionLib
    clip.

    If the motion's skeleton is not the AMP humanoid, `retarget_cfg` (a
    retarget config json path or dict, reference schema) retargets it
    first. A .fbx file goes through learn/fbx.py."""
    if path.endswith(".fbx"):
        from thormang_isaacgym_tpu_torch.learn.fbx import load_fbx_motion
        m = load_fbx_motion(path)
    else:
        m = SkeletonMotion.from_file(path)
    amp_nodes = {"pelvis", "torso", "head", "right_upper_arm",
                 "left_upper_arm", "right_thigh", "left_thigh"}
    if not amp_nodes <= set(m.skeleton.node_names):
        assert retarget_cfg is not None, \
            f"{path}: non-AMP skeleton needs a retarget config"
        cfg = retarget_cfg
        if isinstance(cfg, str):
            with open(cfg) as f:
                cfg = json.load(f)
        src_tpose = SkeletonMotion.from_file(cfg["source_tpose"])
        tgt_tpose = SkeletonMotion.from_file(cfg["target_tpose"])
        m = retarget(
            m, src_tpose, tgt_tpose, cfg["joint_mapping"],
            cfg["rotation"], cfg["scale"],
            root_height_offset=cfg.get("root_height_offset", 0.0),
            trim=(cfg.get("trim_frame_beg", -1),
                  cfg.get("trim_frame_end", -1)))
        m = project_joints(m)
    elif any(n in m.skeleton.node_names for n in ("right_hand",)):
        m = project_joints(m)
    return to_amp_clip(m)


# ---------------------------------------------------------------------------
# visualization (poselib/visualization equivalent: matplotlib skeleton plots)
# ---------------------------------------------------------------------------


def plot_skeleton_motion(motion: SkeletonMotion, path: str,
                         stride: int = 4, elev: float = 20.0,
                         azim: float = 45.0):
    """Animated 3-D skeleton plot -> GIF (or a single-frame PNG for a
    SkeletonState). The matplotlib counterpart of the reference's
    `poselib/visualization/` plotter (plot_skeleton_motion_interactive):
    bones as segments between each joint and its parent, world-frame,
    equal axes. Headless-safe (Agg)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    _, g_pos = motion.fk()
    g_pos = g_pos[::max(1, int(stride))]
    par = motion.skeleton.parent_indices
    lo, hi = g_pos.min(axis=(0, 1)), g_pos.max(axis=(0, 1))
    c = 0.5 * (lo + hi)
    r = 0.6 * float((hi - lo).max() + 1e-6)

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    ax.view_init(elev=elev, azim=azim)
    lines = [ax.plot([], [], [], "o-", lw=2, ms=2,
                     color="tab:blue")[0]
             for j in range(len(par)) if par[j] >= 0]
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)

    def draw(f):
        li = 0
        for j in range(len(par)):
            p = int(par[j])
            if p < 0:
                continue
            seg = g_pos[f][[p, j]]
            lines[li].set_data(seg[:, 0], seg[:, 1])
            lines[li].set_3d_properties(seg[:, 2])
            li += 1
        return lines

    if len(g_pos) == 1 or path.endswith(".png"):
        draw(0)
        fig.savefig(path, dpi=90)
    else:
        anim = FuncAnimation(fig, draw, frames=len(g_pos), blit=False)
        anim.save(path, writer=PillowWriter(
            fps=max(1, int(motion.fps / max(1, int(stride))))))
    plt.close(fig)
    return path
