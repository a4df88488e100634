"""Motion clip library for AMP. Port of
``thormang_isaacgym_tpu/learn/motion_lib.py``.

Every clip is canonicalized at load time (numpy, the JAX package's code kept
as its own copy) into framewise state arrays, clamp-padded to a common
length and stacked into tensors on the device, so ``get_motion_state`` is a
gather and a lerp / slerp over any batch of (motion, time) pairs, with no
host round trip, inside the env's reset and the demo fetch.

Canonical per-frame state (the reference's ``get_motion_state`` outputs):
root_pos, root_rot (wxyz), dof_pos, root_vel, root_ang_vel, dof_vel,
key_pos. DOF values use the model's intrinsic z-y-x Euler chart
(``models/amp_humanoid.py``) instead of the reference's exponential map;
dof_vel is the wrapped finite difference of dof_pos.

``sample_motions`` and ``sample_time`` draw from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.models import amp_humanoid as AH


# ---------------------------------------------------------------------------
# host-side clip canonicalization (numpy)
# ---------------------------------------------------------------------------

def _np_quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def _np_quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _np_quat_rotate(q, v):
    w = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def _np_quat_to_euler_zyx(q):
    """Intrinsic z-y-x Euler angles (qz, qy, qx) s.t.
    R = Rz(qz) @ Ry(qy) @ Rx(qx)."""
    w, x, y, z = np.moveaxis(q, -1, 0)
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([yaw, pitch, roll], axis=-1)


def _wrap(a):
    return np.mod(a + np.pi, 2 * np.pi) - np.pi


# skeleton tree for host-side FK: name -> (parent, anchor)
_TREE = {n: (p, np.asarray(a)) for n, p, a, _ in AH._JOINTS}
for _h, _p, _a in AH._HANDS:
    _TREE[_h] = (_p, np.asarray(_a))
_DOF_BODY_NAMES = [n for n, _, _, _ in AH._JOINTS]


def canonicalize_clip(root_pos, root_rot, local_rot, fps):
    """(F,3) root pos, (F,4) wxyz root rot, (F,12,4) per-DOF-body local
    rotations, fps -> dict of framewise state arrays (the device layout)."""
    F = root_pos.shape[0]
    dt = 1.0 / fps
    # dof_pos: intrinsic z-y-x Euler per spherical joint; y angle for 1-DOF
    dof_pos = np.zeros((F, AH.NUM_DOF), np.float64)
    for j, (name, _, _, size) in enumerate(AH._JOINTS):
        o = AH.DOF_OFFSETS[j]
        e = _np_quat_to_euler_zyx(local_rot[:, j])
        if size == 3:
            dof_pos[:, o:o + 3] = e
        else:
            dof_pos[:, o] = e[:, 1]   # pure-y joint: the pitch angle
    # velocities: wrapped finite differences, last frame repeats
    dof_vel = np.zeros_like(dof_pos)
    dof_vel[:-1] = _wrap(dof_pos[1:] - dof_pos[:-1]) / dt
    dof_vel[-1] = dof_vel[-2]
    root_vel = np.zeros_like(root_pos)
    root_vel[:-1] = (root_pos[1:] - root_pos[:-1]) / dt
    root_vel[-1] = root_vel[-2]
    # world angular velocity from quat differences
    dq = _np_quat_mul(root_rot[1:], _np_quat_conj(root_rot[:-1]))
    angle = 2.0 * np.arctan2(np.linalg.norm(dq[:, 1:4], axis=-1), np.abs(dq[:, 0]))
    sgn = np.where(dq[:, 0:1] < 0, -1.0, 1.0)
    axis = sgn * dq[:, 1:4] / (np.linalg.norm(dq[:, 1:4], axis=-1, keepdims=True) + 1e-9)
    root_ang_vel = np.zeros_like(root_pos)
    root_ang_vel[:-1] = axis * angle[:, None] / dt
    root_ang_vel[-1] = root_ang_vel[-2]
    # key body positions via skeleton FK
    g_rot = {"pelvis": root_rot}
    g_pos = {"pelvis": root_pos}
    for j, name in enumerate(_DOF_BODY_NAMES):
        parent, anchor = _TREE[name]
        g_pos[name] = g_pos[parent] + _np_quat_rotate(g_rot[parent],
                                                      anchor[None, :])
        g_rot[name] = _np_quat_mul(g_rot[parent], local_rot[:, j])
    for h, parent, anchor in AH._HANDS:
        g_pos[h] = g_pos[parent] + _np_quat_rotate(g_rot[parent],
                                                   np.asarray(anchor)[None, :])
        g_rot[h] = g_rot[parent]
    key_pos = np.stack([g_pos[k] for k in AH.KEY_BODY_NAMES], axis=1)
    return dict(
        root_pos=root_pos.astype(np.float32),
        root_rot=root_rot.astype(np.float32),
        dof_pos=dof_pos.astype(np.float32),
        root_vel=root_vel.astype(np.float32),
        root_ang_vel=root_ang_vel.astype(np.float32),
        dof_vel=dof_vel.astype(np.float32),
        key_pos=key_pos.astype(np.float32),
        fps=np.float32(fps),
    )


def _euler_y_quat(theta):
    """(F,) angle about y -> (F,4) wxyz."""
    half = 0.5 * np.asarray(theta)
    q = np.zeros(half.shape + (4,))
    q[..., 0] = np.cos(half)
    q[..., 2] = np.sin(half)
    return q


def make_gait_clip(fps: int = 30, cycle: float = 0.7, n_cycles: int = 4,
                   speed: float = 2.8, hip_amp: float = 0.6,
                   knee_amp: float = 1.0, arm_amp: float = 0.45):
    """Procedural run/walk cycle — the demo data stands in for the absent
    `assets/amp/motions/amp_humanoid_run.npy` (HumanoidAMP.yaml motion_file).

    Sinusoidal sagittal gait: hips counter-phase, knee flexion on the swing
    leg, ankle compensation, counter-phase arm swing, root bob + constant
    forward speed."""
    F = int(round(cycle * n_cycles * fps)) + 1
    t = np.arange(F) / fps
    ph = 2 * np.pi * t / cycle
    hip_r = hip_amp * np.sin(ph)
    hip_l = hip_amp * np.sin(ph + np.pi)
    # knee flexes (positive) during the leg's swing phase
    knee_r = knee_amp * np.clip(np.sin(ph + 0.4 * np.pi), 0, None)
    knee_l = knee_amp * np.clip(np.sin(ph + 1.4 * np.pi), 0, None)
    ankle_r = -0.3 * np.sin(ph) - 0.1
    ankle_l = -0.3 * np.sin(ph + np.pi) - 0.1
    sh_r = arm_amp * np.sin(ph + np.pi)
    sh_l = arm_amp * np.sin(ph)
    elb = -0.6 + 0.15 * np.sin(ph)
    zero = np.zeros(F)
    local = {
        "torso": _euler_y_quat(0.06 * np.sin(2 * ph)),
        "head": _euler_y_quat(zero),
        "right_upper_arm": _euler_y_quat(sh_r),
        "right_lower_arm": _euler_y_quat(elb),
        "left_upper_arm": _euler_y_quat(sh_l),
        "left_lower_arm": _euler_y_quat(elb),
        "right_thigh": _euler_y_quat(hip_r),
        "right_shin": _euler_y_quat(knee_r),
        "right_foot": _euler_y_quat(ankle_r - hip_r - knee_r),
        "left_thigh": _euler_y_quat(hip_l),
        "left_shin": _euler_y_quat(knee_l),
        "left_foot": _euler_y_quat(ankle_l - hip_l - knee_l),
    }
    local_rot = np.stack([local[n] for n in _DOF_BODY_NAMES], axis=1)
    root_pos = np.stack([
        speed * t, zero, AH.PELVIS_HEIGHT - 0.02 + 0.015 * np.sin(2 * ph)],
        axis=-1)
    root_rot = np.zeros((F, 4))
    root_rot[:, 0] = 1.0
    return canonicalize_clip(root_pos, root_rot, local_rot, fps)


def save_clip(path: str, clip: dict):
    np.savez(path, **clip)


def load_clip(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}



# ---------------------------------------------------------------------------
# device-side library
# ---------------------------------------------------------------------------

class MotionLib:
    """Padded, stacked motion dataset with batched state lookup on `device`."""

    def __init__(self, clips, weights=None, device="cpu"):
        """clips: list of canonicalized clip dicts; weights: sampling weights
        (the reference's weighted choice)."""
        if not clips:
            raise ValueError("MotionLib needs at least one clip")
        M = len(clips)
        Fmax = max(c["root_pos"].shape[0] for c in clips)
        self.device = torch.device(device)

        def pad(key, extra_shape):
            out = np.zeros((M, Fmax) + extra_shape, np.float32)
            for i, c in enumerate(clips):
                f = c[key].shape[0]
                out[i, :f] = c[key]
                out[i, f:] = c[key][-1]          # clamp-pad with the last frame
            return torch.as_tensor(out, device=self.device)

        K = clips[0]["key_pos"].shape[1]
        D = clips[0]["dof_pos"].shape[1]
        self.root_pos = pad("root_pos", (3,))
        self.root_rot = pad("root_rot", (4,))
        self.dof_pos = pad("dof_pos", (D,))
        self.root_vel = pad("root_vel", (3,))
        self.root_ang_vel = pad("root_ang_vel", (3,))
        self.dof_vel = pad("dof_vel", (D,))
        self.key_pos = pad("key_pos", (K, 3))
        fps = np.array([float(c["fps"]) for c in clips], np.float32)
        nf = np.array([c["root_pos"].shape[0] for c in clips], np.int32)
        self.dt = torch.as_tensor(1.0 / fps, device=self.device)
        self.num_frames = torch.as_tensor(nf, device=self.device)
        self.lengths = torch.as_tensor(((nf - 1) / fps).astype(np.float32), device=self.device)
        w = np.ones(M) if weights is None else np.asarray(weights, np.float64)
        self.weights = torch.as_tensor(w / w.sum(), dtype=torch.float32, device=self.device)

    def num_motions(self):
        return self.root_pos.shape[0]

    def total_length(self):
        """The clips' summed length, seconds."""
        return float(torch.sum(self.lengths))

    # ---- sampling ----
    def ids_at(self, u: torch.Tensor) -> torch.Tensor:
        """The motion ids of uniform draws `u` in [0, 1) by `weights` (the
        inverse of their cumulative sum)."""
        cdf = torch.cumsum(self.weights, 0)
        return torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True),
                           max=self.num_motions() - 1)

    def sample_motions(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """n motion ids drawn by `weights`."""
        return self.ids_at(torch.rand(n, generator=gen, device=self.device))

    def sample_time(self, gen: torch.Generator, motion_ids):
        phase = torch.rand(motion_ids.shape, generator=gen, device=self.device)
        return phase * self.lengths[motion_ids]

    def get_motion_state(self, motion_ids, motion_times):
        """Blended motion state at arbitrary times (the reference's
        ``get_motion_state``): a gather and a lerp / slerp; shapes follow
        motion_ids. The frame index is phase x (frames - 1), truncated."""
        length = self.lengths[motion_ids]
        nf = self.num_frames[motion_ids]
        dt = self.dt[motion_ids]
        phase = torch.clamp(motion_times / torch.clamp(length, min=1e-6), 0.0, 1.0)
        f0 = (phase * (nf - 1)).to(torch.int64)
        f1 = torch.minimum(f0 + 1, nf.to(torch.int64) - 1)
        blend = torch.clamp((motion_times - f0 * dt) / dt, 0.0, 1.0)[..., None]

        def g(arr, f):
            return arr[motion_ids, f]

        root_pos = (1 - blend) * g(self.root_pos, f0) + blend * g(self.root_pos, f1)
        root_rot = Q.slerp(g(self.root_rot, f0), g(self.root_rot, f1), blend)
        dof_pos = (1 - blend) * g(self.dof_pos, f0) + blend * g(self.dof_pos, f1)
        b2 = blend[..., None]
        key_pos = (1 - b2) * g(self.key_pos, f0) + b2 * g(self.key_pos, f1)
        root_vel = g(self.root_vel, f0)
        root_ang_vel = g(self.root_ang_vel, f0)
        dof_vel = g(self.dof_vel, f0)
        return (root_pos, root_rot, dof_pos, root_vel, root_ang_vel, dof_vel, key_pos)


def _load_any(path: str) -> dict:
    """One clip from the .npz layout, a reference poselib SkeletonMotion
    .npy, or a binary .fbx mocap file (learn/fbx.py). A CMU clip (``cmu`` in
    its name) retargets through the reference's own config beside it,
    ``configs/retarget_cmu_to_amp.json``, with ``cmu_tpose.npy`` and
    ``amp_humanoid_tpose.npy`` from its directory and its first two frames
    (the exporter's bind pose) trimmed."""
    from thormang_isaacgym_tpu_torch.learn import poselib
    if path.endswith(".npy"):
        return poselib.load_motion_file(path)
    if path.endswith(".fbx"):
        cfg = None
        if "cmu" in os.path.basename(path):
            base = os.path.dirname(os.path.abspath(path))
            cfg_path = os.path.join(base, "configs", "retarget_cmu_to_amp.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    cfg = json.load(f)
                cfg = dict(cfg, source_tpose=os.path.join(base, "cmu_tpose.npy"),
                           target_tpose=os.path.join(base, "amp_humanoid_tpose.npy"),
                           trim_frame_beg=2, trim_frame_end=-1)
        return poselib.load_motion_file(path, retarget_cfg=cfg)
    return load_clip(path)


def default_motion_lib(motion_file: str | None = None, device="cpu") -> MotionLib:
    """Load clips (npz, or reference-format SkeletonMotion npy, or a
    directory of either); fall back to the procedural gait clip when the
    file is absent, as the JAX package does."""
    if motion_file and os.path.exists(motion_file):
        if os.path.isdir(motion_file):
            clips = [_load_any(os.path.join(motion_file, f))
                     for f in sorted(os.listdir(motion_file))
                     if f.endswith((".npz", ".npy", ".fbx"))]
        else:
            clips = [_load_any(motion_file)]
        return MotionLib(clips, device=device)
    return MotionLib([make_gait_clip()], device=device)
