"""The AMP humanoid, generated in code. Port of
``thormang_isaacgym_tpu/models/amp_humanoid.py``; the URDF string is the JAX
package's character for character.

A DeepMimic-style humanoid of 15 segments and 28 DOFs (the reference's
``humanoid_amp_base.py`` skeleton: pelvis, torso, head, upper and lower arms,
hands, thighs, shins, feet). Each 3-DOF spherical joint is a chain of three
revolute sub-joints about the intrinsic z, y and x axes through two
near-massless links (``<name>__zy``, ``<name>__yx``), so its three DOF values
are intrinsic z-y-x Euler angles; elbows and knees are revolute about local
y. The hands hang on fixed joints, which ``load_urdf`` merges into the lower
arms: they stay addressable as sites, and the model has 29 bodies (the pelvis,
12 segments, 16 sub-joint links), 28 joints, nq 35, nv 34.

``AMP_DOF_NAMES`` and ``DOF_OFFSETS`` give the reference's DOF layout;
``amp_dof_perm`` maps it onto the model's DOF order. ``KEY_BODY_NAMES`` are
the hands and feet of the AMP observation, ``CONTACT_BODY_NAMES`` the feet
(the bodies allowed to touch the ground).
"""
from __future__ import annotations

import numpy as np

from thormang_isaacgym_tpu_torch.models.robot import DRIVE_POS
from thormang_isaacgym_tpu_torch.models.urdf import load_urdf

# AMP joint spec: (name, parent body, anchor in parent frame, size)
# listed in reference DOF order (DOF_BODY_IDS order).
_JOINTS = [
    ("torso", "pelvis", (0.0, 0.0, 0.12), 3),
    ("head", "torso", (0.0, 0.0, 0.25), 3),
    ("right_upper_arm", "torso", (0.0, -0.19, 0.22), 3),
    ("right_lower_arm", "right_upper_arm", (0.0, 0.0, -0.28), 1),
    ("left_upper_arm", "torso", (0.0, 0.19, 0.22), 3),
    ("left_lower_arm", "left_upper_arm", (0.0, 0.0, -0.28), 1),
    ("right_thigh", "pelvis", (0.0, -0.09, -0.05), 3),
    ("right_shin", "right_thigh", (0.0, 0.0, -0.40), 1),
    ("right_foot", "right_shin", (0.0, 0.0, -0.40), 3),
    ("left_thigh", "pelvis", (0.0, 0.09, -0.05), 3),
    ("left_shin", "left_thigh", (0.0, 0.0, -0.40), 1),
    ("left_foot", "left_shin", (0.0, 0.0, -0.40), 3),
]

# per-body (mass, collision-geom URDF snippet)
_CAPS_Z = ('<collision name="{n}"><origin xyz="0 0 {zc}"/>'
           '<geometry><capsule radius="{r}" length="{l}"/></geometry></collision>')


def _caps(n, r, length, z0):
    """Capsule along -z starting at z0."""
    return _CAPS_Z.format(n=n, r=r, l=length, zc=z0 - length / 2)


_BODIES = {
    "pelvis": (9.0, '<collision name="pelvis"><origin xyz="0 0 0"/>'
                    '<geometry><sphere radius="0.11"/></geometry></collision>'),
    "torso": (14.0, '<collision name="torso"><origin xyz="0 0 0.12"/>'
                    '<geometry><capsule radius="0.11" length="0.12"/></geometry></collision>'),
    "head": (3.5, '<collision name="head"><origin xyz="0 0 0.06"/>'
                  '<geometry><sphere radius="0.095"/></geometry></collision>'),
    "right_upper_arm": (1.5, _caps("rua", 0.045, 0.16, -0.04)),
    "right_lower_arm": (1.0, _caps("rla", 0.04, 0.14, -0.03)),
    "left_upper_arm": (1.5, _caps("lua", 0.045, 0.16, -0.04)),
    "left_lower_arm": (1.0, _caps("lla", 0.04, 0.14, -0.03)),
    "right_thigh": (4.5, _caps("rth", 0.055, 0.24, -0.06)),
    "right_shin": (2.8, _caps("rsh", 0.05, 0.26, -0.05)),
    "left_thigh": (4.5, _caps("lth", 0.055, 0.24, -0.06)),
    "left_shin": (2.8, _caps("lsh", 0.05, 0.26, -0.05)),
    # feet: boxes, sole 0.055 below the ankle
    "right_foot": (1.0, '<collision name="rft"><origin xyz="0.045 0 -0.0275"/>'
                        '<geometry><box size="0.177 0.09 0.055"/></geometry></collision>'),
    "left_foot": (1.0, '<collision name="lft"><origin xyz="0.045 0 -0.0275"/>'
                       '<geometry><box size="0.177 0.09 0.055"/></geometry></collision>'),
}

# hands: fixed-jointed (no DOFs) -> merged into the lower arms, addressable
# as sites for the key-body observations
_HANDS = [("right_hand", "right_lower_arm", (0.0, 0.0, -0.25)),
          ("left_hand", "left_lower_arm", (0.0, 0.0, -0.25))]

# PD gains / effort per joint group (the MJCF actuator table is absent with
# the asset; gains chosen for critically-damped-ish tracking at the body
# masses above)
_GAINS = {
    "torso": (600.0, 60.0, 200.0), "head": (100.0, 10.0, 50.0),
    "right_upper_arm": (300.0, 30.0, 100.0), "left_upper_arm": (300.0, 30.0, 100.0),
    "right_lower_arm": (200.0, 20.0, 70.0), "left_lower_arm": (200.0, 20.0, 70.0),
    "right_thigh": (500.0, 50.0, 200.0), "left_thigh": (500.0, 50.0, 200.0),
    "right_shin": (400.0, 40.0, 150.0), "left_shin": (400.0, 40.0, 150.0),
    "right_foot": (300.0, 30.0, 100.0), "left_foot": (300.0, 30.0, 100.0),
}

# 1-DOF joint limits: knee flexes backward (+y rotation), elbow forward
_LIMITS_1DOF = {
    "right_lower_arm": (-2.7, 0.0), "left_lower_arm": (-2.7, 0.0),
    "right_shin": (0.0, 2.7), "left_shin": (0.0, 2.7),
}
# spherical sub-joint limit per group
_LIMITS_SPH = {"torso": 1.2, "head": 1.2, "right_foot": 1.0, "left_foot": 1.0}

PELVIS_HEIGHT = 0.89            # humanoid_amp_base.py:209 start pose z

# joint names in the reference AMP DOF layout (28 entries): spherical joints
# expand to _z/_y/_x sub-joints in that order (intrinsic z-y-x Euler)
AMP_DOF_NAMES = []
DOF_OFFSETS = [0]               # humanoid_amp_base.py:42 parity
for _n, _p, _a, _s in _JOINTS:
    if _s == 3:
        AMP_DOF_NAMES += [f"{_n}_z", f"{_n}_y", f"{_n}_x"]
    else:
        AMP_DOF_NAMES.append(f"{_n}_y")
    DOF_OFFSETS.append(DOF_OFFSETS[-1] + _s)
AMP_DOF_NAMES = tuple(AMP_DOF_NAMES)
NUM_DOF = DOF_OFFSETS[-1]       # 28

KEY_BODY_NAMES = ("right_hand", "left_hand", "right_foot", "left_foot")
CONTACT_BODY_NAMES = ("right_foot", "left_foot")   # HumanoidAMP.yaml contactBodies


def _link(name, mass, col=""):
    i = max(mass * 2.5e-3, 1e-6)
    return (f'<link name="{name}"><inertial><origin xyz="0 0 0"/>'
            f'<mass value="{mass}"/>'
            f'<inertia ixx="{i:.6f}" iyy="{i:.6f}" izz="{i:.6f}" '
            f'ixy="0" ixz="0" iyz="0"/></inertial>{col}</link>')


def _rev(name, parent, child, xyz, axis, lo, hi, effort):
    return (f'<joint name="{name}" type="revolute">'
            f'<parent link="{parent}"/><child link="{child}"/>'
            f'<origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}"/>'
            f'<axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>'
            f'<limit lower="{lo}" upper="{hi}" effort="{effort}" velocity="30"/>'
            f'<dynamics damping="0.1"/></joint>')


def make_amp_humanoid_urdf() -> str:
    parts = ['<robot name="amp_humanoid">']
    m, col = _BODIES["pelvis"]
    parts.append(_link("pelvis", m, col))
    for name, parent, anchor, size in _JOINTS:
        m, col = _BODIES[name]
        _, _, eff = _GAINS[name]
        if size == 3:
            lim = _LIMITS_SPH.get(name, np.pi)
            # z, y, x sub-joint chain; intermediates near-massless
            parts.append(_rev(f"{name}_z", parent, f"{name}__zy", anchor,
                              (0, 0, 1), -lim, lim, eff))
            parts.append(_link(f"{name}__zy", 0.001))
            parts.append(_rev(f"{name}_y", f"{name}__zy", f"{name}__yx",
                              (0, 0, 0), (0, 1, 0), -lim, lim, eff))
            parts.append(_link(f"{name}__yx", 0.001))
            parts.append(_rev(f"{name}_x", f"{name}__yx", name, (0, 0, 0),
                              (1, 0, 0), -lim, lim, eff))
            parts.append(_link(name, m, col))
        else:
            lo, hi = _LIMITS_1DOF[name]
            parts.append(_rev(f"{name}_y", parent, name, anchor, (0, 1, 0),
                              lo, hi, eff))
            parts.append(_link(name, m, col))
    for hname, hparent, hanchor in _HANDS:
        parts.append(f'<joint name="{hname}_fix" type="fixed">'
                     f'<parent link="{hparent}"/><child link="{hname}"/>'
                     f'<origin xyz="{hanchor[0]} {hanchor[1]} {hanchor[2]}"/></joint>')
        parts.append(_link(hname, 0.5,
                           f'<collision name="{hname}"><origin xyz="0 0 0"/>'
                           '<geometry><sphere radius="0.04"/></geometry></collision>'))
    parts.append("</robot>")
    return "\n".join(parts)


def load_amp_humanoid():
    """Floating-base AMP humanoid with PD position drives on all 28 DOFs
    (pdControl: True, HumanoidAMP.yaml; pre_physics_step at
    humanoid_amp_base.py:365-368)."""
    model = load_urdf(make_amp_humanoid_urdf(), armature=0.01,
                      name="amp_humanoid")
    assert model.nj == NUM_DOF, model.nj
    d = model._defaults
    kp = np.zeros(model.nj, np.float32)
    kd = np.zeros(model.nj, np.float32)
    eff = np.zeros(model.nj, np.float32)
    for name, parent, anchor, size in _JOINTS:
        subs = [f"{name}_z", f"{name}_y", f"{name}_x"] if size == 3 \
            else [f"{name}_y"]
        g_kp, g_kd, g_eff = _GAINS[name]
        for s in subs:
            j = model.dof_id(s)
            kp[j], kd[j], eff[j] = g_kp, g_kd, g_eff
    d["drive_mode"] = np.full(model.nj, DRIVE_POS, np.int32)
    d["drive_stiffness"] = kp
    d["drive_damping"] = kd
    d["drive_effort_limit"] = eff
    return model


def amp_dof_perm(model) -> np.ndarray:
    """Model-layout DOF index for each AMP-layout DOF:
    ``q_joints[perm] == dof_pos_amp_layout``."""
    return np.array([model.dof_id(n) for n in AMP_DOF_NAMES], np.int32)
