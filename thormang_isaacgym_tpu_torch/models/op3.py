"""ROBOTIS OP3 humanoid and its carry table, generated as URDF. Port of
``thormang_isaacgym_tpu/models/op3.py`` (the same strings, so both packages
compile the same models).

The reference's ``robotis_op3v3.urdf`` and ``TableV4.urdf`` are re-derived
from the public OP3 spec (0.51 m, ~3.5 kg, 20 + 2 gripper DOFs) with the DOF
names and order of the reference config (``cfg/task/MA_OP3.yaml``
defaultJointAngles: head_pan, head_tilt, l_hip_yaw/roll/pitch, l_knee,
l_ank_pitch/roll, l_sho_pitch/roll, l_el, l_gr, then the right side).

Collision geoms: a torso box, two foot boxes (the feet air-time and no-fly
rewards), two gripper spheres (the grip-hold reward). The table is a box top
on four box legs, its root frame at the top's centre.

The drives (``load_op3``): position drives of kp 1000, kd 200 and an effort
limit of 4.1 N m on all 22 joints, armature 2e-4; each link's inertia is
max(mass x 1.5e-3, 5e-7) on the diagonal.
"""
from __future__ import annotations

import numpy as np

from thormang_isaacgym_tpu_torch.models.robot import DRIVE_POS
from thormang_isaacgym_tpu_torch.models.urdf import load_urdf

# reference DOF order (MA_OP3.yaml defaultJointAngles)
OP3_DOF_NAMES = (
    "head_pan", "head_tilt",
    "l_hip_yaw", "l_hip_roll", "l_hip_pitch", "l_knee", "l_ank_pitch",
    "l_ank_roll", "l_sho_pitch", "l_sho_roll", "l_el", "l_gr",
    "r_hip_yaw", "r_hip_roll", "r_hip_pitch", "r_knee", "r_ank_pitch",
    "r_ank_roll", "r_sho_pitch", "r_sho_roll", "r_el", "r_gr",
)
DEFAULT_JOINT_ANGLES = {
    "head_pan": 0.0, "head_tilt": 0.0,
    "l_hip_yaw": 0.0, "l_hip_roll": 0.0, "l_hip_pitch": -0.95,
    "l_knee": 1.49, "l_ank_pitch": 0.0, "l_ank_roll": 0.0,
    "l_sho_pitch": 0.0, "l_sho_roll": 0.0, "l_el": 0.0, "l_gr": 0.0,
    "r_hip_yaw": 0.0, "r_hip_roll": 0.0, "r_hip_pitch": 0.95,
    "r_knee": -1.49, "r_ank_pitch": 0.0, "r_ank_roll": 0.0,
    "r_sho_pitch": 0.0, "r_sho_roll": 0.0, "r_el": 0.0, "r_gr": 0.0,
}

BASE_Z = 0.27          # baseInitState pos z ~0.255-0.27 (MA_OP3.yaml:24, MA_OP3.py:217)
TABLE_Z = 0.30         # table root height (MA_OP3.py:229)

_AX = {"x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1)}


def _link(name, mass, col=""):
    i = max(mass * 1.5e-3, 5e-7)
    return (f'<link name="{name}"><inertial><origin xyz="0 0 0"/>'
            f'<mass value="{mass}"/>'
            f'<inertia ixx="{i:.7f}" iyy="{i:.7f}" izz="{i:.7f}" '
            f'ixy="0" ixz="0" iyz="0"/></inertial>{col}</link>')


def _joint(name, parent, child, xyz, ax, lo=-2.6, hi=2.6, effort=4.1,
           flip=False):
    a = tuple(-v for v in _AX[ax]) if flip else _AX[ax]
    return (f'<joint name="{name}" type="revolute">'
            f'<parent link="{parent}"/><child link="{child}"/>'
            f'<origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}"/>'
            f'<axis xyz="{a[0]} {a[1]} {a[2]}"/>'
            f'<limit lower="{lo}" upper="{hi}" effort="{effort}" velocity="12"/>'
            f'<dynamics damping="0.05"/></joint>')


def make_op3_urdf() -> str:
    p = ['<robot name="op3">']
    p.append(_link("body_link", 1.4,
                   '<collision name="torso"><origin xyz="0 0 0.02"/>'
                   '<geometry><box size="0.10 0.11 0.14"/></geometry></collision>'))
    # head: pan (z) then tilt (y)
    p.append(_joint("head_pan", "body_link", "head_pan_link",
                    (0.0, 0.0, 0.10), "z"))
    p.append(_link("head_pan_link", 0.02))
    p.append(_joint("head_tilt", "head_pan_link", "head_link",
                    (0.0, 0.0, 0.02), "y"))
    p.append(_link("head_link", 0.15))
    for s, sy in (("l", 1.0), ("r", -1.0)):
        # right-side joint axes are mirrored (the reference's signed default
        # angles: l_hip_pitch -0.95 / r_hip_pitch +0.95 crouch symmetrically)
        fl = s == "r"
        # ---- leg: hip yaw -> roll -> pitch, knee, ankle pitch -> roll ----
        p.append(_joint(f"{s}_hip_yaw", "body_link", f"{s}_hip_yaw_link",
                        (0.0, sy * 0.044, -0.055), "z", flip=fl))
        p.append(_link(f"{s}_hip_yaw_link", 0.05))
        p.append(_joint(f"{s}_hip_roll", f"{s}_hip_yaw_link",
                        f"{s}_hip_roll_link", (0.0, 0.0, -0.02), "x", flip=fl))
        p.append(_link(f"{s}_hip_roll_link", 0.05))
        p.append(_joint(f"{s}_hip_pitch", f"{s}_hip_roll_link",
                        f"{s}_thigh_link", (0.0, 0.0, 0.0), "y", flip=fl))
        p.append(_link(f"{s}_thigh_link", 0.3))
        # shin carries no collision geom: every cross-actor geom pair costs
        # a narrowphase kernel instance per substep, and knees never touch
        # the table/partner in practice (torso+feet+grippers suffice)
        p.append(_joint(f"{s}_knee", f"{s}_thigh_link", f"{s}_shin_link",
                        (0.0, 0.0, -0.095), "y", flip=fl))
        p.append(_link(f"{s}_shin_link", 0.25))
        p.append(_joint(f"{s}_ank_pitch", f"{s}_shin_link",
                        f"{s}_ank_pitch_link", (0.0, 0.0, -0.095), "y",
                        flip=fl))
        p.append(_link(f"{s}_ank_pitch_link", 0.05))
        p.append(_joint(f"{s}_ank_roll", f"{s}_ank_pitch_link",
                        f"{s}_ank_link", (0.0, 0.0, 0.0), "x", flip=fl))
        p.append(_link(f"{s}_ank_link", 0.12,
                       f'<collision name="{s}_foot"><origin xyz="0.012 0 -0.022"/>'
                       '<geometry><box size="0.124 0.066 0.026"/></geometry>'
                       '</collision>'))
        # ---- arm: shoulder pitch -> roll, elbow, gripper ----
        p.append(_joint(f"{s}_sho_pitch", "body_link", f"{s}_sho_link",
                        (0.0, sy * 0.075, 0.06), "y", flip=fl))
        p.append(_link(f"{s}_sho_link", 0.03))
        p.append(_joint(f"{s}_sho_roll", f"{s}_sho_link", f"{s}_uarm_link",
                        (0.0, sy * 0.015, 0.0), "x", flip=fl))
        p.append(_link(f"{s}_uarm_link", 0.12))
        p.append(_joint(f"{s}_el", f"{s}_uarm_link", f"{s}_farm_link",
                        (0.0, 0.0, -0.09), "y", flip=fl))
        p.append(_link(f"{s}_farm_link", 0.1))
        # gripper: small revolute finger with a contact sphere at the tip
        p.append(_joint(f"{s}_gr", f"{s}_farm_link", f"{s}_gr_link",
                        (0.02, 0.0, -0.11), "y", lo=-1.2, hi=1.2, effort=1.5))
        p.append(_link(f"{s}_gr_link", 0.03,
                       f'<collision name="{s}_gripper"><origin xyz="0.01 0 -0.01"/>'
                       '<geometry><sphere radius="0.014"/></geometry>'
                       '</collision>'))
    p.append("</robot>")
    return "\n".join(p)


def make_table_urdf(half_x=0.28, half_y=0.18, top_z=0.32, thick=0.04,
                    mass=6.0) -> str:
    """Free-standing carry table (TableV4 equivalent): box top + 4 legs,
    root frame at the top center (z={TABLE_Z})."""
    leg_len = top_z - thick
    i = mass * 0.02
    p = ['<robot name="table">']
    legs = ""
    for k, (lx, ly) in enumerate([(1, 1), (1, -1), (-1, 1), (-1, -1)]):
        x, y = lx * (half_x - 0.04), ly * (half_y - 0.04)
        legs += (f'<collision name="leg{k}">'
                 f'<origin xyz="{x} {y} {-thick / 2 - leg_len / 2}"/>'
                 f'<geometry><box size="0.05 0.05 {leg_len}"/></geometry>'
                 '</collision>')
    p.append(
        f'<link name="table"><inertial><origin xyz="0 0 -0.1"/>'
        f'<mass value="{mass}"/>'
        f'<inertia ixx="{i}" iyy="{i}" izz="{i}" ixy="0" ixz="0" iyz="0"/>'
        f'</inertial>'
        f'<collision name="top"><origin xyz="0 0 0"/>'
        f'<geometry><box size="{2 * half_x} {2 * half_y} {thick}"/></geometry>'
        f'</collision>{legs}</link>')
    p.append("</robot>")
    return "\n".join(p)


def load_op3(kp: float = 1000.0, kd: float = 200.0):
    """PD-position-driven OP3 (control.stiffness/damping,
    MA_OP3.yaml:38-41; the reference sets DOF_MODE_EFFORT *and* PD gains —
    MA_OP3.py:253-259 — but its pre_physics_step is dead (`:309-310`);
    completed here as PD position control per the config comment
    'defaultJointAngles = target angles when action = 0.0')."""
    m = load_urdf(make_op3_urdf(), armature=2e-4, name="op3")
    assert m.nj == len(OP3_DOF_NAMES), (m.nj, m.joint_names)
    d = m._defaults
    d["drive_mode"] = np.full(m.nj, DRIVE_POS, np.int32)
    d["drive_stiffness"] = np.full(m.nj, kp, np.float32)
    d["drive_damping"] = np.full(m.nj, kd, np.float32)
    d["drive_effort_limit"] = np.full(m.nj, 4.1, np.float32)
    return m


def load_table():
    return load_urdf(make_table_urdf(), name="table")


def op3_default_dof(model, prefix: str = "") -> np.ndarray:
    out = np.zeros(model.nj, np.float32)
    for name, val in DEFAULT_JOINT_ANGLES.items():
        out[model.dof_id(prefix + name)] = val
    return out
