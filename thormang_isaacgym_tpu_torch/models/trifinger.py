"""The TriFinger platform and its cube, generated as URDF. Port of
``thormang_isaacgym_tpu/models/trifinger.py`` (the same strings, so both
packages compile the same model).

The reference's TriFingerPro URDF is re-derived from the task's own
dimensions: three fingers 120 degrees apart on a fixed base, each an
abduction joint about the mount's x axis at radius 0.0455 m and height
0.29 m, an upper-link pitch and an elbow pitch; links of 0.16 m with
capsule collision and a 10.5 mm fingertip sphere; limits low [-0.33, 0.0,
-2.7] / high [1.0, 1.57, 0.0], default [0.0, 0.9, -2.0] per finger; 0.36 N m
and 10 rad/s. 13 links: the fingertip frames ``finger_tip_link_{0,120,240}``
merge into the lower links on their fixed joints and stay as sites. The cube
is 65 mm and 16 g.
"""
from __future__ import annotations

import numpy as np

from thormang_isaacgym_tpu_torch.models.robot import DRIVE_EFFORT
from thormang_isaacgym_tpu_torch.models.urdf import load_urdf

FINGER_ANGLES = (0.0, 120.0, 240.0)     # degrees; frame names use these
JOINT_LOW = (-0.33, 0.0, -2.7)          # trifinger.py:243
JOINT_HIGH = (1.0, 1.57, 0.0)
JOINT_DEFAULT = (0.0, 0.9, -2.0)
MAX_TORQUE = 0.36                        # trifinger.py:208
MAX_VELOCITY = 10.0
ARENA_RADIUS = 0.195                     # trifinger.py:95
BASE_Z = 0.29                            # mount height of the upper joints
L1, L2 = 0.16, 0.16                      # upper / lower link lengths
TIP_R = 0.0105


def _link(name, mass, col=""):
    i = max(mass * 1e-3, 1e-7)
    return (f'<link name="{name}"><inertial><origin xyz="0 0 0"/>'
            f'<mass value="{mass}"/>'
            f'<inertia ixx="{i:.7f}" iyy="{i:.7f}" izz="{i:.7f}" '
            f'ixy="0" ixz="0" iyz="0"/></inertial>{col}</link>')


def make_trifinger_urdf() -> str:
    p = ['<robot name="trifinger">', _link("base_link", 2.0)]
    for ang in FINGER_ANGLES:
        th = np.deg2rad(ang)
        c, s = np.cos(th), np.sin(th)
        tag = str(int(ang))
        mx, my = 0.0455 * c, 0.0455 * s
        # mount frame rotated by ang about z (rpy = 0 0 th)
        p.append(
            f'<joint name="finger_base_to_upper_joint_{tag}" type="revolute">'
            f'<parent link="base_link"/><child link="finger_upper_link_{tag}"/>'
            f'<origin xyz="{mx} {my} {BASE_Z}" rpy="0 0 {th}"/>'
            f'<axis xyz="1 0 0"/>'
            f'<limit lower="{JOINT_LOW[0]}" upper="{JOINT_HIGH[0]}" '
            f'effort="{MAX_TORQUE}" velocity="{MAX_VELOCITY}"/>'
            f'<dynamics damping="0.003"/></joint>')
        p.append(_link(f"finger_upper_link_{tag}", 0.2))
        p.append(
            f'<joint name="finger_upper_to_middle_joint_{tag}" type="revolute">'
            f'<parent link="finger_upper_link_{tag}"/>'
            f'<child link="finger_middle_link_{tag}"/>'
            f'<origin xyz="0 0.014 0"/><axis xyz="0 1 0"/>'
            f'<limit lower="{JOINT_LOW[1]}" upper="{JOINT_HIGH[1]}" '
            f'effort="{MAX_TORQUE}" velocity="{MAX_VELOCITY}"/>'
            f'<dynamics damping="0.003"/></joint>')
        p.append(_link(
            f"finger_middle_link_{tag}", 0.22,
            f'<collision name="mid_{tag}"><origin xyz="0 0 {-L1 / 2}"/>'
            f'<geometry><capsule radius="0.012" length="{L1 - 0.03}"/>'
            '</geometry></collision>'))
        p.append(
            f'<joint name="finger_middle_to_lower_joint_{tag}" type="revolute">'
            f'<parent link="finger_middle_link_{tag}"/>'
            f'<child link="finger_lower_link_{tag}"/>'
            f'<origin xyz="0 0 {-L1}"/><axis xyz="0 1 0"/>'
            f'<limit lower="{JOINT_LOW[2]}" upper="{JOINT_HIGH[2]}" '
            f'effort="{MAX_TORQUE}" velocity="{MAX_VELOCITY}"/>'
            f'<dynamics damping="0.001"/></joint>')
        p.append(_link(
            f"finger_lower_link_{tag}", 0.03,
            f'<collision name="low_{tag}"><origin xyz="0 0 {-L2 / 2}"/>'
            f'<geometry><capsule radius="0.009" length="{L2 - 0.04}"/>'
            '</geometry></collision>'
            f'<collision name="tip_{tag}"><origin xyz="0 0 {-L2}"/>'
            f'<geometry><sphere radius="{TIP_R}"/></geometry></collision>'))
        # fingertip frame (trifinger.py:212-214)
        p.append(
            f'<joint name="finger_tip_joint_{tag}" type="fixed">'
            f'<parent link="finger_lower_link_{tag}"/>'
            f'<child link="finger_tip_link_{tag}"/>'
            f'<origin xyz="0 0 {-L2}"/></joint>')
        p.append(_link(f"finger_tip_link_{tag}", 0.01))
    p.append("</robot>")
    return "\n".join(p)


def load_trifinger():
    """Fixed-base, torque-commanded (command_mode torque is the config
    default, Trifinger.yaml:24): effort drives, the task writes torques."""
    m = load_urdf(make_trifinger_urdf(), fix_base_link=True, armature=2e-4,
                  name="trifinger")
    assert m.nj == 9, m.nj
    d = m._defaults
    d["drive_mode"] = np.full(m.nj, DRIVE_EFFORT, np.int32)
    d["drive_effort_limit"] = np.full(m.nj, MAX_TORQUE, np.float32)
    return m


def trifinger_dof_ids(model, prefix: str = ""):
    """9 DOF indices in the reference's per-finger order."""
    names = []
    for ang in FINGER_ANGLES:
        tag = str(int(ang))
        names += [f"finger_base_to_upper_joint_{tag}",
                  f"finger_upper_to_middle_joint_{tag}",
                  f"finger_middle_to_lower_joint_{tag}"]
    return [model.dof_id(prefix + n) for n in names]


def make_cube_urdf(size: float = 0.065, mass: float = 0.016) -> str:
    """The trifinger cube (re-derived; the competition cube is 65 mm,
    16 g per the task's CuboidalObject(0.065), trifinger.py:195)."""
    i = mass * size * size / 6
    return (f'<robot name="tricube"><link name="cube">'
            f'<inertial><origin xyz="0 0 0"/><mass value="{mass}"/>'
            f'<inertia ixx="{i:.9f}" iyy="{i:.9f}" izz="{i:.9f}" '
            f'ixy="0" ixz="0" iyz="0"/></inertial>'
            f'<collision name="cube"><origin xyz="0 0 0"/>'
            f'<geometry><box size="{size} {size} {size}"/></geometry>'
            f'</collision></link></robot>')
