"""Allegro Hand (Wonik) model, procedurally derived. Port of
``thormang_isaacgym_tpu/models/allegro_hand.py``: the same URDF string and
drive gains.

The reference task loads `urdf/kuka_allegro_description/allegro.urdf`
(isaacgymenvs `tasks/allegro_hand.py`), an asset that is not in this
repository. Re-derived from the public Allegro Hand v4 spec: 16 DOFs
(index/middle/ring fingers + thumb, 4 joints each, all actuated, no
tendons). Palm faces +z, fingers along -y, the scene convention of
models/shadow_hand.py. The fingertip links join their last phalanx through
fixed joints, so they merge into it: 17 bodies.
"""
from __future__ import annotations

import numpy as np

from thormang_isaacgym_tpu_torch.models.urdf import load_urdf

# public Allegro joint limits (rad)
_FINGER_LIMITS = [(-0.47, 0.47), (-0.196, 1.61), (-0.174, 1.709), (-0.227, 1.618)]
_THUMB_LIMITS = [(0.263, 1.396), (-0.105, 1.163), (-0.189, 1.644), (-0.162, 1.719)]
_FINGERS = [("index", 0.045), ("middle", 0.0), ("ring", -0.045)]
_SEG = [0.054, 0.038, 0.026]          # proximal/middle/distal segment lengths
_TH_SEG = [0.055, 0.051, 0.040]


def _link(name, mass, com=(0, 0, 0), collision=""):
    i = max(mass * 2e-4, 1e-6)
    return f"""
  <link name="{name}">
    <inertial><origin xyz="{com[0]} {com[1]} {com[2]}"/><mass value="{mass}"/>
      <inertia ixx="{i:.7f}" iyy="{i:.7f}" izz="{i:.7f}" ixy="0" ixz="0" iyz="0"/></inertial>{collision}
  </link>"""


def _cap_y(name, r, length):
    yc = -length / 2
    return f"""
    <collision name="{name}"><origin xyz="0 {yc} 0" rpy="1.5707963 0 0"/>
      <geometry><capsule radius="{r}" length="{length}"/></geometry></collision>"""


def _joint(name, parent, child, xyz, axis, lo, hi, effort=0.7):
    return f"""
  <joint name="{name}" type="revolute">
    <parent link="{parent}"/><child link="{child}"/>
    <origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}"/><axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>
    <limit lower="{lo}" upper="{hi}" effort="{effort}" velocity="3.0"/>
    <dynamics damping="0.05"/>
  </joint>"""


def make_allegro_urdf() -> str:
    parts = [_link("allegro_base", 0.4, com=(0, -0.02, 0.02), collision="""
    <collision name="palm_col"><origin xyz="0 -0.02 0.025"/>
      <geometry><box size="0.1 0.11 0.03"/></geometry></collision>""")]
    for (f, x) in _FINGERS:
        lo, hi = _FINGER_LIMITS[0]
        parts.append(_joint(f"{f}_joint_0", "allegro_base", f"{f}_base",
                            (x, -0.075, 0.04), (0, 0, 1), lo, hi))
        parts.append(_link(f"{f}_base", 0.01))
        prev = f"{f}_base"
        off = (0.0, 0.0, 0.0)
        for k in range(3):
            lo, hi = _FINGER_LIMITS[k + 1]
            child = f"{f}_link_{k+1}"
            parts.append(_joint(f"{f}_joint_{k+1}", prev, child, off,
                                (1, 0, 0), lo, hi))
            parts.append(_link(child, 0.03, com=(0, -_SEG[k] / 2, 0),
                               collision=_cap_y(f"{f}_c{k}", 0.011, _SEG[k])))
            prev = child
            off = (0.0, -_SEG[k], 0.0)
        # fingertip is the last link (renamed body via fixed joint)
        parts.append(f"""
  <joint name="{f}_tip_joint" type="fixed">
    <parent link="{prev}"/><child link="{f}_link_3_tip"/>
    <origin xyz="0 {-_SEG[2]} 0"/>
  </joint>
  <link name="{f}_link_3_tip">
    <inertial><mass value="1e-4"/>
      <inertia ixx="1e-8" iyy="1e-8" izz="1e-8" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>""")
    # thumb from the +x palm edge
    lo, hi = _THUMB_LIMITS[0]
    parts.append(_joint("thumb_joint_0", "allegro_base", "thumb_base",
                        (0.055, -0.03, 0.035), (0, 0, 1), lo, hi, effort=1.0))
    parts.append(_link("thumb_base", 0.02))
    prev = "thumb_base"
    off = (0.0, 0.0, 0.0)
    for k in range(3):
        lo, hi = _THUMB_LIMITS[k + 1]
        child = f"thumb_link_{k+1}"
        axis = (0, 1, 0) if k == 0 else (1, 0, 0)
        parts.append(_joint(f"thumb_joint_{k+1}", prev, child, off, axis, lo, hi))
        parts.append(_link(child, 0.04, com=(0.0, -_TH_SEG[k] / 2, 0),
                           collision=_cap_y(f"th_c{k}", 0.012, _TH_SEG[k])))
        prev = child
        off = (0.0, -_TH_SEG[k], 0.0)
    return "<robot name=\"allegro_hand\">" + "".join(parts) + "\n</robot>"


ALLEGRO_DOF_NAMES = tuple(
    f"{f}_joint_{k}" for f in ("index", "middle", "ring") for k in range(4)
) + tuple(f"thumb_joint_{k}" for k in range(4))


def load_allegro_hand(armature: float = 1e-4):
    m = load_urdf(make_allegro_urdf(), fix_base_link=True, armature=armature,
                  disable_gravity=True)
    d = m._defaults
    nj = m.nj
    assert nj == 16, nj
    d["drive_mode"] = np.ones(nj, np.int32)     # DRIVE_POS everywhere
    d["drive_stiffness"] = np.full(nj, 3.0, np.float32)
    d["drive_damping"] = np.full(nj, 0.1, np.float32)
    return m
