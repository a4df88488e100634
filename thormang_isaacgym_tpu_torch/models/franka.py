"""Franka Panda arm model (shared by FrankaCabinet / FrankaCubeStack /
factory tasks). Port of ``thormang_isaacgym_tpu/models/franka.py``; the
URDF text and the defaults are the same, so both packages compile the arm
to the same model.

The reference loads `urdf/franka_description/robots/franka_panda.urdf`
(the reference's `cfg/task/FrankaCabinet.yaml:33`), an asset absent from
this repository (SURVEY.md §0 gap table). The model here is
re-derived from the public Panda kinematic parameters (the franka_description
joint frames/limits, which are printed on every Panda spec sheet) with
approximate link inertias — the task-relevant quantities (kinematic chain,
joint limits, effort limits, default drive gains at
`franka_cabinet.py:162-196`) match the reference's usage.

Joint layout (9 DOFs): panda_joint1..7 revolute + two prismatic fingers.
`panda_hand` (fixed) merges into link7; named sites survive for the grasp
frame ("panda_grasp", midway between fingertips) used by the tasks.
"""
from __future__ import annotations

import numpy as np

from thormang_isaacgym_tpu_torch.models.urdf import load_urdf

# (name, parent, xyz, rpy, axis, lower, upper, effort, velocity)
_ARM_JOINTS = [
    ("panda_joint1", "panda_link0", "0 0 0.333", "0 0 0",
     (-2.8973, 2.8973), 87, 2.175),
    ("panda_joint2", "panda_link1", "0 0 0", "-1.57079632679 0 0",
     (-1.7628, 1.7628), 87, 2.175),
    ("panda_joint3", "panda_link2", "0 -0.316 0", "1.57079632679 0 0",
     (-2.8973, 2.8973), 87, 2.175),
    ("panda_joint4", "panda_link3", "0.0825 0 0", "1.57079632679 0 0",
     (-3.0718, -0.0698), 87, 2.175),
    ("panda_joint5", "panda_link4", "-0.0825 0.384 0", "-1.57079632679 0 0",
     (-2.8973, 2.8973), 12, 2.61),
    ("panda_joint6", "panda_link5", "0 0 0", "1.57079632679 0 0",
     (-0.0175, 3.7525), 12, 2.61),
    ("panda_joint7", "panda_link6", "0.088 0 0", "1.57079632679 0 0",
     (-2.8973, 2.8973), 12, 2.61),
]

# identified-dynamics ballpark masses (Gaz et al. 2019, public)
_LINK_MASS = {
    "panda_link0": 2.92, "panda_link1": 4.97, "panda_link2": 0.65,
    "panda_link3": 3.23, "panda_link4": 3.59, "panda_link5": 1.23,
    "panda_link6": 1.67, "panda_link7": 0.74, "panda_hand": 0.73,
    # fingers carry the gripper-motor mass (0.2 kg): the penalty-contact
    # stability cap scales with the reduced mass, so heavier fingers grip
    # with stiffer (stable) springs; grip effort (10 N) is capped below the
    # max maximum static contact force (kn_stable * available interference)
    # so the fingers can't tunnel through a grasped object
    "panda_leftfinger": 0.20, "panda_rightfinger": 0.20,
}

# default franka DOF drive gains, FrankaCabinet-style
# (franka_cabinet.py:162-163): arm PD 400/80, fingers stiff 1e6/1e2
FRANKA_DEFAULT_STIFFNESS = np.array([400.0] * 7 + [1.0e6] * 2, np.float32)
FRANKA_DEFAULT_DAMPING = np.array([80.0] * 7 + [1.0e2] * 2, np.float32)
FRANKA_DEFAULT_DOF_POS = np.array(
    [1.157, -1.066, -0.155, -2.239, -1.841, 1.003, 0.469, 0.035, 0.035],
    np.float32)  # franka_cabinet.py:93
# OSC-style default pose (franka_cube_stack.py: franka_default_dof_pos)
FRANKA_CUBE_DOF_POS = np.array(
    [0.0, 0.1963, 0.0, -2.6180, 0.0, 2.9416, 0.7854, 0.035, 0.035],
    np.float32)


def _link(name, com=(0, 0, 0), collision=""):
    m = _LINK_MASS.get(name, 0.5)
    # blocky diagonal inertia about the com — adequate for control parity
    i = max(0.3 * m * 0.05, 1e-4)
    return f"""
  <link name="{name}">
    <inertial><origin xyz="{com[0]} {com[1]} {com[2]}"/><mass value="{m}"/>
      <inertia ixx="{i:.5f}" iyy="{i:.5f}" izz="{i:.5f}" ixy="0" ixz="0" iyz="0"/></inertial>{collision}
  </link>"""


def make_franka_urdf() -> str:
    parts = [_link("panda_link0")]
    coms = {
        "panda_link1": (0, -0.03, -0.12), "panda_link2": (0, -0.03, 0.03),
        "panda_link3": (0.03, 0.02, -0.07), "panda_link4": (-0.05, 0.07, 0.03),
        "panda_link5": (0, 0.04, -0.11), "panda_link6": (0.06, -0.01, 0),
        "panda_link7": (0, 0, 0.08),
    }
    for (jname, parent, xyz, rpy, (lo, hi), eff, vel) in _ARM_JOINTS:
        child = "panda_link" + str(int(jname[-1]))
        parts.append(f"""
  <joint name="{jname}" type="revolute">
    <parent link="{parent}"/><child link="{child}"/>
    <origin xyz="{xyz}" rpy="{rpy}"/><axis xyz="0 0 1"/>
    <limit lower="{lo}" upper="{hi}" effort="{eff}" velocity="{vel}"/>
    <dynamics damping="0.0"/>
  </joint>""")
        parts.append(_link(child, coms[child]))
    # hand (fixed, merges into link7) + grasp site + fingers.
    # Finger collision is a FLAT BOX PAD (the real Panda finger face): a
    # patch contact (4 vertex candidates through the box-box narrowphase)
    # resists the grasp-rotation mode that two point contacts above the
    # object's COM cannot — a sphere-pad grip lets the object pitch about
    # the contact line and swing out.
    finger_col = """
    <collision name="{n}_pad"><origin xyz="0 {iy} 0.032"/>
      <geometry><box size="0.018 0.012 0.036"/></geometry></collision>"""
    parts.append(f"""
  <joint name="panda_hand_joint" type="fixed">
    <parent link="panda_link7"/><child link="panda_hand"/>
    <origin xyz="0 0 0.107" rpy="0 0 -0.78539816340"/>
  </joint>{_link("panda_hand", (0, 0, 0.02))}
  <joint name="panda_grasp_joint" type="fixed">
    <parent link="panda_hand"/><child link="panda_grasp"/>
    <origin xyz="0 0 0.1034"/>
  </joint>
  <link name="panda_grasp">
    <inertial><mass value="1e-6"/>
      <inertia ixx="1e-9" iyy="1e-9" izz="1e-9" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <joint name="panda_finger_joint1" type="prismatic">
    <parent link="panda_hand"/><child link="panda_leftfinger"/>
    <origin xyz="0 0 0.0584"/><axis xyz="0 1 0"/>
    <limit lower="0.0" upper="0.04" effort="20" velocity="0.2"/>
  </joint>{_link("panda_leftfinger", (0, 0.01, 0.03),
                 finger_col.format(n="panda_leftfinger", iy=-0.006))}
  <joint name="panda_finger_joint2" type="prismatic">
    <parent link="panda_hand"/><child link="panda_rightfinger"/>
    <origin xyz="0 0 0.0584"/><axis xyz="0 -1 0"/>
    <limit lower="0.0" upper="0.04" effort="20" velocity="0.2"/>
  </joint>{_link("panda_rightfinger", (0, -0.01, 0.03),
                 finger_col.format(n="panda_rightfinger", iy=0.006))}""")
    return "<robot name=\"franka_panda\">" + "".join(parts) + "\n</robot>"


def load_franka(armature: float = 0.01, disable_gravity: bool = True):
    """Fixed-base Panda RobotModel with FrankaCabinet-style drive defaults
    (all 9 DOFs position-driven). Gravity is disabled on the arm by default,
    matching the reference's asset options (`franka_cube_stack.py:201`,
    `franka_cabinet.py:148`) — the OSC controller (:602-628) carries no
    gravity-compensation term and assumes it."""
    m = load_urdf(make_franka_urdf(), fix_base_link=True, armature=armature,
                  disable_gravity=disable_gravity)
    d = m._defaults
    nj = m.nj
    mode = np.full(nj, 1, np.int32)  # DRIVE_POS
    kp = np.zeros(nj, np.float32)
    kd = np.zeros(nj, np.float32)
    for i in range(7):
        k = m.dof_id(f"panda_joint{i+1}")
        kp[k] = FRANKA_DEFAULT_STIFFNESS[i]
        kd[k] = FRANKA_DEFAULT_DAMPING[i]
    for i, jn in enumerate(["panda_finger_joint1", "panda_finger_joint2"]):
        k = m.dof_id(jn)
        kp[k] = FRANKA_DEFAULT_STIFFNESS[7 + i]
        kd[k] = FRANKA_DEFAULT_DAMPING[7 + i]
    d["drive_mode"] = mode
    d["drive_stiffness"] = kp
    d["drive_damping"] = kd
    return m


def franka_dof_ids(model, prefix=""):
    """The 9 franka dof indices within a composed scene, in panda order."""
    names = [f"panda_joint{i}" for i in range(1, 8)] + \
        ["panda_finger_joint1", "panda_finger_joint2"]
    return [model.dof_id(prefix + n) for n in names]
