"""Shadow Dexterous Hand model, procedurally derived. Port of
``thormang_isaacgym_tpu/models/shadow_hand.py``: the same URDF string, drive
gains and tendon table.

The reference task loads `mjcf/open_ai_assets/hand/shadow_hand.xml`
(isaacgymenvs `tasks/shadow_hand.py:225`), an asset that is not in this
repository, so the hand is re-derived from the public Shadow Dexterous Hand
(E-series) kinematic spec:

- 24 DOFs: wrist WRJ1/WRJ0; FF/MF/RF fingers x (J3 abduction + J2/J1/J0
  flexion); LF adds LFJ4 (palm arch); thumb THJ4..THJ0
- 20 actuators: every DOF except the four distal FFJ0/MFJ0/RFJ0/LFJ0,
  which follow their J1 through fixed tendons (T_*J1c) with
  limit_stiffness 30 / damping 0.1 — the exact values the reference writes
  via set_asset_tendon_properties (reference `shadow_hand.py:252-260`)
- fingertip bodies named robot0:{ff,mf,rf,lf,th}distal
  (reference `shadow_hand.py:121`), carrying the force-sensor view
- fixed base, gravity disabled on the hand (asset options,
  reference `shadow_hand.py:238-241`)

Segment lengths/limits are the public Shadow spec; collision is capsule-per-
phalanx + palm box (primitives in place of the MJCF meshes). The palm faces
+z (up) with fingers along -y, matching the reference scene where the object
spawns 0.39 m along -y and ~0.10 m above the hand root (reference
`shadow_hand.py:306-312`).
"""
from __future__ import annotations

import numpy as np

from thormang_isaacgym_tpu_torch.models.urdf import load_urdf

# (finger, base x) — knuckle positions across the palm front edge
_FINGERS = [("ff", 0.033), ("mf", 0.011), ("rf", -0.011), ("lf", -0.033)]

# public Shadow joint limits (rad)
_LIMITS = {
    "WRJ1": (-0.489, 0.140), "WRJ0": (-0.698, 0.489),
    "J3": (-0.349, 0.349), "J2": (0.0, 1.571), "J1": (0.0, 1.571),
    "J0": (0.0, 1.571), "LFJ4": (0.0, 0.785),
    "THJ4": (-1.047, 1.047), "THJ3": (0.0, 1.222), "THJ2": (-0.209, 0.209),
    "THJ1": (-0.524, 0.524), "THJ0": (-1.571, 0.0),
}

PALM_TOP_LOCAL = 0.065          # palm top surface (local z)
PALM_CENTER_Y = -0.36


def _link(name, mass, com=(0, 0, 0), inertia=None, collision=""):
    i = inertia if inertia is not None else max(mass * 2e-4, 1e-6)
    return f"""
  <link name="{name}">
    <inertial><origin xyz="{com[0]} {com[1]} {com[2]}"/><mass value="{mass}"/>
      <inertia ixx="{i:.7f}" iyy="{i:.7f}" izz="{i:.7f}" ixy="0" ixz="0" iyz="0"/></inertial>{collision}
  </link>"""


def _capsule_y(name, r, length, y0=0.0):
    """Capsule along -y from y0 (capsule axis = local z needs rpy)."""
    yc = y0 - length / 2
    return f"""
    <collision name="{name}"><origin xyz="0 {yc} 0" rpy="1.5707963 0 0"/>
      <geometry><capsule radius="{r}" length="{length}"/></geometry></collision>"""


def _joint(name, jtype, parent, child, xyz, axis, lo, hi, effort, vel=4.0,
           damping=0.05):
    # vel 4.0: the Shadow Hand datasheet joint speed (~4 rad/s). The
    # r3 model used 3.0; 10 rad/s was tried while diagnosing the
    # reorientation plateau and made exploratory flailing bat the held
    # cube off the palm — the datasheet value keeps finger-cube
    # interaction impulses physical.
    return f"""
  <joint name="{name}" type="revolute">
    <parent link="{parent}"/><child link="{child}"/>
    <origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}"/><axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>
    <limit lower="{lo}" upper="{hi}" effort="{effort}" velocity="{vel}"/>
    <dynamics damping="{damping}"/>
  </joint>"""


def make_shadow_hand_urdf() -> str:
    parts = []
    # forearm (root) with a slab collision
    parts.append(_link("robot0:forearm", 1.8, com=(0, -0.14, 0), collision="""
    <collision name="forearm_col"><origin xyz="0 -0.14 0.01"/>
      <geometry><box size="0.06 0.28 0.05"/></geometry></collision>"""))
    # wrist
    lo, hi = _LIMITS["WRJ1"]
    parts.append(_joint("robot0:WRJ1", "revolute", "robot0:forearm",
                        "robot0:wrist", (0, -0.29, 0), (1, 0, 0), lo, hi, 4.8))
    parts.append(_link("robot0:wrist", 0.1, com=(0, -0.015, 0)))
    lo, hi = _LIMITS["WRJ0"]
    parts.append(_joint("robot0:WRJ0", "revolute", "robot0:wrist",
                        "robot0:palm", (0, -0.034, 0), (0, 1, 0), lo, hi, 2.2))
    # palm: box, top surface at local z=PALM_TOP_LOCAL (world 0.565 at the
    # reference hand pose z=0.5); object rests on it
    # palm slab + the raised little-finger metacarpal ridge along the -x
    # edge (the real hand's hypothenar bump; the public Shadow Hand MJCF
    # models it as a dedicated lfmetacarpal box geom). Without it the palm
    # is an open shelf: the held cube escapes -x (away from the thumb)
    # under any finger activity, so every manipulation attempt ends the
    # episode and "hold still" becomes the learned optimum.
    # (the slab reaches y +0.034 — the carpal heel of the real palm, which
    # continues into the wrist at palm-back height rather than dropping
    # off a cliff 3 cm above the forearm)
    parts.append(_link("robot0:palm", 0.3, com=(0, -0.036, 0.05), collision=f"""
    <collision name="palm_col"><origin xyz="0 -0.0285 0.053"/>
      <geometry><box size="0.084 0.125 0.024"/></geometry></collision>
    <collision name="palm_lfm_ridge"><origin xyz="-0.040 -0.0285 0.068"/>
      <geometry><box size="0.008 0.125 0.018"/></geometry></collision>"""))

    seg = dict(proximal=0.045, middle=0.025, distal=0.026)
    r_ph = 0.009
    palm_edge_y = PALM_CENTER_Y + 0.36 - 0.091   # knuckles, palm frame y
    for (f, x) in _FINGERS:
        F = f.upper()
        base = "robot0:palm"
        kx, ky, kz = x, palm_edge_y, 0.055
        if f == "lf":
            # LFJ4 palm arch: extra metacarpal link
            lo, hi = _LIMITS["LFJ4"]
            parts.append(_joint(f"robot0:{F}J4", "revolute", "robot0:palm",
                                f"robot0:{f}metacarpal", (x, ky + 0.02, 0.045),
                                (0, 1, 0), lo, hi, 0.9))
            parts.append(_link(f"robot0:{f}metacarpal", 0.03,
                               com=(0, -0.01, 0.01)))
            base = f"robot0:{f}metacarpal"
            kx, ky, kz = 0.0, -0.02, 0.01
        lo, hi = _LIMITS["J3"]
        parts.append(_joint(f"robot0:{F}J3", "revolute", base,
                            f"robot0:{f}knuckle", (kx, ky, kz), (0, 0, 1),
                            lo, hi, 0.9))
        parts.append(_link(f"robot0:{f}knuckle", 0.008))
        lo, hi = _LIMITS["J2"]
        parts.append(_joint(f"robot0:{F}J2", "revolute", f"robot0:{f}knuckle",
                            f"robot0:{f}proximal", (0, 0, 0), (1, 0, 0),
                            lo, hi, 0.9))
        parts.append(_link(f"robot0:{f}proximal", 0.030,
                           com=(0, -seg["proximal"] / 2, 0),
                           collision=_capsule_y(f"{f}_prox", r_ph, seg["proximal"])))
        lo, hi = _LIMITS["J1"]
        parts.append(_joint(f"robot0:{F}J1", "revolute", f"robot0:{f}proximal",
                            f"robot0:{f}middle", (0, -seg["proximal"], 0),
                            (1, 0, 0), lo, hi, 0.9))
        parts.append(_link(f"robot0:{f}middle", 0.017,
                           com=(0, -seg["middle"] / 2, 0),
                           collision=_capsule_y(f"{f}_mid", r_ph, seg["middle"])))
        lo, hi = _LIMITS["J0"]
        parts.append(_joint(f"robot0:{F}J0", "revolute", f"robot0:{f}middle",
                            f"robot0:{f}distal", (0, -seg["middle"], 0),
                            (1, 0, 0), lo, hi, 0.9))
        parts.append(_link(f"robot0:{f}distal", 0.012,
                           com=(0, -seg["distal"] / 2, 0),
                           collision=_capsule_y(f"{f}_dist", 0.010, seg["distal"])))

    # thumb: 5 DOF chain from the palm's +x edge, opposing the fingers
    tx, ty, tz = 0.034, -0.30, 0.045
    lo, hi = _LIMITS["THJ4"]
    parts.append(_joint("robot0:THJ4", "revolute", "robot0:palm",
                        "robot0:thbase", (tx, ty, tz), (0, 0, 1), lo, hi, 2.4))
    parts.append(_link("robot0:thbase", 0.01))
    lo, hi = _LIMITS["THJ3"]
    parts.append(_joint("robot0:THJ3", "revolute", "robot0:thbase",
                        "robot0:thproximal", (0, 0, 0), (1, 0, 0), lo, hi, 1.3))
    parts.append(_link("robot0:thproximal", 0.04, com=(0.016, -0.016, 0),
                       collision="""
    <collision name="th_prox"><origin xyz="0.016 -0.016 0" rpy="0 1.5707963 0"/>
      <geometry><capsule radius="0.011" length="0.030"/></geometry></collision>"""))
    lo, hi = _LIMITS["THJ2"]
    parts.append(_joint("robot0:THJ2", "revolute", "robot0:thproximal",
                        "robot0:thhub", (0.032, -0.032, 0), (0, 1, 0), lo, hi, 0.9))
    parts.append(_link("robot0:thhub", 0.005))
    lo, hi = _LIMITS["THJ1"]
    parts.append(_joint("robot0:THJ1", "revolute", "robot0:thhub",
                        "robot0:thmiddle", (0, 0, 0), (1, 0, 0), lo, hi, 0.9))
    parts.append(_link("robot0:thmiddle", 0.02, com=(0.011, -0.011, 0),
                       collision="""
    <collision name="th_mid"><origin xyz="0.011 -0.011 0" rpy="0 1.5707963 0"/>
      <geometry><capsule radius="0.010" length="0.022"/></geometry></collision>"""))
    lo, hi = _LIMITS["THJ0"]
    parts.append(_joint("robot0:THJ0", "revolute", "robot0:thmiddle",
                        "robot0:thdistal", (0.022, -0.022, 0), (0, 1, 0), lo, hi, 0.9))
    parts.append(_link("robot0:thdistal", 0.016, com=(0.012, -0.012, 0),
                       collision="""
    <collision name="th_dist"><origin xyz="0.012 -0.012 0" rpy="0 1.5707963 0"/>
      <geometry><capsule radius="0.010" length="0.024"/></geometry></collision>"""))

    return "<robot name=\"shadow_hand\">" + "".join(parts) + "\n</robot>"


# 20 actuated DOFs, in the reference's actuator order (wrist then fingers
# then thumb; distal J0s excluded — tendon-coupled)
ACTUATED_DOF_NAMES = (
    ["robot0:WRJ1", "robot0:WRJ0"]
    + [f"robot0:{F}J{k}" for F in ("FF", "MF", "RF") for k in (3, 2, 1)]
    + ["robot0:LFJ4"] + [f"robot0:LFJ{k}" for k in (3, 2, 1)]
    + [f"robot0:THJ{k}" for k in (4, 3, 2, 1, 0)]
)

FINGERTIP_BODIES = tuple(f"robot0:{f}distal" for f in ("ff", "mf", "rf", "lf", "th"))


def load_shadow_hand(armature: float = 1e-4):
    """Fixed-base Shadow Hand with position drives on the 20 actuated DOFs
    and T_*J1c tendons coupling each J0 to its J1."""
    m = load_urdf(make_shadow_hand_urdf(), fix_base_link=True,
                  armature=armature, disable_gravity=True)
    d = m._defaults
    nj = m.nj
    assert nj == 24, nj
    mode = np.zeros(nj, np.int32)
    kp = np.zeros(nj, np.float32)
    kd = np.zeros(nj, np.float32)
    for name in ACTUATED_DOF_NAMES:
        j = m.dof_id(name)
        mode[j] = 1  # DRIVE_POS
        wrist = name.startswith("robot0:WR")
        kp[j] = 100.0 if wrist else 3.0
        kd[j] = 4.0 if wrist else 0.1
    d["drive_mode"] = mode
    d["drive_stiffness"] = kp
    d["drive_damping"] = kd

    # tendons: q_J0 - q_J1 in [-0.05, 0.05], limit_stiffness 30, damping 0.1
    # (shadow_hand.py:252-260)
    tendons = []
    for F in ("FF", "MF", "RF", "LF"):
        coef = np.zeros(nj, np.float32)
        coef[m.dof_id(f"robot0:{F}J0")] = 1.0
        coef[m.dof_id(f"robot0:{F}J1")] = -1.0
        tendons.append((tuple(coef.tolist()), -0.05, 0.05, f"robot0:T_{F}J1c"))
    d["tendon_stiffness"] = np.full(len(tendons), 30.0, np.float32)
    d["tendon_damping"] = np.full(len(tendons), 0.1, np.float32)
    import dataclasses as _dc
    m = _dc.replace(m, tendons=tuple(tendons))
    return m


def make_block_urdf(size: float = 0.065, mass: float = 0.108) -> str:
    """The manipulated block (cube_multicolor.urdf equivalent)."""
    i = mass * size * size / 6
    return f"""
<robot name="block">
  <link name="object">
    <inertial><mass value="{mass}"/>
      <inertia ixx="{i:.6f}" iyy="{i:.6f}" izz="{i:.6f}" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision name="object_box"><geometry><box size="{size} {size} {size}"/></geometry></collision>
  </link>
</robot>"""
