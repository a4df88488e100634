"""The fused CUDA kernel (thormang_isaacgym_tpu_torch/csrc/fused_step.cu)
against its plain PyTorch version.

On the CPU the kernel source is compiled as host C++ (one loop iteration per
CUDA thread; the CUDA qualifiers defined away), so its per-thread arithmetic,
table layout and packing are checked without a GPU. On a machine with a card
`test_cuda_kernel_matches_plain` launches the real kernel (it skips where
there is none). The heightfield mode is held against its plain twin (ground
planes sampled at the step's input q, frozen across the substeps) on Anymal
over a TerrainGrid and on a single cylinder over a slope, whose rim shift
pins the sampling point (the candidate before the shift). The pair mode
(actor-pair contact and attractors) is held against its plain twin on
BallBalance (the ball resting in the tray or pressed into a leg), on the
pair-capsule scene of tests/test_fused.py (sphere-capsule and capsule-capsule
pairs against a fixed bar), on the same scene over the cylinder's sloped
heightfield, and on a body held by two attractors. The box
instance (block B6: sphere vs box, capsule vs box, box vs box) is held on the
two-actor scenes of tests/test_fused.py's box-kind checks and a ball on a
cube, and on AllegroHand (the cube on the palm and among the fingers, or
pressed into the palm's edge), step by step (``STEPWISE``); its wide layout
(G lanes an env, the host build's threads) bit for bit against its local
layout at G = 2, 4 and 32 on the box scenes, FrankaCabinet, the Screw task
and MA_OP3 (one env a warp), on the card at G = 2-16 on MA_OP3 (several envs
a warp, a pair apart in one env of a warp and near in another:
``test_cuda_wide_layout_matches_local``), and its launch geometry
(``pick_box_geometry``) at the widths and body counts its sweeps measured.
The tendon block
(B4b) is held on the two-link tendon scene of tests/test_fused.py (the
coupled length on both sides of each bound and inside) and on ShadowHand
(four tendons, the cube on its palm), step by step. HumanoidMJCF (22 bodies,
43 ground candidates: over the shared-memory budget) runs the flat instance in
its split layout (the sweep state alone in shared memory), free running, its
net also held at chip_smoke's flat-mode tolerance (atol 1e-2 N); HumanoidAMP
(29 bodies, 38 candidates: over the split layout's budget too) its lean
split layout (the split layout's slice without the candidates' kept state,
recomputed in the contact's second pass), from the gait clip's states on the ground (``amp_contact_state``:
both soles down, or lying on a capsule), held as HumanoidMJCF. Tolerances of
tests/test_fused.py: q atol=rtol 2e-3, qd atol=rtol 2e-2, net atol 1.0 /
rtol 5e-3. This file imports no JAX, so it also runs on a GPU machine
without it: ``python -m pytest tests/test_torch_fused.py --noconftest``."""
import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu_torch.engine.terrain import Heightfield, TerrainGrid
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.franka import load_franka
from thormang_isaacgym_tpu_torch.models.robot import GEOM_CAPSULE
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.ops import collide, fused
from thormang_isaacgym_tpu_torch.ops.dynamics import tendon_sums
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams
from thormang_isaacgym_tpu_torch.tasks import ball_balance as bb
from thormang_isaacgym_tpu_torch.tasks.allegro_hand import AllegroHand
from thormang_isaacgym_tpu_torch.tasks.ant import Ant
from thormang_isaacgym_tpu_torch.tasks.anymal import Anymal
from thormang_isaacgym_tpu_torch.tasks.cartpole import Cartpole
from thormang_isaacgym_tpu_torch.tasks.factory import FactoryTaskNutBoltScrew
from thormang_isaacgym_tpu_torch.tasks.franka_cabinet import FrankaCabinet
from thormang_isaacgym_tpu_torch.tasks.humanoid import HumanoidMJCF
from thormang_isaacgym_tpu_torch.tasks.humanoid_amp import HumanoidAMP
from thormang_isaacgym_tpu_torch.tasks.ingenuity import Ingenuity
from thormang_isaacgym_tpu_torch.tasks.ma_op3 import MA_OP3
from thormang_isaacgym_tpu_torch.tasks.quadcopter import Quadcopter
from thormang_isaacgym_tpu_torch.tasks.shadow_hand import ShadowHand
from thormang_isaacgym_tpu_torch.tasks.trifinger import Trifinger

B = 64
# the tiny floating model of tests/test_fused.py: free sphere + one revolute arm
TINY_URDF = """
<robot name="tiny">
  <link name="base">
    <inertial><mass value="1.0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><sphere radius="0.1"/></geometry></collision>
  </link>
  <link name="arm">
    <inertial><origin xyz="0 0 -0.1"/><mass value="0.3"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -0.2"/><geometry><sphere radius="0.05"/></geometry></collision>
  </link>
  <joint name="hinge" type="revolute">
    <parent link="base"/><child link="arm"/>
    <origin xyz="0.1 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" effort="10" velocity="10"/>
  </joint>
</robot>"""
TINY_SP = dict(dt=1 / 60, substeps=2, contact_stiffness=5e3, contact_damping=100.0)
# one free cylinder (a wheel), for the heightfield mode's rim candidates
CYL_URDF = """
<robot name="wheel">
  <link name="wheel">
    <inertial><mass value="2.0"/>
      <inertia ixx="0.006" iyy="0.006" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><cylinder radius="0.1" length="0.08"/></geometry></collision>
  </link>
</robot>"""
# the pair-capsule scene of tests/test_fused.py: a ball and two capsules on a
# fixed horizontal capsule bar (pairs of the kinds sphere-capsule and capcap)
PAIR_BALL = """
<robot name="ball"><link name="b"><inertial><mass value="0.3"/>
  <inertia ixx="0.0005" iyy="0.0005" izz="0.0005" ixy="0" ixz="0" iyz="0"/>
  </inertial>
  <collision><geometry><sphere radius="0.05"/></geometry></collision>
</link></robot>"""
PAIR_CAP = """
<robot name="cap"><link name="c"><inertial><mass value="0.4"/>
  <inertia ixx="0.001" iyy="0.001" izz="0.0004" ixy="0" ixz="0" iyz="0"/>
  </inertial>
  <collision><geometry><capsule radius="0.04" length="0.2"/></geometry>
  </collision>
</link></robot>"""
PAIR_BAR = """
<robot name="bar"><link name="t"><inertial><mass value="10.0"/>
  <inertia ixx="1" iyy="1" izz="1" ixy="0" ixz="0" iyz="0"/></inertial>
  <collision><geometry><capsule radius="0.08" length="0.8"/></geometry>
  </collision>
</link></robot>"""
PAIR_POSES = ((0.0, 0.02, 0.78, 1, 0, 0, 0), (-0.02, 0.05, 0.75, 0.9238795, 0, 0.3826834, 0),
              (0.04, 0.03, 0.80, 1, 0, 0, 0), (0, 0, 0.6, 0.7071068, 0, 0.7071068, 0))
PAIR_SP = dict(dt=1 / 60, substeps=2, contact_stiffness=2e4, contact_damping=500.0)
# the scene over the cylinder-slope heightfield, placed so that capsule B's
# lower end (resting on the bar) and capsule A's (hanging over the bar's end
# in every fourth env) reach the ground in about half of the envs, up to 3 cm
# deep; the fixed bar's right end lies in the slope
PAIR_TERRAIN_ORIGIN = (-1.3, -1.2)
# one free body held by two attractors: at an off-centre point (the gains below
# their clamps to the point's effective mass I_min / |p|^2) and at its origin
# (the body mass; the gains clamped), above the ground
HELD_URDF = """
<robot name="held"><link name="body"><inertial><mass value="1.0"/>
  <inertia ixx="0.01" iyy="0.02" izz="0.015" ixy="0" ixz="0" iyz="0"/></inertial>
  <collision><geometry><sphere radius="0.1"/></geometry></collision>
</link></robot>"""
HELD_ATTRACTORS = ((0, (0.1, 0.0, 0.05), (0.3, -0.2, 0.6), 500.0, 5.0),
                   (0, (0.0, 0.0, 0.0), (0.2, -0.1, 0.4), 2.0e4, 100.0))


# the two-actor scenes of tests/test_fused.py's box-kind checks, at altitude
# (no ground contact): a cube 2 mm into a fixed cube (turned 5 degrees about
# z: box vs box), a horizontal capsule 2 mm onto it (capsule vs box), and a
# ball 2 mm onto it (sphere vs box)
BOX_CUBE = """
<robot name="cube"><link name="k"><inertial><mass value="0.5"/>
  <inertia ixx="0.0008" iyy="0.0008" izz="0.0008" ixy="0" ixz="0" iyz="0"/>
  </inertial>
  <collision><geometry><box size="0.12 0.12 0.12"/></geometry></collision>
</link></robot>"""
BOX_POSES = dict(boxbox=(BOX_CUBE, (0.02, 0.01, 5.122, 0.9990482, 0.0, 0.0, 0.0436194)),
                 capbox=(PAIR_CAP, (0.0, 0.0, 5.102, 0.7071068, 0, 0.7071068, 0)),
                 spherebox=(PAIR_BALL, (0.01, -0.02, 5.108, 1, 0, 0, 0)))
BOX_SP = dict(dt=1 / 60, substeps=1, contact_stiffness=2e4, contact_damping=500.0)


def box_pair_scene(kind, load, compose_fn):
    """One floating actor on a fixed cube, from either package's load_urdf
    and compose: (scene, the floating root's pose)."""
    urdf, pose = BOX_POSES[kind]
    return compose_fn([(load(urdf), pose, "A/"),
                       (load(BOX_CUBE, fix_base_link=True), (0.0, 0.0, 5.0, 1, 0, 0, 0), "B/")]), pose


def box_terrain_scene(load, compose_fn):
    """The box instance over a heightfield: a free cube resting on bumpy,
    sloped ground (its corners 0 to 3 mm into it) and pressed 2 mm into the
    side of a fixed cube (box vs box): (scene, the free cube's pose,
    Heightfield)."""
    i, j = np.meshgrid(np.arange(40), np.arange(40), indexing="ij")
    h = 0.003 * np.sin(2.1 * i) * np.cos(1.7 * j) + 0.0005 * i
    hf = Heightfield(h.astype(np.float32), 0.02, origin=(-0.4, -0.4))
    pose = (0.012, 0.0, 0.0585, 1.0, 0.0, 0.0, 0.0)
    return compose_fn([(load(BOX_CUBE), pose, "A/"),
                       (load(BOX_CUBE, fix_base_link=True), (0.13, 0.0, 0.06, 1, 0, 0, 0), "B/")]), pose, hf


class _Held:
    attractors = HELD_ATTRACTORS


# the two-link tendon scene of tests/test_fused.py (test_fused_tendon_matches_xla):
# a fixed base and two revolute links whose tendon holds q1 - q2 in [-0.05, 0.05]
TENDON_URDF = """
<robot name="twolink">
  <link name="base"><inertial><mass value="1.0"/>
    <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial></link>
  <link name="l1"><inertial><origin xyz="0 0 -0.1"/><mass value="0.2"/>
    <inertia ixx="0.001" iyy="0.001" izz="0.0005" ixy="0" ixz="0" iyz="0"/>
    </inertial></link>
  <link name="l2"><inertial><origin xyz="0 0 -0.1"/><mass value="0.1"/>
    <inertia ixx="0.0005" iyy="0.0005" izz="0.0002" ixy="0" ixz="0"
    iyz="0"/></inertial></link>
  <joint name="j1" type="revolute"><parent link="base"/><child link="l1"/>
    <origin xyz="0 0 -0.05"/><axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" effort="5" velocity="10"/></joint>
  <joint name="j2" type="revolute"><parent link="l1"/><child link="l2"/>
    <origin xyz="0 0 -0.2"/><axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" effort="5" velocity="10"/></joint>
</robot>"""
TENDON = ((1.0, -1.0), -0.05, 0.05, "t0")
TENDON_SP = dict(dt=1 / 60, substeps=2)


def tendon_scene(load):
    """The two-link tendon scene from either package's load_urdf: stiffness
    25, damping 0.2, as tests/test_fused.py sets them."""
    m = load(TENDON_URDF, fix_base_link=True)
    d = dict(m._defaults)
    d["tendon_stiffness"] = np.array([25.0], np.float32)
    d["tendon_damping"] = np.array([0.2], np.float32)
    m = dataclasses.replace(m, tendons=(TENDON,))
    object.__setattr__(m, "_defaults", d)
    return m


def tendon_q(rng, n):
    """(n, 2) states of the two-link scene whose coupled length q1 - q2 lies
    on either side of each bound or inside ([-0.1, 0.1])."""
    q1 = rng.uniform(-0.6, 0.6, n)
    return np.stack([q1, q1 - rng.uniform(-0.1, 0.1, n)], 1)


def tendon_length(model, jq):
    """(n, nt) tendon lengths C q of joint positions jq (n, nj), numpy."""
    return np.asarray(jq, np.float64) @ np.array([t[0] for t in model.tendons], np.float64).T


def pair_capsule_q(rng, n):
    """(n, 10 + 11) states of the pair-capsule scene: its poses with 1 cm of
    noise; in every fourth env capsule A hangs over the bar's end, so the
    closest point of the bar's axis is its end point and capsule A's is
    found again from it (the capsule-capsule narrowphase's second pass)."""
    q = np.tile(np.concatenate(PAIR_POSES[:3]), (n, 1))
    q += rng.normal(size=q.shape) * 0.01 * np.tile([1, 1, 1, 0, 0, 0, 0], 3)
    q[::4, 7:10] = [-0.45, 0.0, 0.68]
    return q


def pair_capsule_scene(load, compose_fn):
    """The scene from either package's load_urdf and compose."""
    return compose_fn([(load(PAIR_BALL), PAIR_POSES[0]), (load(PAIR_CAP), PAIR_POSES[1], "capA/"),
                       (load(PAIR_CAP), PAIR_POSES[2], "capB/"),
                       (load(PAIR_BAR, fix_base_link=True), PAIR_POSES[3])])


def ball_balance_q(task, rng, n):
    """(n, nq) BallBalance states with the pairs active: the tray near its
    rest pose, the ball pressed by up to 1 cm into the tray top (every third
    env from the first) or into a leg capsule (from the second), or its
    centre inside the tray disk (from the third: nearer the face or nearer
    the rim wall, alternately)."""
    m = task.model
    q = np.zeros((n, m.nq))
    q[:, 2] = bb.TRAY_H + rng.uniform(-0.02, 0.02, n)
    qr = rng.normal(size=(n, 4)) * 0.03 + [1.0, 0.0, 0.0, 0.0]
    q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
    q[:, 10] = 1.0
    q[:, 14:] = rng.uniform(-0.1, 0.1, (n, m.nj))
    frames = forward_kinematics(m, torch.as_tensor(q, dtype=torch.float32),
                                torch.zeros(n, m.nv))
    pos, quat = frames.pos.double().numpy(), frames.quat.double().numpy()
    press = rng.uniform(0.0, 0.01, n)
    group = np.arange(n) % 3
    # on the tray: a point of the top face, offset along the tray normal
    xy = rng.uniform(-0.25, 0.25, (n, 2))
    top = np.concatenate([xy, np.full((n, 1), 0.5 * bb.TRAY_THICK + bb.BALL_R)], 1)
    top[:, 2] -= press
    # inside the disk: the face nearer (|z| > 2 mm, r < 0.4) or the wall (r > 0.494)
    wall = (np.arange(n) // 3) % 2 == 1
    phi = rng.uniform(-np.pi, np.pi, n)
    r = np.where(wall, rng.uniform(0.494, 0.499, n), rng.uniform(0.0, 0.4, n))
    z = np.where(wall, rng.uniform(-0.003, 0.003, n),
                 rng.choice([-1.0, 1.0], n) * rng.uniform(0.002, 0.008, n))
    inside = np.stack([r * np.cos(phi), r * np.sin(phi), z], 1)
    tb = task.tray_body
    tray_pt = pos[:, tb] + _rot(quat[:, tb], np.where((group == 2)[:, None], inside, top))
    # on a leg: the capsule axis point at a random fraction, offset sideways
    legs = [g for g in m.geoms if m.actors[g.body] == 0 and g.gtype == 1]
    gi = rng.integers(0, len(legs), n)
    leg_pt = np.zeros((n, 3))
    for i in range(n):
        g = legs[gi[i]]
        c = pos[i, g.body] + _rot(quat[i, g.body][None], np.asarray(g.pos)[None])[0]
        axis = _rot(quat[i, g.body][None], np.array([[0, 0, 1.0]]))[0]
        side = np.cross(axis, rng.normal(size=3))
        side /= np.linalg.norm(side)
        t = rng.uniform(-0.8, 0.8) * g.size[1]
        leg_pt[i] = c + axis * t + side * (g.size[0] + bb.BALL_R - press[i])
    q[:, 7:10] = np.where((group == 1)[:, None], leg_pt, tray_pt)
    return q


ALLEGRO_PALM_TOP = 0.54      # the Allegro palm box's top face, world z (hand base at z 0.5)
ALLEGRO_PALM_EDGE = (-0.075, 0.54)   # its front top edge (along x): y, z


def allegro_contact_q(model, rng, n, top=ALLEGRO_PALM_TOP, edge_yz=ALLEGRO_PALM_EDGE, mid_y=-0.04):
    """(n, nq) AllegroHand states with the cube in contact with the palm and
    fingers, the fingers at 30 to 70 % of their joint ranges. The cube turned
    at random; in three envs of four it lies on the palm top (world z `top`,
    around y `mid_y`), its lowest corner 0 to 6 mm in; in every fourth it
    presses 0 to 4 mm into the palm's front top edge (`edge_yz`) from the
    front and above, where an edge of the cube often crosses that edge (the
    box-box edge-edge candidate)."""
    q = np.zeros((n, model.nq), np.float32)
    qr = rng.normal(size=(n, 4))
    qr /= np.linalg.norm(qr, axis=1, keepdims=True)
    w, x, y, z = qr.T
    R = np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                  np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                  np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)],
                 -2)
    # the direction from the contact to the cube's centre, and the cube's
    # half extent along it: 0.0325 sum_j |R[:, j] . u|
    edge = np.arange(n) % 4 == 3
    phi = rng.uniform(np.radians(15), np.radians(75), n)
    u = np.where(edge[:, None], np.stack([np.zeros(n), -np.cos(phi), np.sin(phi)], 1), [0.0, 0.0, 1.0])
    h = 0.0325 * np.abs(np.einsum("nij,ni->nj", R, u)).sum(-1)
    p0 = np.where(edge[:, None], np.stack([rng.uniform(-0.03, 0.03, n), np.full(n, edge_yz[0]),
                                           np.full(n, edge_yz[1])], 1),
                  np.stack([rng.uniform(-0.02, 0.02, n), mid_y + rng.uniform(-0.03, 0.03, n),
                            np.full(n, top)], 1))
    pen = np.where(edge, rng.uniform(0.0, 0.004, n), rng.uniform(0.0, 0.006, n))
    q[:, 0:3] = p0 + u * (h - pen)[:, None]
    q[:, 3:7] = qr
    lo, hi = model._defaults["dof_lower"], model._defaults["dof_upper"]
    q[:, 7:] = lo + (hi - lo) * rng.uniform(0.3, 0.7, (n, model.nj))
    return q


SHADOW_PALM_TOP = 0.565     # the Shadow palm box's top face, world z (hand base at z 0.5)
SHADOW_PALM_EDGE = (-0.415, 0.565)   # its front top edge (along x), under the knuckles: y, z


def shadow_contact_q(model, rng, n):
    """(n, nq) ShadowHand states with the cube in contact with the palm and
    fingers: the wrist straight, the other DOFs at 30 to 70 % of their
    ranges, and each distal J0 within 0.1 of its J1 (the tendon's coupled
    length on either side of its bounds, or inside); the cube placed as
    ``allegro_contact_q`` places it, on the palm top or pressed into its
    front top edge."""
    q = allegro_contact_q(model, rng, n, SHADOW_PALM_TOP, SHADOW_PALM_EDGE, mid_y=-0.38)
    for name in ("robot0:WRJ1", "robot0:WRJ0"):
        q[:, 7 + model.dof_id(name)] = 0.0
    lo, hi = model._defaults["dof_lower"], model._defaults["dof_upper"]
    for coef, *_ in model.tendons:
        j1, j0 = (int(j) for j in np.flatnonzero(np.asarray(coef)))
        q[:, 7 + j0] = np.clip(q[:, 7 + j1] + rng.uniform(-0.1, 0.1, n), lo[j0], hi[j0])
    return q


# Franka arm poses (panda_joint1..7) that put the grasp frame where the
# Franka contact states below want it, found by damped least-squares IK
# (ops/control.py ik_delta "dls") on the port's grasp-site jacobian: around
# FrankaCabinet's handle bar (drawer out 0.1 m; the gripper's z along -x,
# its finger axis y along +z), 1 cm below the centre of a cube on
# FrankaCubeStack's table at (0.01, 0), at the centre of a nut on the Factory
# table at (0, -0.1), and at the centre of the Screw task's nut at the top of
# its thread (the gripper pointing down, its finger axis along +y)
FRANKA_ARM_CABINET = (1.64932, -1.38751, -1.00429, -2.20307, -2.3632, 2.24823, 0.36504)
FRANKA_ARM_CUBE = (-0.3273, 0.78883, 0.16779, -2.27134, -0.93335, 2.9936, -1.6366)
FRANKA_ARM_PICK = (0.35486, -0.16122, -0.14754, -2.04679, -0.02483, 1.8872, 1.00233)
FRANKA_ARM_SCREW = (0.34014, -0.52568, -0.26647, -2.23063, -0.134, 1.71909, 0.91359)
CUBE_AT = (0.01, 0.0)


def _franka_jq(task, rng, n, arm, fingers):
    """(n, nj) joint positions: `arm` with 1e-3 rad of noise, each finger
    uniform in `fingers` (m), every other joint 0. A finger pad's inner face
    lies 12 mm inside its finger's opening."""
    jq = np.zeros((n, task.model.nj), np.float32)
    jq[:, task.fr_ids[:7]] = np.asarray(arm) + rng.normal(size=(n, 7)) * 1e-3
    jq[:, task.fr_ids[7:]] = rng.uniform(*fingers, (n, 2))
    return jq


def _yaw(rng, n, sigma):
    a = rng.normal(size=n) * sigma
    return np.stack([np.cos(a / 2), np.zeros(n), np.zeros(n), np.sin(a / 2)], 1)


def franka_cabinet_contact_q(task, rng, n):
    """(n, nq) FrankaCabinet states with the finger pads around the top
    drawer's handle bar (radius 1 cm): the drawer out 0.09 to 0.13 m, so the
    bar lies between the pads and, from 0.125 m, the pad tips press up to 5
    mm into the drawer's front face (box-box); the fingers open 17 to 26 mm,
    their pads on the bar (capsule-box) below 22 mm."""
    q = _franka_jq(task, rng, n, FRANKA_ARM_CABINET, (0.017, 0.026))
    q[:, task.drawer_dof] = rng.uniform(0.09, 0.13, n)
    return q


def franka_cube_contact_q(task, rng, n):
    """(n, nq) FrankaCubeStack states: cube A on the table at CUBE_AT, 0 to 2
    mm into it, turned up to a few degrees; cube B on A, 0 to 2 mm into it,
    shifted up to 5 mm and turned; the finger pads on A's sides (A's half
    width 25 mm: in contact below a 37 mm opening)."""
    za = 1.025 + 0.025 - rng.uniform(0.0, 0.002, n)
    qa = np.concatenate([np.stack([CUBE_AT[0] + rng.normal(size=n) * 1e-3,
                                   CUBE_AT[1] + rng.normal(size=n) * 1e-3, za], 1),
                         _yaw(rng, n, 0.03)], 1)
    qb = np.concatenate([qa[:, 0:2] + rng.uniform(-0.005, 0.005, (n, 2)),
                         (za + 0.06 - rng.uniform(0.0, 0.002, n))[:, None], _yaw(rng, n, 0.1)], 1)
    jq = _franka_jq(task, rng, n, FRANKA_ARM_CUBE, (0.03, 0.04))
    return np.concatenate([qa, qb, jq], 1).astype(np.float32)


def factory_pick_contact_q(task, rng, n):
    """(n, nq) FactoryTaskNutBoltPick states: the nut on the table at (0,
    -0.1), 0 to 1 mm into it, turned up to a few degrees; the finger pads
    on its sides (its half width 12 mm: in contact below a 24 mm opening),
    their lower ends ~1.5 mm above the table."""
    qn = np.concatenate([np.stack([rng.normal(size=n) * 1e-3, -0.1 + rng.normal(size=n) * 1e-3,
                                   0.4065 - rng.uniform(0.0, 0.001, n)], 1), _yaw(rng, n, 0.03)], 1)
    jq = _franka_jq(task, rng, n, FRANKA_ARM_PICK, (0.018, 0.028))
    return np.concatenate([qn, jq], 1).astype(np.float32)


def factory_screw_contact_q(task, rng, n):
    """(n, nq) FactoryTaskNutBoltScrew states: the nut on its thread, spun 0
    to 0.1 rad, the finger pads on its sides as in ``factory_pick_contact_q``;
    the thread tendon's length L = travel + pitch / (2 pi) spin exactly at
    its bound 0 in every third env (travel = -fl(pitch / (2 pi) spin)) and
    1e-6 to 2e-4 to either side of it in the others."""
    jq = _franka_jq(task, rng, n, FRANKA_ARM_SCREW, (0.018, 0.028))
    spin = rng.uniform(0.0, 0.1, n).astype(np.float32)
    coef = np.float32(np.asarray(task.model.tendons[0][0], np.float32)[task.spin_dof])
    side = np.where(np.arange(n) % 3 == 0, 0.0,
                    rng.choice([-1.0, 1.0], n) * rng.uniform(1e-6, 2e-4, n)).astype(np.float32)
    jq[:, task.spin_dof] = spin
    jq[:, task.travel_dof] = -(coef * spin) + side
    return jq


# Trifinger joint positions (finger 0, 120, 240; three joints each) that put
# each fingertip sphere 1 mm into the top face of the cube at the origin,
# unturned on the ground, 15 mm from the face's centre toward its finger
# (the link capsules clear the cube by 16 mm or more). Found by Gauss-Newton
# on the port's fingertip-site kinematics.
TRIFINGER_GRIP = (-0.0650104, 0.965643, -1.64951, -0.0650327, 0.96561, -1.64952,
                  -0.0649881, 0.96561, -1.64952)


def trifinger_contact_q(task, rng, n):
    """(n, nq) Trifinger states with the three fingertips pressing on the
    cube: the cube at the origin, up to 1 mm off in x and y, 0 to 1 mm into
    the ground, turned by yaw N(0, 0.01); the joints at TRIFINGER_GRIP + N(0,
    2e-3) rad (a fingertip 1 mm into the top face, give or take ~0.6 mm)."""
    pos = np.stack([rng.uniform(-1e-3, 1e-3, n), rng.uniform(-1e-3, 1e-3, n),
                    0.0325 - rng.uniform(0.0, 1e-3, n)], 1)
    jq = np.zeros((n, task.model.nj))
    jq[:, task.dof_ids] = np.asarray(TRIFINGER_GRIP) + rng.normal(size=(n, 9)) * 2e-3
    return np.concatenate([pos, _yaw(rng, n, 0.01), jq], 1).astype(np.float32)


# MA_OP3: the agents' arm joints (sho_pitch, sho_roll, el; left, then right)
# that put each gripper sphere 1 mm into an edge of the table top's underside
# (the edge along x at y = +/-0.18, z = 0.28, beside the agent) with the
# heels 1 mm into the ground (MA_OP3_ROOT_DZ); the same in both agents (a1
# stands 0.01 m closer to the table). Found by a grid search and Newton steps
# on the port's kinematics. The reset pose's lowest foot corners (the heels:
# the crouch pitches the feet) lie MA_OP3_HEEL_Z under the ground.
MA_OP3_GRIP = ((-1.199993, 0.50002, 0.200005), (1.199993, 0.50002, -0.200005))
MA_OP3_HEEL_Z = -0.0098081
MA_OP3_ROOT_DZ = -MA_OP3_HEEL_Z - 0.001
# the gap from a0's left foot (y up to 0.077) to the table leg at y 0.115
# (and from a1's right foot to the leg across from it)
MA_OP3_LEG_GAP = 0.038


def ma_op3_contact_q(task, rng, n):
    """(n, nq) MA_OP3 states: both agents at the reset pose raised by
    MA_OP3_ROOT_DZ (+/-0.5 mm; the heels 0.5-1.5 mm into the ground) and
    moved up to 1 mm in x and y, their arms at MA_OP3_GRIP + N(0, 2e-3) rad
    (the grippers 1 mm into the underside edges of the table top, give or
    take ~0.5 mm); the table 0.5-1.5 mm into the ground and, in every third
    env, moved by -(MA_OP3_LEG_GAP + 0.5-1.5 mm) in y, so that a0's left
    foot and a1's right foot press into a table leg (and a gripper into the
    top's underside instead of its edge)."""
    q = np.tile(task._q0.cpu().numpy().astype(np.float64), (n, 1))
    for o in (0, 7):
        q[:, o:o + 2] += rng.uniform(-1e-3, 1e-3, (n, 2))
        q[:, o + 2] += MA_OP3_ROOT_DZ + rng.uniform(-5e-4, 5e-4, n)
    q[:, 16] -= rng.uniform(5e-4, 1.5e-3, n)
    leg = np.arange(n) % 3 == 1
    q[leg, 15] -= MA_OP3_LEG_GAP + rng.uniform(5e-4, 1.5e-3, int(leg.sum()))
    m = task.model
    for a in range(2):
        for s, grip in zip(("l", "r"), MA_OP3_GRIP):
            for j, v in zip(("sho_pitch", "sho_roll", "el"), grip):
                q[:, m.root_nq + m.dof_id(f"a{a}/{s}_{j}")] = v + rng.normal(size=n) * 2e-3
    return q.astype(np.float32)


def drone_contact_q(model, rng, n, z):
    """(n, nq) states of a copter (Ingenuity, Quadcopter) near the ground:
    xy in [-1, 1], its base height uniform in `z` (lo, hi), tilted by a
    quaternion 0.15 x N(0, 1) off upright, joints (if any) uniform in
    [-0.3, 0.3]: in some envs box corners and rotor rims touch the ground."""
    q = np.zeros((n, model.nq), np.float32)
    q[:, 0:2] = rng.uniform(-1.0, 1.0, (n, 2))
    q[:, 2] = rng.uniform(*z, n)
    qr = rng.normal(size=(n, 4)) * 0.15 + [1.0, 0.0, 0.0, 0.0]
    q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(-0.3, 0.3, (n, model.nj))
    return q


def amp_contact_state(task, rng, n):
    """((n, nq), (n, nv)) HumanoidAMP states on the ground: the gait clip's
    reference states (``task.motion_lib``) at seeded times, with the clip's
    velocities, lowered until their lowest candidate point is 0.5-3 mm in
    the ground. In envs e % 4 in (0, 1) the left leg takes the right leg's
    angles first, so both box soles touch; in e % 4 == 2 the clip's pose
    (one sole, or two in double support); in e % 4 == 3 the body lies
    straight (every joint at 0) on its back, where the torso's capsule and
    the pelvis touch, or on its front, where the toes do (the root turned a
    quarter about y)."""
    m, ml, dev = task.model, task.motion_lib, task.device
    t = torch.as_tensor(rng.uniform(0.0, float(ml.lengths[0]), n).astype(np.float32), device=dev)
    q, qd = (x.cpu().numpy().astype(np.float64)
             for x in task._motion_state_to_qqd(ml.get_motion_state(
                 torch.zeros(n, dtype=torch.int64, device=dev), t)))
    e = np.arange(n) % 4
    for j in ("thigh_y", "shin_y", "foot_y"):
        q[e < 2, 7 + m.dof_id(f"left_{j}")] = q[e < 2, 7 + m.dof_id(f"right_{j}")]
    lying = e == 3
    q[lying, 7:] = 0.0
    half = 0.25 * np.pi * np.where(rng.uniform(size=int(lying.sum())) < 0.5, 1.0, -1.0)
    q[lying, 3:7] = np.stack([np.cos(half), 0 * half, np.sin(half), 0 * half], -1)
    frames = forward_kinematics(m, torch.as_tensor(q, dtype=torch.float32),
                                torch.zeros(n, m.nv))
    p, _ = fused.contact.candidate_points(m, frames)
    cand = fused.contact.candidates(m)
    low = (p[..., 2] - torch.as_tensor(cand["r"])).numpy()
    q[:, 2] -= low.min(-1) + rng.uniform(5e-4, 3e-3, n)
    return q.astype(np.float32), qd.astype(np.float32)


def amp_contact_stats(model, q) -> dict:
    """What touches the ground at HumanoidAMP's q: the share of envs with
    both box soles in contact, with a capsule in contact, and of ground
    candidates in contact."""
    frames = forward_kinematics(model, q, torch.zeros(q.shape[0], model.nv, device=q.device))
    p, _ = fused.contact.candidate_points(model, frames)
    cand = fused.contact.candidates(model)
    active = (p[..., 2] < torch.as_tensor(cand["r"], device=q.device)).cpu()
    gtype = np.array([model.geoms[g].gtype for g in cand["geom"]])
    body = np.array([model.body_names[b] for b in cand["body"]])
    soles = [active[:, torch.as_tensor(body == f)].any(-1) for f in ("right_foot", "left_foot")]
    return dict(both_soles_env_share=float((soles[0] & soles[1]).float().mean()),
                capsule_env_share=float(active[:, torch.as_tensor(gtype == GEOM_CAPSULE)]
                                        .any(-1).float().mean()),
                ground_candidate_contact_share=float(active.float().mean()))


# the base heights of drone_contact_q: Ingenuity's box of half size 0.06 m
# under its 0.15 m rotor disks, Quadcopter's 0.015 m thick chassis disk
DRONE_Z = {"Ingenuity": (0.04, 0.1), "Quadcopter": (0.0, 0.04)}


def franka_arm_q(model, rng, n):
    """(n, nq) states of the Franka arm alone, as tests/test_fused.py's
    fixed-base check draws them: 0.3 x a standard normal per DOF."""
    return (0.3 * rng.normal(size=(n, model.nq))).astype(np.float32)


def _rot(qw, v):
    """Rotate v (n, 3) by the wxyz quaternions qw (n, 4), numpy."""
    w, u = qw[:, :1], qw[:, 1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


_HOST_PRELUDE = """#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __syncthreads()
struct HostDim { int x, y; };
static thread_local HostDim blockIdx, threadIdx, blockDim;
// one env per call: a warp vote sees the calling thread's env alone (in the
// wide layout its G lanes, which hold the same state and vote alike)
inline bool __any_sync(unsigned, bool p) { return p; }
// the wide layout's G lanes of one env run as G host threads, which exchange
// through an array between two barriers: __ballot_sync sets each lane's bit
// at its place in the warp (lane threadIdx.y G + threadIdx.x, modulo 32),
// __shfl_sync reads the value of the group's lane src modulo G
static std::barrier<>* host_group = nullptr;
static unsigned host_votes[32];
static float host_values[32];
inline unsigned __ballot_sync(unsigned, bool p) {
  host_votes[threadIdx.x] = p ? 1u << ((threadIdx.y * blockDim.x + threadIdx.x) & 31) : 0u;
  host_group->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < blockDim.x; ++i) r |= host_votes[i];
  host_group->arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  host_values[threadIdx.x] = v;
  host_group->arrive_and_wait();
  const float r = host_values[src & (blockDim.x - 1)];
  host_group->arrive_and_wait();
  return r;
}
"""
# One CUDA thread per call, blockDim.x = the launch's block size; in the
# wide layout one env per call, its G lanes as G threads (blockDim (G,
# envs a block)). The shared and split instances' buffer is a static
# array: before each env every word is set to a NaN canary, and after it
# every word outside the env's slice (its lane's) must still hold it, so a
# lane that strays out of its slice is counted (the return value), and one
# that reads a word it never wrote turns its outputs to NaN.
_HOST_LOOP = """
float sweep_smem[232448 / 4];
static const uint32_t kCanary = 0x7fc0dead;

extern "C" int host_launch(const int* mi, const float* mf, const float* hf, const float* in,
                           float* out, int B, int pairs, int threads, int layout, int smem,
                           int lanes) {
  // the model tables first (header ints 44-45: their lengths; the shared and
  // split layouts without pairs only), then the envs' slices
  const int tables = layout != kLocal && !pairs ? mi[44] + mi[45] : 0, words = smem / 4;
  const int envs = threads / lanes, slice = (words - tables) / envs;
  int strays = 0;
  for (int b = 0; b < B; ++b) {
    for (int w = 0; w < words; ++w) std::memcpy(&sweep_smem[w], &kCanary, 4);
    if (layout == kWide) {
      std::barrier<> group(lanes);
      host_group = &group;
      std::vector<std::thread> lane;
      for (int j = 0; j < lanes; ++j)
        lane.emplace_back([=] {
          blockDim = {lanes, envs};
          blockIdx.x = b / envs;
          threadIdx = {j, b % envs};
          if (hf)
            fused_step_kernel<true, true, true, kWide>(mi, mf, hf, in, out, B);
          else
            fused_step_kernel<false, true, true, kWide>(mi, mf, hf, in, out, B);
        });
      for (auto& t : lane) t.join();
      host_group = nullptr;
    } else {
      blockDim.x = threads;
      blockIdx.x = b / threads;
      threadIdx.x = b % threads;
      if (hf && pairs == 2)
        fused_step_kernel<true, true, true, kLocal>(mi, mf, hf, in, out, B);
      else if (hf && pairs == 1 && layout == kShared)
        fused_step_kernel<true, true, false, kShared>(mi, mf, hf, in, out, B);
      else if (hf && pairs == 1)
        fused_step_kernel<true, true, false, kLocal>(mi, mf, hf, in, out, B);
      else if (hf && layout == kShared)
        fused_step_kernel<true, false, false, kShared>(mi, mf, hf, in, out, B);
      else if (hf)
        fused_step_kernel<true, false, false, kLocal>(mi, mf, hf, in, out, B);
      else if (pairs == 2)
        fused_step_kernel<false, true, true, kLocal>(mi, mf, hf, in, out, B);
      else if (pairs == 1 && layout == kShared)
        fused_step_kernel<false, true, false, kShared>(mi, mf, hf, in, out, B);
      else if (pairs == 1)
        fused_step_kernel<false, true, false, kLocal>(mi, mf, hf, in, out, B);
      else if (layout == kShared)
        fused_step_kernel<false, false, false, kShared>(mi, mf, hf, in, out, B);
      else if (layout == kSplit)
        fused_step_kernel<false, false, false, kSplit>(mi, mf, hf, in, out, B);
      else if (layout == kSplitLean)
        fused_step_kernel<false, false, false, kSplitLean>(mi, mf, hf, in, out, B);
      else
        fused_step_kernel<false, false, false, kLocal>(mi, mf, hf, in, out, B);
    }
    for (int w = 0; w < words; ++w) {
      uint32_t x;
      std::memcpy(&x, &sweep_smem[w], 4);
      const int e = b % envs;
      const bool own = w < tables || (w >= tables + e * slice && w < tables + (e + 1) * slice);
      strays += !own && x != kCanary;
    }
  }
  return strays;
}

extern "C" int host_lane_words(int nb, int nj, int nq, int nv, int nc, int hf, int rows,
                               int npb) {
  return lane_words(nb, nj, nq, nv, nc, hf != 0, rows, npb);
}

extern "C" int host_split_lane_words(int nb, int nj, int nq, int nv, int nc) {
  return split_lane_words(nb, nj, nq, nv, nc);
}

extern "C" int host_lean_lane_words(int nb, int nj, int nq, int nv, int nc) {
  return lean_lane_words(nb, nj, nq, nv, nc);
}

extern "C" int host_wide_lane_words() { return wide_lane_words(); }
"""


def build_host_kernel() -> ctypes.CDLL:
    """The kernel source built as host C++ (with g++) and loaded. The
    library goes to the temp directory under a name keyed by the hash of
    the source and the compiler's command, so the test files and pytest's
    worker processes that need it share one build; a lock file holds the
    others while the first builds."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    src = open(fused.SOURCE).read().replace("#include <cuda_runtime.h>", "")
    src = _HOST_PRELUDE + src[:src.index("// Plain C entry point")] + _HOST_LOOP
    cmd = [cxx, "-O1", "-ffp-contract=off", "-std=c++20", "-pthread", "-shared", "-fPIC"]
    tag = hashlib.sha256((src + " ".join(cmd)).encode()).hexdigest()[:16]
    d = os.path.join(tempfile.gettempdir(), "thormang_host_kernel")
    os.makedirs(d, exist_ok=True)
    so = os.path.join(d, f"libfused_step_host_{tag}.so")
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            cpp = so[:-3] + ".cpp"
            with open(cpp, "w") as f:
                f.write(src)
            subprocess.run([*cmd, "-o", so + ".tmp", cpp], check=True)
            os.replace(so + ".tmp", so)
    lib = ctypes.CDLL(so)
    lib.host_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    lib.host_launch.restype = ctypes.c_int
    lib.host_lane_words.argtypes = [ctypes.c_int] * 8
    lib.host_lane_words.restype = ctypes.c_int
    for fn in (lib.host_split_lane_words, lib.host_lean_lane_words):
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
    lib.host_wide_lane_words.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="session")
def host_kernel():
    return build_host_kernel()


def _model(name):
    """(model, sim params, task or None, ground)."""
    if name == "pair_capsule":
        return pair_capsule_scene(load_urdf, compose), SimParams(**PAIR_SP), None, 0.0
    if name == "held":
        return load_urdf(HELD_URDF), SimParams(**PAIR_SP), _Held(), 0.0
    if name in BOX_POSES:
        return box_pair_scene(name, load_urdf, compose)[0], SimParams(**BOX_SP), None, 0.0
    if name == "boxbox_terrain":
        scene, _, hf = box_terrain_scene(load_urdf, compose)
        return scene, SimParams(**BOX_SP), None, hf
    if name == "allegro_hand":
        # the sim block of cfg/task/AllegroHand.yaml: dt 0.01667 s, 2 substeps
        task = AllegroHand(num_envs=B, device="cpu")
        return task.model, dataclasses.replace(task.sim_params, dt=0.01667), task, 0.0
    if name == "shadow_hand":
        # the sim block of cfg/task/ShadowHand.yaml: dt 0.01667 s, 2 substeps
        task = ShadowHand(num_envs=B, device="cpu")
        return task.model, dataclasses.replace(task.sim_params, dt=0.01667), task, 0.0
    if name == "tendon":
        return tendon_scene(load_urdf), SimParams(**TENDON_SP), None, 0.0
    if name == "humanoid_mjcf":
        # the sim block of cfg/task/Humanoid.yaml: dt 0.0166 s, 2 substeps
        task = HumanoidMJCF(num_envs=B, device="cpu")
        return task.model, dataclasses.replace(task.sim_params, substeps=2), task, 0.0
    if name == "humanoid_amp":
        # the sim block of cfg/task/HumanoidAMP.yaml equals the class's: dt
        # 0.0166 s, 2 substeps
        task = HumanoidAMP(num_envs=B, device="cpu")
        return task.model, task.sim_params, task, 0.0
    if name == "ball_balance":
        # the sim block of cfg/task/BallBalance.yaml: dt 0.01 s, 1 substep
        task = bb.BallBalance(num_envs=B, device="cpu")
        return task.model, dataclasses.replace(task.sim_params, dt=0.01, substeps=1), task, 0.0
    if name == "tiny":
        return load_urdf(TINY_URDF), SimParams(**TINY_SP), None, 0.0
    if name == "franka":
        # tests/test_fused.py's fixed-base check: the arm alone, 2 substeps
        return load_franka(), SimParams(dt=1 / 60, substeps=2), None, 0.0
    if name == "franka_cabinet":
        # the sim block of cfg/task/FrankaCabinet.yaml: dt 0.0166 s, 1 substep
        task = FrankaCabinet(num_envs=B, device="cpu")
        return task.model, dataclasses.replace(task.sim_params, dt=0.0166, substeps=1), task, 0.0
    if name == "factory_screw":
        # the sim block of cfg/task/FactoryTaskNutBoltScrew.yaml: dt 0.016667 s,
        # 4 substeps, run one at a time (held substep by substep, as chip_smoke
        # holds the box mode); the table at TABLE_Z
        task = FactoryTaskNutBoltScrew(num_envs=B, device="cpu")
        return task.model, dataclasses.replace(task.sim_params, dt=0.016667 / 4, substeps=1), \
            task, task.ground_height_fn()
    if name == "trifinger":
        # the sim block of cfg/task/Trifinger.yaml: dt 0.02 s, 4 substeps, run
        # one at a time (held substep by substep, as chip_smoke holds the box mode)
        task = Trifinger(num_envs=B, device="cpu")
        return task.model, dataclasses.replace(task.sim_params, dt=0.005, substeps=1), task, 0.0
    if name == "ma_op3":
        # the sim block of cfg/task/MA_OP3.yaml: dt 0.0166 s, 4 substeps, run one
        # at a time (held substep by substep, as chip_smoke holds the box mode)
        task = MA_OP3(num_envs=B, device="cpu")
        return task.model, dataclasses.replace(task.sim_params, dt=0.0166 / 4, substeps=1), task, 0.0
    if name in ("ingenuity", "quadcopter"):
        # the YAMLs' sim blocks equal the classes': dt 0.01 s, 2 substeps
        task = {"ingenuity": Ingenuity, "quadcopter": Quadcopter}[name](num_envs=B, device="cpu")
        return task.model, task.sim_params, task, 0.0
    if name == "cylinder_slope":
        return load_urdf(CYL_URDF), SimParams(**TINY_SP), None, slope_field((-2.0, -2.0))
    if name == "pair_capsule_terrain":
        return pair_capsule_scene(load_urdf, compose), SimParams(**PAIR_SP), None, \
            slope_field(PAIR_TERRAIN_ORIGIN)
    if name == "anymal_terrain":
        task = Anymal(num_envs=B, device="cpu")
        sp = dataclasses.replace(task.sim_params, dt=0.02, substeps=4)
        return task.model, sp, task, TerrainGrid(num_levels=2, num_types=5, seed=0)
    task = {"cartpole": Cartpole, "ant": Ant}[name](num_envs=B, device="cpu")
    return task.model, task.sim_params, task, 0.0


def slope_field(origin):
    """The cylinder-slope case's heightfield at `origin`: a slope with bumps,
    so the plane depends on where it is sampled."""
    i, j = np.meshgrid(np.arange(40), np.arange(40), indexing="ij")
    h = 0.03 * i + 0.02 * j + 0.05 * np.sin(0.9 * i) * np.cos(0.7 * j)
    return Heightfield(h.astype(np.float32), 0.1, origin=origin)


def _ground(ground, device):
    """The kernel's ground on `device`: a height or a Heightfield."""
    if isinstance(ground, TerrainGrid):
        ground = ground.field
    return ground.to(device) if isinstance(ground, Heightfield) else ground


def _inputs(name, model, task, device, ground=None):
    rng = np.random.default_rng(3)
    nj = model.nj
    if name == "ball_balance":
        q = ball_balance_q(task, rng, B)
        qd = rng.normal(size=(B, model.nv)) * 0.3
    elif name in ("pair_capsule", "pair_capsule_terrain"):
        q = pair_capsule_q(rng, B)
        qd = rng.normal(size=(B, model.nv)) * 0.1
    elif name == "allegro_hand":
        q = allegro_contact_q(model, rng, B)
        qd = rng.normal(size=(B, model.nv)) * 0.1
    elif name == "shadow_hand":
        q = shadow_contact_q(model, rng, B)
        qd = rng.normal(size=(B, model.nv)) * 0.1
    elif name == "tendon":
        q = tendon_q(rng, B)
        qd = rng.normal(size=(B, model.nv))
    elif name == "franka":
        q = franka_arm_q(model, rng, B)
        qd = np.zeros((B, model.nv))
    elif name == "franka_cabinet":
        q = franka_cabinet_contact_q(task, rng, B)
        qd = rng.normal(size=(B, model.nv)) * 0.05
    elif name == "factory_screw":
        q = factory_screw_contact_q(task, rng, B)
        qd = rng.normal(size=(B, model.nv)) * 0.05
    elif name == "trifinger":
        q = trifinger_contact_q(task, rng, B)
        qd = rng.normal(size=(B, model.nv)) * 0.05
    elif name == "ma_op3":
        q = ma_op3_contact_q(task, rng, B)
        qd = rng.normal(size=(B, model.nv)) * 0.05
    elif name == "humanoid_amp":
        q, qd = amp_contact_state(task, rng, B)
    elif name in ("ingenuity", "quadcopter"):
        q = drone_contact_q(model, rng, B, DRONE_Z[type(task).__name__])
        qd = rng.normal(size=(B, model.nv)) * 0.5
    elif name in BOX_POSES or name == "boxbox_terrain":
        # the scene's pose with 1 mm of noise in position and 0.02 in the quaternion
        pose = box_terrain_scene(load_urdf, compose)[1] if name == "boxbox_terrain" else BOX_POSES[name][1]
        q = np.tile(pose, (B, 1)) + np.concatenate(
            [rng.normal(size=(B, 3)) * 0.001, rng.normal(size=(B, 4)) * 0.02], 1)
        q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
        qd = rng.normal(size=(B, model.nv)) * 0.05
        if name == "spherebox":
            # the ball's centre inside the cube, at the same gap (exactly) from
            # its +x and +y faces: the first face of least gap (x) wins
            q[0] = [0.03, 0.03, 5.0, 1.0, 0.0, 0.0, 0.0]
    elif name == "held":
        q = np.zeros((B, 7))
        q[:, 0:3] = [0.2, -0.1, 0.5] + rng.normal(size=(B, 3)) * 0.1
        qr = rng.normal(size=(B, 4)) * 0.3 + [1.0, 0.0, 0.0, 0.0]
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        qd = rng.normal(size=(B, model.nv))
    elif name == "anymal_terrain":
        # bases over tile centres of every level and type, feet near the ground
        lev = rng.integers(0, ground.num_levels, B)
        typ = rng.integers(0, ground.num_types, B)
        o = ground.env_origins[lev, typ]
        q = np.zeros((B, model.nq))
        q[:, 0:2] = o[:, 0:2] + rng.uniform(-0.5, 0.5, (B, 2))
        q[:, 2] = o[:, 2] + 0.53 + rng.uniform(-0.05, 0.05, B)
        qr = rng.normal(size=(B, 4)) * 0.05 + [1.0, 0.0, 0.0, 0.0]
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        q[:, 7:] = task.default_dof_pos.numpy() + rng.uniform(-0.3, 0.3, (B, nj))
        qd = rng.normal(size=(B, model.nv)) * 0.5
    elif name == "cylinder_slope":
        q = np.zeros((B, model.nq))
        q[:, 0:2] = rng.uniform(-0.5, 0.5, (B, 2))
        q[:, 2] = 0.3 * (q[:, 0] + 2.0) + 0.2 * (q[:, 1] + 2.0) + rng.uniform(0.0, 0.12, B)
        qr = rng.normal(size=(B, 4))
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        qd = rng.normal(size=(B, model.nv)) * 0.5
    elif model.n_floating:
        q = np.zeros((B, model.nq))
        qr = rng.normal(size=(B, 4)) * 0.2 + [1.0, 0.0, 0.0, 0.0]
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        q[:, 2] = task.spawn_z + rng.uniform(-0.05, 0.05, B) if task else 0.12
        base = task._init_jq if task else np.zeros(nj)
        q[:, 7:] = base + rng.uniform(-0.2, 0.2, (B, nj))
        qd = rng.normal(size=(B, model.nv)) * 0.5
    else:
        q = rng.uniform(-1.0, 1.0, (B, model.nq))
        qd = rng.uniform(-1.0, 1.0, (B, model.nv))
    wrench = np.concatenate([rng.normal(size=(B, model.nb, 3)) * 0.1,
                             rng.normal(size=(B, model.nb, 3))], axis=-1)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    ctrl = Controls(t(rng.normal(size=(B, nj)) * 0.1), t(np.zeros((B, nj))),
                    t(rng.uniform(-15, 15, (B, nj))))
    if name == "humanoid_amp":
        # as in training: PD targets near the joints, no wrench
        ctrl = Controls(t(q[:, 7:] + rng.normal(size=(B, nj)) * 0.05), t(np.zeros((B, nj))),
                        t(np.zeros((B, nj))))
        wrench = np.zeros_like(wrench)
    if name == "ma_op3":
        # as in training: position targets near the joints (kp 1000: a target
        # 4.1 mrad off saturates the 4.1 N m limit, so many sit at the
        # clamp), no wrench
        ctrl = Controls(t(q[:, model.root_nq:] + rng.normal(size=(B, nj)) * 0.01),
                        t(np.zeros((B, nj))), t(np.zeros((B, nj))))
        wrench = np.zeros_like(wrench)
    return model.default_params(device).batch(B), t(q), t(qd), ctrl, t(wrench)


# the box instance's geometry on the host unless a test forces another: the
# local layout in blocks of 128, as at 16384 envs
HOST_BOX_GEOMETRY = ("local", 1, 128)


def _host_call(lib, step, params, q, qd, ctrl, wrench):
    packed = step.pack(params, q, qd, ctrl, wrench)
    mi, mf = (torch.as_tensor(x) for x in step._tables)
    hf = step.hf.table.data_ptr() if step.hf is not None else None
    out = torch.full((step.out_rows, q.shape[0]), float("nan"))
    layout, lanes, block, smem = (*HOST_BOX_GEOMETRY, 0) \
        if step.pair_mode == 2 and step.force_geometry is None else step.launch_geometry(q.shape[0])
    strays = lib.host_launch(mi.data_ptr(), mf.data_ptr(), hf, packed.data_ptr(), out.data_ptr(),
                             q.shape[0], int(step.pair_mode), block, fused.LAYOUTS.index(layout),
                             smem, lanes)
    assert strays == 0, f"{strays} shared words written outside their env's slice"
    return step.unpack(out, q.shape[0])


def _assert_close(a, b):
    for x, y, (atol, rtol) in zip(a, b, ((2e-3, 2e-3), (2e-2, 2e-2), (1.0, 5e-3))):
        assert bool(torch.isfinite(x).all())
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), atol=atol, rtol=rtol)


# held step by step: AllegroHand's contacts are stiff against light links (a
# 0.108 kg cube of inertia 7.6e-5 kg m^2 under added inertias up to
# h c_t ~ 80 kg, friction_vel 0.01 m/s), so the last-bit differences of the
# two versions' articulated solves grow several-fold per step; free running,
# the versions part within 3 steps (qd 0.02, net 1.9 N of 1.5 kN)
STEPWISE = {"allegro_hand", "shadow_hand", "boxbox_terrain", "franka_cabinet", "factory_screw",
            "trifinger"}
HOST_CASES = ["cartpole", "tiny", "ant", "anymal_terrain", "cylinder_slope",
              "ball_balance", "pair_capsule", "held", "boxbox", "capbox", "spherebox",
              "allegro_hand", "tendon", "shadow_hand", "boxbox_terrain", "pair_capsule_terrain",
              "humanoid_mjcf", "franka", "franka_cabinet", "factory_screw", "trifinger",
              "ingenuity", "quadcopter", "ma_op3", "humanoid_amp"]
# the heightfield cases with actor pairs: both the pairs and the ground touched
PAIR_TERRAIN = {"boxbox_terrain": 2, "pair_capsule_terrain": 1}


def _step(model, sp, task, ground, device, need_torque=True):
    return fused.build_fused_step_fn(model, sp, ground=_ground(ground, device),
                                     attractors=getattr(task, "attractors", None),
                                     need_torque=need_torque)


@pytest.mark.parametrize("name", HOST_CASES)
def test_kernel_source_on_host_matches_plain(host_kernel, name):
    model, sp, task, ground = _model(name)
    step = _step(model, sp, task, ground, "cpu", need_torque=(0,) if name == "ant" else True)
    params, q, qd, ctrl, w = _inputs(name, model, task, "cpu", ground)
    qa, qda, qb, qdb = q, qd, q, qd
    touched = pair_touched = ground_touched = 0.0
    sides = np.zeros(3)                          # the most env-tendons below, inside, above bounds
    for _ in range(5):
        if name in STEPWISE:
            qa, qda = qb, qdb                    # each step from the plain version's state
        if model.tendons:
            # the lengths as the kernel sums them (the Screw thread's lies on
            # its bound 0 exactly in a third of the envs)
            L = tendon_sums(model.tendons, qb[:, model.n_floating * 7:]).numpy()
            lo, hi = (np.array([t[k] for t in model.tendons]) for k in (1, 2))
            sides = np.maximum(sides, [(L < lo).mean(), ((L >= lo) & (L <= hi)).mean(), (L > hi).mean()])
        qa, qda, na = _host_call(host_kernel, step, params, qa, qda, ctrl, w)
        qb, qdb, nb_ = step.plain(params, qb, qdb, ctrl, w)
        _assert_close((qa, qda, na), (qb, qdb, nb_))
        if name in ("humanoid_mjcf", "humanoid_amp"):    # chip_smoke's flat-mode net tolerance
            np.testing.assert_allclose(na.numpy(), nb_.numpy(), atol=1e-2, rtol=5e-3)
        rows = nb_[..., :3].abs().amax(-1) > 0
        if name in ("allegro_hand", "shadow_hand"):   # the share of envs whose cube is touched
            rows = rows[:, task.object_body]
        if name == "humanoid_mjcf":              # the share of envs with a body on the ground
            rows = rows.any(-1)
        if name in ("franka_cabinet", "factory_screw"):   # the share of envs with a pad touched
            rows = rows[:, [task.lfinger_body, task.rfinger_body]].any(-1)
        if name == "trifinger":                  # the share of env-fingertips touched
            rows = rows[:, list(task.net_torque_bodies)]
        if name in ("ingenuity", "quadcopter", "ma_op3", "humanoid_amp"):  # a body touched
            rows = rows.any(-1)
        touched = max(touched, float(rows.float().mean()))
        if name in PAIR_TERRAIN:
            fr = forward_kinematics(model, qb, qdb)
            pair_touched = max(pair_touched, float((torch.stack([c[5] for c in collide.candidates(
                model, fr)], -1) > 0).any(-1).float().mean()))
            planes = step.sampler(qb).reshape(B, -1, 3)
            p, _ = fused.contact.candidate_points(model, fr)
            z = planes[..., 0] + planes[..., 1] * p[..., 0] + planes[..., 2] * p[..., 1]
            cand = fused.contact.candidates(model)
            # the candidates of the free actors (a fixed one's lie where they lie in every env)
            free = torch.as_tensor([model.roots_floating[model.actors[b]] for b in cand["body"]])
            ground_touched = max(ground_touched, float(
                ((z > p[..., 2] - torch.as_tensor(cand["r"])) & free).any(-1).float().mean()))
    if name in ("anymal_terrain", "cylinder_slope", "ball_balance", "pair_capsule", "allegro_hand",
                "shadow_hand", "humanoid_mjcf", "franka_cabinet", "factory_screw", "trifinger",
                "ingenuity", "quadcopter", "ma_op3", "humanoid_amp", *PAIR_TERRAIN, *BOX_POSES):
        assert touched > 0.1                     # the ground or a pair is touched
    if name == "humanoid_mjcf":                  # over the shared budget: the split layout
        assert step.pair_mode == 0 and step.block == fused.BLOCK and step.layout == "split"
        assert step.layout_bytes == 363_568 > fused.SMEM_BUDGET
        mi, mf = step._tables
        assert step.smem_bytes == fused.split_bytes(model.nb, model.nj, model.nq, model.nv, step._nc,
                                                    fused.BLOCK, tables=len(mi) + len(mf)) == 201_264
    if name == "humanoid_amp":                   # over the split layout's budget too: lean split
        counts, tables = (model.nb, model.nj, model.nq, model.nv, step._nc), sum(map(len, step._tables))
        assert (step.pair_mode, step.layout, step.smem_bytes) == (0, "split_lean", 228_768)
        assert step.layout_bytes == 466_080
        assert fused.split_bytes(*counts, fused.BLOCK, tables=tables) == 253_088 > fused.SMEM_BUDGET
        assert step.smem_bytes == fused.lean_bytes(*counts, fused.BLOCK, tables=tables)
        stats = amp_contact_stats(model, q)
        assert stats["both_soles_env_share"] > 0.3 and stats["capsule_env_share"] > 0.1, stats
    if name == "ma_op3":                         # feet on table legs, grippers on the table top
        fr = forward_kinematics(model, q, qd)
        depth = torch.stack([c[5] for c in collide.candidates(model, fr)], -1)
        kinds = [k for _, _, k in collide.pairs(model)
                 for _ in range(collide.CANDIDATES_PER_KIND[k])]
        for kind in ("boxbox", "sphere"):
            cols = [i for i, k in enumerate(kinds) if k == kind]
            assert float((depth[:, cols] > 0).any(-1).float().mean()) > 0.3, kind
    if name in PAIR_TERRAIN:                     # a heightfield pair instance: ground and pair
        assert step.hf is not None and step.pair_mode == PAIR_TERRAIN[name]
        assert pair_touched > 0.1 and ground_touched > 0.1, (pair_touched, ground_touched)
    if model.tendons:                            # the tendon springs act, not in every env-tendon
        assert (sides > 0.1).all(), sides


RAGGED = 37            # one block of fused.BLOCK envs and a ragged edge of 5


def _first(n, model, q, qd, ctrl, w):
    """The first n envs of `_inputs`' batch, with default params batched to n."""
    return (model.default_params("cpu").batch(n), q[:n], qd[:n],
            Controls(*(c[:n] for c in ctrl)), w[:n])


def _bits(outs):
    return [o.contiguous().view(torch.int32) for o in outs]


# the flat instance's split layouts by model, in the ragged-block check
SPLIT_CASES = {"humanoid_mjcf": "split", "humanoid_amp": "split_lean"}


@pytest.mark.parametrize("name", ["ant", "anymal_terrain", "ball_balance", "pair_capsule",
                                  *SPLIT_CASES])
def test_host_kernel_ragged_block(host_kernel, monkeypatch, name):
    """A shared instance (without pairs, or with the round pairs and
    attractors), HumanoidMJCF's split instance or HumanoidAMP's lean split
    one, on the host over 37 distinct envs in blocks of fused.BLOCK (a full
    block and a ragged edge): each env within test_fused's tolerances of the
    plain version (the humanoids' net also within chip_smoke's flat 1e-2 N),
    and the lane check of the host loop clean (``_host_call``). Permuting
    the envs permutes the outputs bit for bit, and the local layout (the
    budget set to 0, blocks of 32) gives the same bits."""
    model, sp, task, ground = _model(name)
    step = _step(model, sp, task, ground, "cpu")
    assert step.block == fused.BLOCK == 32 and step.smem_bytes > 0
    assert step.layout == SPLIT_CASES.get(name, "shared")
    params, q, qd, ctrl, w = _first(RAGGED, model, *_inputs(name, model, task, "cpu", ground)[1:])
    got = _host_call(host_kernel, step, params, q, qd, ctrl, w)
    want = step.plain(params, q, qd, ctrl, w)
    _assert_close(got, want)
    if name in SPLIT_CASES:
        np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), atol=1e-2, rtol=5e-3)
    perm = torch.as_tensor(np.random.default_rng(5).permutation(RAGGED))
    got_p = _host_call(host_kernel, step, params, q[perm], qd[perm],
                       Controls(*(c[perm] for c in ctrl)), w[perm])
    for a, b in zip(_bits(got_p), _bits(got)):
        assert torch.equal(a, b[perm])
    monkeypatch.setattr(fused, "SMEM_BUDGET", 0)
    assert step.layout == "local" and step.smem_bytes == 0
    local = _host_call(host_kernel, step, params, q, qd, ctrl, w)
    for a, b in zip(_bits(local), _bits(got)):
        assert torch.equal(a, b)


# the wide layout's cases (two-actor box scenes, the Franka family's
# contact states, MA_OP3's) and its lanes an env, each with a block size
WIDE_CASES = ["boxbox", "capbox", "spherebox", "franka_cabinet", "factory_screw", "ma_op3"]
WIDE_BLOCK = {2: 128, 4: 64, 32: 128}
WIDE_ENVS = 5          # 2 blocks of 4 envs at G = 32: a ragged edge


@pytest.mark.parametrize("lanes", sorted(WIDE_BLOCK))
@pytest.mark.parametrize("name", WIDE_CASES)
def test_host_wide_layout_matches_local(host_kernel, name, lanes):
    """The box instance's wide layout on the host, its G lanes an env as G
    threads exchanging the pair narrowphase's candidates by (emulated) warp
    shuffles, over 5 envs: two launches, each from the last one's outputs,
    bit for bit the local layout's; neither layout takes shared memory. A
    pair candidate is in contact in some env."""
    model, sp, task, ground = _model(name)
    step = _step(model, sp, task, ground, "cpu")
    assert step.pair_mode == 2
    params, q, qd, ctrl, w = _first(WIDE_ENVS, model, *_inputs(name, model, task, "cpu", ground)[1:])
    fr = forward_kinematics(model, q, qd)
    assert bool((torch.stack([c[5] for c in collide.candidates(model, fr)], -1) > 0).any())
    outs = {}
    for geometry in (HOST_BOX_GEOMETRY, ("wide", lanes, WIDE_BLOCK[lanes])):
        step.force_geometry = geometry
        assert step.launch_geometry(WIDE_ENVS) == (*geometry, 0)
        qa, qda = q, qd
        for _ in range(2):
            qa, qda, na = _host_call(host_kernel, step, params, qa, qda, ctrl, w)
            outs.setdefault(geometry[0], []).extend(_bits((qa, qda, na)))
    for a, b in zip(outs["wide"], outs["local"]):
        assert torch.equal(a, b)


def test_box_geometry_rule(host_kernel):
    """ops/fused.py pick_box_geometry, a pure function of the width, the
    body count and the SM count, on an H100's 132 SMs, at the widths its
    sweeps measured (PERF.md): the hands at 16384 envs keep the local layout
    in blocks of 128; FrankaCubeStack's 8192 envs, FrankaCabinet's and
    MA_OP3's 4096 take it in blocks of 32 (256 and 128 warps); below that
    the wide layout in blocks of 32, G halving as the width doubles on
    FactoryPick's 12 bodies (G = 32 at its 128 envs: 128 blocks on 128
    SMs), smaller on more bodies (MA_OP3's 47: G = 32 at its CLI's 8 envs,
    8 at 128, 2 at 512), and one thread an env in blocks of 32 where G would
    be 1 (MA_OP3 at 1024, FrankaCabinet's 15 bodies at 2048). A wide lane's
    slot is the kernel's ``wide_lane_words``. The wrapper's geometry is the
    rule's for its model at the card's SM count, or the forced one."""
    assert fused.wide_lane_words() == host_kernel.host_wide_lane_words() == 7 * 17
    want = {(16384, 18): ("local", 1, 128), (16384, 26): ("local", 1, 128),
            (8192, 12): ("local", 1, 32), (4096, 15): ("local", 1, 32),
            (4096, 47): ("local", 1, 32), (4096, 12): ("local", 1, 32),
            (128, 12): ("wide", 32, 32), (256, 12): ("wide", 16, 32),
            (512, 12): ("wide", 8, 32), (1024, 12): ("wide", 4, 32),
            (2048, 12): ("wide", 2, 32), (128, 13): ("wide", 16, 32),
            (8, 47): ("wide", 32, 32), (128, 47): ("wide", 8, 32), (512, 47): ("wide", 2, 32),
            (1024, 47): ("local", 1, 32), (2048, 47): ("local", 1, 32),
            (128, 15): ("wide", 16, 32), (512, 15): ("wide", 4, 32),
            (2048, 15): ("local", 1, 32), (1024, 11): ("wide", 4, 32)}
    for (envs, bodies), geometry in want.items():
        assert fused.pick_box_geometry(envs, bodies, 132) == geometry
    layout, lanes, block = want[128, 12]
    assert min(132, -(-128 * lanes // block)) >= 100
    model, sp, task, ground = _model("ma_op3")
    assert model.nb == 47
    step = _step(model, sp, task, ground, "cpu")
    for (envs, bodies), geometry in want.items():
        if bodies == 47:
            assert step.launch_geometry(envs, sms=132) == (*geometry, 0)
    step.force_geometry = ("wide", 4, 64)
    assert step.launch_geometry(4096, sms=132) == ("wide", 4, 64, 0)


def chain_model(n_bodies: int):
    """A floating sphere and a chain of n_bodies - 1 capsule links on
    revolute joints: 2 n_bodies - 1 ground candidates."""
    inertial = "<inertial><mass value='0.5'/><inertia ixx='1e-3' iyy='1e-3' izz='1e-3' " \
        "ixy='0' ixz='0' iyz='0'/></inertial>"
    geom = ["<sphere radius='0.05'/>"] + ["<capsule radius='0.03' length='0.1'/>"] * (n_bodies - 1)
    return load_urdf("<robot name='chain'>" + "".join(
        f"<link name='l{i}'>{inertial}<collision><geometry>{g}</geometry></collision></link>"
        for i, g in enumerate(geom)) + "".join(
        f"<joint name='j{i}' type='revolute'><parent link='l{i}'/><child link='l{i + 1}'/>"
        f"<origin xyz='0 0 -0.12'/><axis xyz='{i % 2} {(i + 1) % 2} 0'/>"
        f"<limit lower='-1' upper='1' effort='10' velocity='10'/></joint>"
        for i in range(n_bodies - 1)) + "</robot>")


def test_shared_budget_rule(host_kernel):
    """ops/fused.py pick_layout, a pure function of the model's counts and
    the block size: Ant, AnymalTerrain and BallBalance (with its pair
    bodies' sums) fit the shared layout in blocks of 32 and no layout in
    blocks of 128, with the lane words the kernel's own (``lane_words``,
    odd). A chain of HumanoidMJCF's counts (22 bodies, 21 joints, 43 ground
    candidates) does not fit the shared layout on either ground: on flat
    ground it takes the split layout (its tables and each env's slice
    without rows and articulated inertias, the kernel's
    ``split_lane_words``), over a heightfield the local one. HumanoidAMP's
    counts (29 bodies, 38 candidates) and a chain of 29 bodies (57
    candidates) exceed the split layout's budget and take the lean split
    layout (each slice without the candidates' kept state, the kernel's
    ``lean_lane_words``). A chain of 40 bodies exceeds even the lean
    layout's budget and takes the local layout. The chains match the plain
    version."""
    for name in ("ant", "anymal_terrain", "ball_balance"):
        model, sp, task, ground = _model(name)
        step = _step(model, sp, task, ground, "cpu")
        hf, rows, (mi, mf) = step.hf is not None, step.rows["total"], step._tables
        counts = (model.nb, model.nj, model.nq, model.nv, step._nc)
        npb = len(fused.pair_bodies(model)) if step.pair_mode == 1 else 0
        assert (name == "ball_balance") == (npb > 0)
        words = fused.sweep_lane_words(*counts, heightfield=hf, rows=rows, pair_bodies=npb)
        assert words % 2 == 1 and words == host_kernel.host_lane_words(*counts, int(hf), rows, npb)
        tables = 0 if npb else len(mi) + len(mf)       # the pair instance reads them from device memory
        kw = dict(pairs=npb > 0, heightfield=hf, rows=rows, tables=tables, pair_bodies=npb)
        assert fused.pick_layout(*counts, 32, **kw) == ("shared", step.smem_bytes)
        assert step.layout == "shared" and step.smem_bytes == 4 * (tables + 32 * words)
        assert 0 < step.smem_bytes <= fused.SMEM_BUDGET
        assert fused.pick_layout(*counts, 128, **kw) == ("local", 0)
    model, sp, task, ground = _model("humanoid_amp")
    step = _step(model, sp, task, ground, "cpu", need_torque=False)
    counts, tables = (model.nb, model.nj, model.nq, model.nv, step._nc), sum(map(len, step._tables))
    assert counts == (29, 28, 35, 34, 38) and tables == 1032 and step.rows["total"] == 1056
    words = fused.lean_lane_words(*counts)
    assert words % 2 == 1 and words == host_kernel.host_lean_lane_words(*counts) == 1755
    assert fused.pick_layout(*counts, 32, rows=step.rows["total"], tables=tables) == \
        ("split_lean", 4 * (tables + 32 * words)) == (step.layout, step.smem_bytes)
    assert step.smem_bytes == 228_768 <= fused.SMEM_BUDGET
    rng = np.random.default_rng(4)
    for n_bodies, layout in ((22, "split"), (29, "split_lean"), (40, "local")):
        model = chain_model(n_bodies)
        step = fused.build_fused_step_fn(model, SimParams(**TINY_SP))
        counts = (model.nb, model.nj, model.nq, model.nv, step._nc)
        assert counts[4] == 2 * n_bodies - 1
        if n_bodies == 22:
            assert counts == (22, 21, 28, 27, 43)
        rows, tables = step.rows["total"], sum(len(t) for t in step._tables)
        assert fused.layout_bytes(*counts, 32, rows=rows, tables=tables) > fused.SMEM_BUDGET
        assert fused.pick_layout(*counts, 32, heightfield=True, rows=rows, tables=tables) == ("local", 0)
        words = fused.split_lane_words(*counts)
        assert words % 2 == 1 and words == host_kernel.host_split_lane_words(*counts)
        split = fused.split_bytes(*counts, 32, tables=tables)
        assert split == 4 * (tables + 32 * words) and (split <= fused.SMEM_BUDGET) == (layout == "split")
        lean_words = fused.lean_lane_words(*counts)
        assert lean_words % 2 == 1 and lean_words == host_kernel.host_lean_lane_words(*counts)
        lean = fused.lean_bytes(*counts, 32, tables=tables)
        assert lean == 4 * (tables + 32 * lean_words) and (lean <= fused.SMEM_BUDGET) == (layout != "local")
        if n_bodies == 29:
            assert counts == (29, 28, 35, 34, 57) and lean == 229_832
        assert step.layout == layout and step.block == fused.BLOCK
        assert step.smem_bytes == {"split": split, "split_lean": lean}.get(layout, 0)
        n = 8
        q = np.zeros((n, model.nq))
        q[:, 2] = rng.uniform(0.8, 1.6, n)
        q[:, 3] = 1.0
        q[:, 7:] = rng.uniform(-0.5, 0.5, (n, model.nj))
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
        args = (model.default_params("cpu").batch(n), t(q), t(rng.normal(size=(n, model.nv)) * 0.5),
                Controls(t(rng.normal(size=(n, model.nj)) * 0.1), t(np.zeros((n, model.nj))),
                         t(rng.uniform(-5, 5, (n, model.nj)))), t(np.zeros((n, model.nb, 6))))
        got = _host_call(host_kernel, step, *args)
        _assert_close(got, step.plain(*args))
        assert float(got[2][..., 2].abs().amax()) > 0    # the chain's lowest links touch the ground


def test_kernel_caps_raise():
    model, sp, _, _ = _model("tiny")
    fused.check_caps(model)
    n = fused.MAX_BODIES + 1
    big = load_urdf("<robot name='chain'>" + "".join(
        f"<link name='l{i}'><inertial><mass value='1'/><inertia ixx='1' iyy='1' izz='1'"
        f" ixy='0' ixz='0' iyz='0'/></inertial></link>" for i in range(n)) + "".join(
        f"<joint name='j{i}' type='revolute'><parent link='l{i}'/><child link='l{i + 1}'/>"
        f"<axis xyz='0 0 1'/></joint>" for i in range(n - 1)) + "</robot>")
    with pytest.raises(NotImplementedError):
        fused.check_caps(big)
    with pytest.raises(NotImplementedError):      # at build time, not at the first launch
        fused.build_fused_step_fn(big, sp)


@pytest.mark.parametrize("n_bodies", [fused.MAX_PAIR_BODIES, fused.MAX_PAIR_BODIES + 1])
def test_pair_body_cap(n_bodies):
    """A fixed chain of n_bodies - 1 links, each with a sphere, beside a free
    ball: n_bodies pair bodies. At the cap (32, kMaxPairBodies in the source)
    the wrapper builds; above it, it raises at build time."""
    links = n_bodies - 2                                    # joints of the chain
    assert f"constexpr int kMaxPairBodies = {fused.MAX_PAIR_BODIES};" in open(fused.SOURCE).read()
    inertial = "<inertial><mass value='0.1'/><inertia ixx='1e-3' iyy='1e-3' izz='1e-3' ixy='0' " \
        "ixz='0' iyz='0'/></inertial>"
    chain = load_urdf("<robot name='chain'>" + "".join(
        f"<link name='l{i}'>{inertial}<collision><geometry><sphere radius='0.01'/></geometry>"
        f"</collision></link>" for i in range(links + 1)) + "".join(
        f"<joint name='j{i}' type='revolute'><parent link='l{i}'/><child link='l{i + 1}'/>"
        f"<origin xyz='0.03 0 0'/><axis xyz='0 0 1'/></joint>" for i in range(links)) + "</robot>",
        fix_base_link=True)
    ball = load_urdf(PAIR_BALL)
    scene = compose([(chain, (0, 0, 1, 1, 0, 0, 0), "c/"), (ball, (0, 0, 2, 1, 0, 0, 0), "b/")])
    assert len(fused.pair_bodies(scene)) == n_bodies
    if n_bodies > fused.MAX_PAIR_BODIES:
        with pytest.raises(NotImplementedError, match="pair bodies"):
            fused.build_fused_step_fn(scene, SimParams())
    else:
        assert fused.build_fused_step_fn(scene, SimParams()).pair_mode == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", HOST_CASES)
def test_cuda_kernel_matches_plain(cuda_device, name):
    model, sp, task, ground = _model(name)
    step = _step(model, sp, task, ground, cuda_device)
    params, q, qd, ctrl, w = _inputs(name, model, task, cuda_device, ground)
    qa, qda, qb, qdb = q, qd, q, qd
    for _ in range(5):
        if name in STEPWISE:
            qa, qda = qb, qdb                    # each step from the plain version's state
        qa, qda, na = step(params, qa, qda, ctrl, w)
        qb, qdb, nb_ = step.plain(params, qb, qdb, ctrl, w)
        if name in STEPWISE:
            _assert_close((qa, qda, na), (qb, qdb, nb_))
    torch.cuda.synchronize()
    _assert_close((qa, qda, na), (qb, qdb, nb_))
    assert step.launches == 5


@pytest.mark.parametrize("name", ["anymal_terrain", "ball_balance", "humanoid_mjcf", "humanoid_amp",
                                  "boxbox"])
def test_cuda_refused_shared_memory_raises(cuda_device, monkeypatch, name):
    """A block asking for more dynamic shared memory than the card gives
    (the budget lifted, in blocks of 64: AnymalTerrain about 450 KB,
    BallBalance's pair instance about 310 KB; HumanoidMJCF's split layout
    and HumanoidAMP's lean split one, the budget set to that layout's bytes
    in blocks of 64, 399 KB and 453 KB) is refused by
    cudaFuncSetAttribute, and the box instance's wide layout in blocks of
    256 threads (G = 32: 8 envs a block), over the kernel's launch bound of
    128, is refused at launch; FusedStep.launch raises, nothing runs, and
    the next launch within the bounds succeeds."""
    model, sp, task, ground = _model(name)
    step = _step(model, sp, task, ground, cuda_device)
    params, q, qd, ctrl, w = _inputs(name, model, task, cuda_device, ground)
    packed = step.pack(params, q, qd, ctrl, w)
    budget = fused.SMEM_BUDGET
    if step.pair_mode == 2:
        step.force_geometry = ("wide", 32, 256)
    else:
        layout = step.layout
        step.block = 64
        own = {"split": fused.split_bytes, "split_lean": fused.lean_bytes}
        monkeypatch.setattr(fused, "SMEM_BUDGET", 1 << 22 if layout == "shared" else own[layout](
            model.nb, model.nj, model.nq, model.nv, step._nc, 64, tables=sum(map(len, step._tables))))
        assert step.layout == layout and step.smem_bytes > budget
    with pytest.raises(RuntimeError, match="launch failed"):
        step.launch(packed)
    assert step.launches == 0
    monkeypatch.setattr(fused, "SMEM_BUDGET", budget)
    step.block = None if step.pair_mode == 2 else fused.BLOCK
    step.force_geometry = None
    step.launch(packed)
    torch.cuda.synchronize()
    assert step.launches == 1


# the wide layout with several envs a warp, each with a block size: 16, 8,
# 4 and 2 envs a warp
WIDE_CARD = [("wide", 2, 32), ("wide", 4, 64), ("wide", 8, 32), ("wide", 16, 128)]


@pytest.mark.parametrize("geometry", WIDE_CARD, ids=lambda g: f"G{g[1]}x{g[2]}")
def test_cuda_wide_layout_matches_local(cuda_device, geometry):
    """The box instance's wide layout on the card where a warp holds several
    envs, on MA_OP3's contact states (64 envs): in some warp a pair is apart
    in one env and near in another, so the kernel runs that pair and
    feeds the apart env's candidates in at depth -1 (the host build runs one
    env a warp and skips such a pair). Two launches, each from the last
    one's outputs, bit for bit the local layout in blocks of 128."""
    _, lanes, _ = geometry
    model, sp, task, ground = _model("ma_op3")
    step = _step(model, sp, task, ground, cuda_device)
    params, q, qd, ctrl, w = _inputs("ma_op3", model, task, cuda_device, ground)
    apart = fused.pairs_apart(model, forward_kinematics(model, q, qd)).cpu()
    warps = apart.reshape(-1, 32 // lanes, apart.shape[-1])
    assert bool((warps.any(1) & ~warps.all(1)).any())
    outs = {}
    for geo in (("local", 1, 128), geometry):
        step.force_geometry = geo
        qa, qda = q, qd
        for _ in range(2):
            qa, qda, na = step(params, qa, qda, ctrl, w)
            outs.setdefault(geo[0], []).extend(_bits((qa, qda, na)))
        assert step.last_geometry["layout"] == geo[0] and step.last_geometry["lanes"] == geo[1]
    torch.cuda.synchronize()
    assert step.launches == 4
    for a, b in zip(outs["wide"], outs["local"]):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_inputs():
    model, sp, task, _ = _model("ant")
    step = fused.build_fused_step_fn(model, sp)
    params, q, qd, ctrl, w = _inputs("ant", model, task, "cpu")
    with pytest.raises(ValueError):
        step.pack(params, q[:, :-1], qd, ctrl, w)
    with pytest.raises(ValueError):
        step.pack(params, q, qd, ctrl, w[:, :-1])
    with pytest.raises(ValueError):
        step.launch(step.pack(params, q, qd, ctrl, w))     # CPU slab: no kernel launch
    assert step.launches == 0
