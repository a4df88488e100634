"""Batched articulated robot model: the output of the asset compilers.

Port of ``thormang_isaacgym_tpu/models/robot.py``:

- :class:`RobotModel` — static topology (numpy/tuples, hashable): parent
  indices, joint types/axes, frame offsets, collision geoms, names.
- :class:`ModelParams` — every numeric property as a tensor dataclass whose
  leaves may carry a leading env axis (``.batch(B)``); per-env domain
  randomization is a batched leaf.

Joint model: the root joint is FREE (7 q: pos + wxyz quat; 6 qd:
[omega_body, v_world]) or FIXED; every other movable joint is 1-DOF
(REVOLUTE / PRISMATIC). FIXED child links are merged into their parent.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# joint type codes
FREE = 0
REVOLUTE = 1
PRISMATIC = 2

# drive mode codes (gymapi.DOF_MODE_* semantics)
DRIVE_NONE = 0
DRIVE_POS = 1
DRIVE_VEL = 2
DRIVE_EFFORT = 3

# geom type codes
GEOM_SPHERE = 0
GEOM_CAPSULE = 1
GEOM_BOX = 2
GEOM_CYLINDER = 3


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """All numeric robot properties. Every leaf may carry a leading env axis."""
    body_mass: torch.Tensor          # (..., nb)
    body_com: torch.Tensor           # (..., nb, 3) com offset in link frame
    body_inertia: torch.Tensor       # (..., nb, 3, 3) about com, link frame
    body_gravity_scale: torch.Tensor  # (..., nb)
    dof_armature: torch.Tensor       # (..., nj)
    dof_damping: torch.Tensor        # (..., nj)
    dof_friction: torch.Tensor       # (..., nj)
    dof_lower: torch.Tensor          # (..., nj)
    dof_upper: torch.Tensor          # (..., nj)
    dof_velocity_limit: torch.Tensor  # (..., nj)
    drive_mode: torch.Tensor         # (..., nj) int32 DRIVE_*
    drive_stiffness: torch.Tensor    # (..., nj)
    drive_damping: torch.Tensor      # (..., nj)
    drive_effort_limit: torch.Tensor  # (..., nj)
    dof_locked: torch.Tensor         # (..., nj) 0/1 mask
    dof_locked_pos: torch.Tensor     # (..., nj)
    geom_friction: torch.Tensor      # (..., ng)
    geom_restitution: torch.Tensor   # (..., ng)
    tendon_stiffness: torch.Tensor   # (..., nt)
    tendon_damping: torch.Tensor     # (..., nt)
    gravity: torch.Tensor            # (..., 3)

    def map(self, fn) -> "ModelParams":
        """Apply fn to every leaf."""
        return ModelParams(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})

    def batch(self, num_envs: int) -> "ModelParams":
        """Broadcast every leaf to a leading env axis (a contiguous copy, so
        per-env leaves can be written independently)."""
        return self.map(lambda x: x.expand((num_envs,) + tuple(x.shape)).clone())

    def to(self, device) -> "ModelParams":
        return self.map(lambda x: x.to(device))


@dataclasses.dataclass(frozen=True)
class Geom:
    """A collision primitive attached to a body (static description)."""
    body: int
    gtype: int             # GEOM_*
    size: tuple            # sphere (r,), capsule (r, half_len), box (hx, hy, hz), cylinder (r, half_w)
    pos: tuple             # offset in body frame
    quat: tuple            # orientation in body frame (w, x, y, z)
    name: str = ""
    ground: bool = True    # False: ignores the ground, keeps pair collision


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static articulated-body topology, bodies in topological (depth-major)
    order. nj = number of 1-DOF joints; joint k drives body k + n_roots."""
    name: str
    body_names: tuple
    parent: tuple                # (nb,) parent body index; -1 for roots
    joint_names: tuple           # (nj,)
    joint_type: tuple            # (nj,) REVOLUTE | PRISMATIC
    joint_axis: tuple            # (nj, 3)
    joint_pos: tuple             # (nj, 3) joint frame origin in parent frame
    joint_quat: tuple            # (nj, 4) joint frame rotation in parent frame
    dof_index: tuple
    floating: bool               # True: root 0 is a free joint
    geoms: tuple                 # tuple[Geom]
    n_roots: int = 1
    root_floating: tuple = None   # per-root floating flags; None -> (floating,)
    root_base_pose: tuple = None  # per-root static pose (pos3 + quat4) for fixed roots
    body_actor: tuple = None
    sites: Any = dataclasses.field(default_factory=dict, hash=False, compare=False)
    tendons: tuple = ()
    _defaults: Any = dataclasses.field(default=None, hash=False, compare=False)

    @property
    def nb(self) -> int:
        return len(self.body_names)

    @property
    def nj(self) -> int:
        return self.nb - self.n_roots

    @property
    def roots_floating(self) -> tuple:
        return self.root_floating if self.root_floating is not None else (self.floating,)

    @property
    def n_floating(self) -> int:
        return sum(1 for f in self.roots_floating if f)

    @property
    def actors(self) -> tuple:
        return self.body_actor if self.body_actor is not None else (0,) * self.nb

    @property
    def root_nq(self) -> int:
        return 7 * self.n_floating

    @property
    def root_nv(self) -> int:
        return 6 * self.n_floating

    @property
    def nq(self) -> int:
        return self.root_nq + self.nj

    @property
    def nv(self) -> int:
        return self.root_nv + self.nj

    @property
    def ng(self) -> int:
        return len(self.geoms)

    @property
    def dof_names(self) -> tuple:
        return self.joint_names

    def dof_id(self, name: str) -> int:
        return self.joint_names.index(name)

    def body_id(self, name: str) -> int:
        return self.body_names.index(name)

    def geom_id(self, name: str) -> int:
        for i, g in enumerate(self.geoms):
            if g.name == name:
                return i
        raise KeyError(name)

    def default_params(self, device="cpu") -> ModelParams:
        """Unbatched ModelParams holding the asset-derived defaults."""
        return ModelParams(**{k: torch.as_tensor(np.asarray(v), device=device)
                              for k, v in self._defaults.items()})

    def np_topology(self):
        """(parent, joint_type, joint_axis, joint_pos, joint_quat) as numpy
        arrays (int32, int32, float32 x 3)."""
        return (
            np.array(self.parent, dtype=np.int32),
            np.array(self.joint_type, dtype=np.int32),
            np.array(self.joint_axis, dtype=np.float32),
            np.array(self.joint_pos, dtype=np.float32),
            np.array(self.joint_quat, dtype=np.float32),
        )


def make_defaults(nb: int, nj: int, ng: int, *, body_mass, body_com,
                  body_inertia, dof_lower, dof_upper, dof_velocity_limit,
                  dof_damping=None, dof_friction=None, armature: float = 0.0,
                  geom_friction=None, gravity=(0.0, 0.0, -9.81),
                  gravity_scale: float = 1.0, num_tendons: int = 0) -> dict:
    """Build the numpy defaults dict for RobotModel._defaults."""
    def z(*s):
        return np.zeros(s, dtype=np.float32)

    return dict(
        tendon_stiffness=z(num_tendons),
        tendon_damping=z(num_tendons),
        gravity=np.asarray(gravity, np.float32),
        body_gravity_scale=np.full(nb, gravity_scale, np.float32),
        body_mass=np.asarray(body_mass, np.float32),
        body_com=np.asarray(body_com, np.float32),
        body_inertia=np.asarray(body_inertia, np.float32),
        dof_armature=np.full(nj, armature, np.float32),
        dof_damping=np.asarray(dof_damping, np.float32) if dof_damping is not None else z(nj),
        dof_friction=np.asarray(dof_friction, np.float32) if dof_friction is not None else z(nj),
        dof_lower=np.asarray(dof_lower, np.float32),
        dof_upper=np.asarray(dof_upper, np.float32),
        dof_velocity_limit=np.asarray(dof_velocity_limit, np.float32),
        drive_mode=np.zeros(nj, np.int32),
        drive_stiffness=z(nj),
        drive_damping=z(nj),
        drive_effort_limit=np.full(nj, 1e9, np.float32),
        dof_locked=z(nj),
        dof_locked_pos=z(nj),
        geom_friction=(np.asarray(geom_friction, np.float32) if geom_friction is not None
                       else np.full(ng, 1.0, np.float32)),
        geom_restitution=z(ng),
    )
