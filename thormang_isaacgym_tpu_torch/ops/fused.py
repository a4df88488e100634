"""Fused physics step: the whole substep loop in ONE hand-written CUDA kernel.

Port of ``thormang_isaacgym_tpu/ops/fused.py``: ``build_fused_step_fn``
returns a step with the same signature and output layout as the TPU
version's, ``step(params, q, qd, ctrl, wrench) -> (q', qd', net (B, nb, 6))``.
The kernel (``csrc/fused_step.cu``) replaces the Pallas kernel
``_make_kernel(...).kernel``; see the note at the top of that file.

Packing follows ``_make_rows``: every per-env input is one row of a
structure-of-arrays (R, B) float32 slab, so CUDA thread b reads row r at
``in[r * B + b]``. The model's static data (topology, joint frames, contact
candidates, torque-body slots, sim constants) goes in as two small device
tables, one int32 and one float32, so one compiled kernel serves every model
under the caps below.

Multi-actor scenes add the actor-pair blocks (B5 of the TPU kernel: sphere
vs sphere / capsule / cylinder, capsule vs capsule; with B6, its box kinds:
sphere vs box, capsule vs box, box vs box) and world-point attractors (B4):
a pair table and an attractor table follow the contact candidates in the
two tables, and the kernel's pair instances loop over them (nothing per pair
or candidate is stored per thread; the pair wrench and the added inertia are
summed per pair body). The box kinds have an instance of their own, so a
scene without them runs the round-kind code as it was. Fixed tendons (block
B4b) are a third table in every instance: each tendon's nonzero (joint,
coefficient) terms and its [lo, hi], looped over after the joint drives;
their per-env stiffness and damping are two rows each of the slab.

The ground is a constant height or a ``Heightfield`` (block B7 of the TPU
kernel). Over a heightfield the kernel samples, at the step's input q, a
local plane z = c + gx x + gy y under each contact candidate and holds it
for all substeps, as the TPU kernel holds the plane rows that
``_ground_plane_sampler`` feeds it. The CUDA kernel samples the table itself
(a global pointer beside the two tables); the plain version keeps the JAX
structure: :func:`ground_plane_sampler` makes the (B, 3C) plane rows and the
op path reads them.

Without the box kinds, the kernel keeps each env's input rows and sweep
state (with pairs, also the pair bodies' sums) in the block's dynamic shared
memory, in blocks of ``BLOCK`` envs, where the budget rule ``shared_bytes``
finds room; otherwise, and in the box instance, the sweep state is
per-thread local memory.

The kernel is built at first use with ``nvcc`` alone (no PyTorch headers)
into ``thormang_isaacgym_tpu_torch/_build/`` and loaded with ``ctypes``. For
CPU tensors the step runs the plain PyTorch version (``ops.sim``'s op path,
with frozen ground planes over a heightfield); for CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.engine.terrain import Heightfield
from thormang_isaacgym_tpu_torch.models.robot import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, RobotModel,
)
from thormang_isaacgym_tpu_torch.ops import collide, contact
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import SimParams, build_plain_step_fn, check_supported

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_step.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

# caps of the generic kernel (kMaxBodies, kMaxRoots, kMaxCands,
# kMaxPairBodies in csrc/fused_step.cu; contact and pair candidates and
# attractors are looped over, not stored per thread)
MAX_BODIES = 64
MAX_ROOTS = 8
MAX_CANDIDATES = 128
MAX_PAIR_BODIES = 32
# the JAX package's runaway guard on the pair narrowphase (_MAX_PAIR_CANDIDATES)
MAX_PAIR_CANDIDATES = 1024
MAX_ATTRACTORS = 64
# the box instance's pair cull (csrc/fused_step.cu kCullMargin, kCullRel)
CULL_MARGIN = 1e-3
CULL_REL = 1e-5
# launch geometry, one thread per env: the instances without the box kinds
# in blocks of BLOCK threads (4096 envs: 128 blocks, one on each of 128 of
# the H100's 132 SMs), the box instance in blocks of PAIR_BLOCK
BLOCK = 32
PAIR_BLOCK = 128
# the dynamic shared memory a block may use on sm_90 (227 KB)
SMEM_BUDGET = 232_448
_HEADER = 48
_KIND = {"sphere": 0, "capcap": 1, "capbox": 2, "boxbox": 3}

_ROW_NAMES = ("q", "qd", "tp", "tv", "eff", "mass", "com", "inertia", "gscale",
              "armature", "damping", "friction", "lower", "upper", "vel_limit",
              "posm", "velm", "effm", "kp", "kd", "eff_lim", "locked",
              "locked_pos", "geom_fric", "gravity", "wrench")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str        # the shared library
    seconds: float   # nvcc wall time (0.0 when an up-to-date build was found)
    log: str         # nvcc / ptxas output (registers, spills)


def _nvcc() -> str:
    """nvcc on PATH, else under the CUDA toolkit PyTorch finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the fused CUDA kernel cannot be built")


def build_library() -> BuildInfo:
    """Compile csrc/fused_step.cu for sm_90a into BUILD_DIR, unless a build
    of the same source and flags is already there."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libfused_step_{tag}.so")
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return BuildInfo(path, 0.0, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, path)
    with open(log_path, "w") as f:
        f.write(log)
    return BuildInfo(path, seconds, log)


@lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    lib = ctypes.CDLL(build_library().path)
    fn = lib.fused_step_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def sweep_lane_words(nb: int, nj: int, nq: int, nv: int, nc: int, *,
                     heightfield: bool = False, rows: int = 0, pair_bodies: int = 0) -> int:
    """Words of one env's slice of the shared instances' buffer
    (csrc/fused_step.cu ``lane_words``): its `rows` input rows; q, qd; 53
    per body (v, cb, pA, quat_w, pos_w, net_f, net_t, IA, n_active); 27 per
    joint (Rl, pl, U, invD, uj, tau, diag, quat_l, qdd); per ground
    candidate 5 (point, radius, depth), over a heightfield 11 (also the
    normal and the plane); 27 per pair body (its wrench and added-inertia
    sums; the round-pair instance only). Odd, so a warp's 32 lanes hit 32
    different banks for any word."""
    return (rows + nq + nv + 53 * nb + 27 * nj + (11 if heightfield else 5) * nc
            + 27 * pair_bodies) | 1


def layout_bytes(nb: int, nj: int, nq: int, nv: int, nc: int, block: int, *,
                 heightfield: bool = False, rows: int = 0, tables: int = 0,
                 pair_bodies: int = 0) -> int:
    """The dynamic shared bytes the shared layout takes for a block of
    `block` envs: the model's two tables (`tables` words, once per block;
    without pairs only) and each env's slice (``sweep_lane_words``)."""
    return 4 * (tables + block * sweep_lane_words(nb, nj, nq, nv, nc, heightfield=heightfield,
                                                   rows=rows, pair_bodies=pair_bodies))


def shared_bytes(nb: int, nj: int, nq: int, nv: int, nc: int, block: int, **kw) -> int:
    """The budget rule of the instances without the box kinds: the
    ``layout_bytes`` of a block, or 0 when they exceed SMEM_BUDGET, and the
    model takes the local-memory layout (the same arithmetic, the sweep
    state in per-thread local memory, the rows and tables read from device
    memory)."""
    n = layout_bytes(nb, nj, nq, nv, nc, block, **kw)
    return n if n <= SMEM_BUDGET else 0


def make_rows(model: RobotModel, ground_rows: int = 0) -> dict:
    """Row offsets into the packed (R, B) input, in ``_make_rows`` order,
    plus ``total``: nt rows each of tendon stiffness and damping;
    ``ground_rows`` = 3C gives the JAX layout's plane rows (the plain
    version's), 0 the CUDA kernel's slab, which samples the heightfield
    itself."""
    nq, nv, nj, nb, ng = model.nq, model.nv, model.nj, model.nb, model.ng
    nt = len(model.tendons)
    sizes = dict(q=nq, qd=nv, tp=nj, tv=nj, eff=nj, mass=nb, com=3 * nb,
                 inertia=6 * nb, gscale=nb, geom_fric=ng, gravity=3, wrench=6 * nb,
                 tstiff=nt, tdamp=nt, gplane=ground_rows)
    rows, off = {}, 0
    for name in _ROW_NAMES + ("tstiff", "tdamp", "gplane"):
        rows[name] = off
        off += sizes.get(name, nj)
    rows["total"] = off
    return rows


def ground_plane_sampler(model: RobotModel, hf: Heightfield):
    """(B, nq) q -> (B, 3C) rows (c, gx, gy) per contact candidate, with
    z(x, y) = c + gx x + gy y the bilinear surface's height and gradient at
    the candidate's point (before a cylinder's rim shift) at q. Port of
    ``_ground_plane_sampler``; the plain gather replaces its clustered
    sampler. The kernel computes the same rows from its first substep's
    forward kinematics."""
    hgfn = hf.height_and_grad_fn()

    def sample(q: torch.Tensor) -> torch.Tensor:
        frames = forward_kinematics(model, q, q.new_zeros(q.shape[0], model.nv))
        p, _ = contact.candidate_points(model, frames)
        x, y = p[..., 0], p[..., 1]
        z0, gx, gy = hgfn(x, y)
        c0 = z0 - gx * x - gy * y
        return torch.stack([c0, gx, gy], dim=-1).reshape(q.shape[0], -1)

    return sample


def norm_torque_bodies(need_torque, nb: int) -> tuple:
    """bool | iterable of body ids -> sorted tuple of torque-sensor bodies."""
    if need_torque is True:
        return tuple(range(nb))
    if not need_torque:
        return ()
    return tuple(sorted({int(b) for b in need_torque}))


def pair_bodies(model: RobotModel) -> tuple:
    """Sorted bodies that carry a geom of an actor pair."""
    return tuple(sorted({model.geoms[i].body for ia, ib, _ in collide.pairs(model)
                         for i in (ia, ib)}))


def bounding_radius(geom) -> float:
    """The radius of the sphere about a geom's centre that holds it: sphere
    r, capsule r + half length, box |half extents|, cylinder
    sqrt(r^2 + half width^2)."""
    s = [float(x) for x in geom.size]
    if geom.gtype == GEOM_SPHERE:
        return s[0]
    if geom.gtype == GEOM_CAPSULE:
        return s[0] + s[1]
    if geom.gtype == GEOM_BOX:
        return float(np.sqrt(s[0] ** 2 + s[1] ** 2 + s[2] ** 2))
    return float(np.hypot(s[0], s[1]))


def pair_reach(model: RobotModel) -> np.ndarray:
    """(n_pairs,) float32: the sum of each pair's two bounding radii, the
    box instance's last pair float."""
    g = model.geoms
    return np.array([bounding_radius(g[ia]) + bounding_radius(g[ib])
                     for ia, ib, _ in collide.pairs(model)], np.float32)


def pairs_apart(model: RobotModel, frames) -> torch.Tensor:
    """(B, n_pairs) bool: the box instance's cull, pairs whose geom centres
    lie farther apart than their bounding radii and a margin of 1 mm plus
    1e-5 of the distance (``CULL_MARGIN``, ``CULL_REL``), in float32 as the
    kernel computes it. No candidate of such a pair can be in contact."""
    g = model.geoms
    reach = torch.as_tensor(pair_reach(model), device=frames.pos.device)
    cols = []
    for k, (ia, ib, _) in enumerate(collide.pairs(model)):
        pa, pb = (frames.pos[:, g[i].body] + Q.rotate(
            frames.quat[:, g[i].body], frames.pos.new_tensor(g[i].pos)) for i in (ia, ib))
        d = pb - pa
        dist = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
        cols.append(dist > reach[k] + (CULL_MARGIN + CULL_REL * dist))
    return torch.stack(cols, -1)


def check_caps(model: RobotModel, attractors=()) -> None:
    """Raise NotImplementedError for a model above the kernel's caps."""
    nc = len(contact.candidates(model)["geom"])
    npc = collide.pair_candidate_count(model)
    npb, na = len(pair_bodies(model)), len(attractors or ())
    if model.n_roots > MAX_ROOTS or nc > MAX_CANDIDATES or model.nb > MAX_BODIES \
            or npc > MAX_PAIR_CANDIDATES or npb > MAX_PAIR_BODIES or na > MAX_ATTRACTORS:
        raise NotImplementedError(
            f"model {model.name!r} exceeds the fused kernel's caps "
            f"({model.nb} bodies / {MAX_BODIES}, {model.n_roots} roots / {MAX_ROOTS}, "
            f"{nc} contact candidates / {MAX_CANDIDATES}, {npc} pair candidates / "
            f"{MAX_PAIR_CANDIDATES}, {npb} pair bodies / {MAX_PAIR_BODIES}, "
            f"{na} attractors / {MAX_ATTRACTORS})")


def kernel_tables(model: RobotModel, sp: SimParams, n_steps: int,
                  ground, tq_bodies: tuple, attractors=()):
    """The kernel's static model data: (int32 table, float32 table).
    `ground`: a constant height or a Heightfield (header ints 37-38: H, W;
    floats 14-16: horizontal scale, origin x, y). Fixed tendons: header
    ints 42-43 (tendons, the tstiff row; tdamp follows it); last in the int
    table each tendon's first term (nt + 1 offsets) and the terms' joints,
    last in the float table each tendon's (lo, hi) and the terms'
    coefficients, its nonzero ones in ascending joint order. Actor pairs and
    attractors: header ints 39-41 (pairs, attractors, pair bodies), floats
    17-20 (D = h kn + kd, D max_dep, h D, max_dep / 2); after the candidate
    rows, per pair (geom a, geom b, body a, body b, kind 0 sphere / 1
    capcap / 2 capbox / 3 boxbox, geom type of b) and (sizes of a and b, 3
    each, zero-padded; r_a + r_b; geom poses of a and b in their bodies;
    for a model with a pair of a box kind, the box instance's, also the sum
    of the two bounding radii, ``pair_reach``), a per-body pair-accumulator
    slot, and per
    attractor (body) and (local point, target, kp, kd, |p|^2 + 1e-6, or 0
    when |p|^2 <= 1e-6). Header ints 44-45: the two tables' lengths (the
    shared instances copy both into each block's shared memory)."""
    cand = contact.candidates(model)
    nc = len(cand["geom"])
    nb, nj, nr = model.nb, model.nj, model.n_roots
    rows = make_rows(model)
    hf = ground if isinstance(ground, Heightfield) else None
    ground_z = 0.0 if hf is not None else float(ground)
    H, W = hf.shape if hf is not None else (0, 0)
    pairs = collide.pairs(model)
    attractors = tuple(attractors or ())
    pbodies = pair_bodies(model)
    head = [nb, nj, nr, model.n_floating, model.nq, model.nv, model.ng, nc,
            len(tq_bodies), n_steps] + [rows[n] for n in _ROW_NAMES] + [rows["total"]] \
        + [H, W, len(pairs), len(attractors), len(pbodies), len(model.tendons), rows["tstiff"]]
    slot = np.full(nb, -1, np.int64)
    slot[list(tq_bodies)] = np.arange(len(tq_bodies))
    pslot = np.full(nb, -1, np.int64)
    pslot[list(pbodies)] = np.arange(len(pbodies))
    g = model.geoms
    pair_i = [[ia, ib, g[ia].body, g[ib].body, _KIND[kind], g[ib].gtype]
              for ia, ib, kind in pairs]
    terms = [np.flatnonzero(np.asarray(coef, np.float32)) for coef, *_ in model.tendons]
    t_start = np.cumsum([0] + [len(j) for j in terms])
    mi = np.concatenate([
        np.array(head + [0] * (_HEADER - len(head))),
        np.array(model.parent), np.array(model.joint_type),
        np.array(model.roots_floating, np.int64),
        cand["body"], cand["geom"], cand["rim"].astype(np.int64), slot,
        np.array(pair_i, np.int64).reshape(-1), pslot,
        np.array([a[0] for a in attractors], np.int64),
        t_start, np.concatenate([np.zeros(0, np.int64)] + terms),
    ]).astype(np.int32)
    h = sp.dt / sp.substeps
    D_imp = h * sp.contact_stiffness + sp.contact_damping
    fhead = [h, h * h, ground_z, sp.contact_stiffness, sp.contact_damping,
             sp.friction_vel, sp.plane_friction, sp.joint_limit_stiffness,
             sp.joint_limit_damping, 1.0 - sp.root_linear_damping * h,
             1.0 - sp.root_angular_damping * h, sp.max_velocity,
             sp.max_depenetration_velocity,
             h * h * sp.joint_limit_stiffness + h * sp.joint_limit_damping,
             hf.h_scale if hf is not None else 0.0,
             float(hf.origin[0]) if hf is not None else 0.0,
             float(hf.origin[1]) if hf is not None else 0.0,
             D_imp, D_imp * sp.max_depenetration_velocity, h * D_imp,
             0.5 * sp.max_depenetration_velocity]
    base = np.array(model.root_base_pose if model.root_base_pose is not None
                    else [(0, 0, 0, 1, 0, 0, 0)] * nr, np.float64)
    pair_f = []
    for ia, ib, _ in pairs:
        sa, sb = ((tuple(float(x) for x in g[i].size) + (0.0, 0.0))[:3] for i in (ia, ib))
        pair_f.append([*sa, *sb, sa[0] + sb[0], *g[ia].pos, *g[ia].quat, *g[ib].pos, *g[ib].quat])
    if collide.has_box_pairs(model):
        # the box instance's pair rows end with the bounding reach
        pair_f = [row + [float(r)] for row, r in zip(pair_f, pair_reach(model))]
    attr_f = []
    for _, local_p, target, kp, kd in attractors:
        r2 = float(np.dot(np.asarray(local_p, np.float64), np.asarray(local_p, np.float64)))
        attr_f.append([*local_p, *target, kp, kd, r2 + 1e-6 if r2 > 1e-6 else 0.0])
    mf = np.concatenate([
        np.array(fhead + [0.0] * (_HEADER - len(fhead))),
        np.array(model.joint_axis, np.float64).reshape(-1),
        np.array(model.joint_pos, np.float64).reshape(-1),
        np.array(model.joint_quat, np.float64).reshape(-1),
        base.reshape(-1),
        cand["gpos"].reshape(-1), cand["gquat"].reshape(-1),
        cand["off"].reshape(-1), cand["r"],
        np.array(pair_f, np.float64).reshape(-1),
        np.array(attr_f, np.float64).reshape(-1),
        np.array([(lo, hi) for _, lo, hi, _ in model.tendons], np.float64).reshape(-1),
        np.concatenate([np.zeros(0, np.float32)] + [np.asarray(coef, np.float32)[j]
                                                    for (coef, *_), j in zip(model.tendons, terms)]),
    ]).astype(np.float32)
    mi[44], mi[45] = len(mi), len(mf)
    return mi, mf


class FusedStep:
    """step(params, q, qd, ctrl, wrench) -> (q', qd', net (B, nb, 6)).

    params batched (B, ...); q (B, nq); qd (B, nv); ctrl leaves (B, nj);
    wrench (B, nb, 6) world frame. net = [force | torque] of the last
    substep, torque zero outside the torque-sensor bodies. ``ground``: a
    constant height or a Heightfield, whose table must lie on the device
    of the tensors the step is given. ``attractors``: (body, local_p,
    target, kp, kd) tuples. ``launches`` counts kernel launches (CPU calls
    run the plain version and do not count). ``pair_mode`` picks the
    kernel instance: 0 without pairs and attractors, 1 with them, 2 with a
    pair of a box kind. ``block`` is the launch's block size;
    ``smem_bytes`` the dynamic shared memory of a block (``shared_bytes``;
    0 in the box mode and for a model over the budget)."""

    def __init__(self, model: RobotModel, sim_params: SimParams, *,
                 ground=0.0, attractors=None, need_torque=True):
        self.model = model
        self.sim_params = sim_params
        self.n_steps = int(sim_params.substeps)
        self.attractors = tuple(attractors or ())
        ground = check_supported(model, ground, self.attractors)
        check_caps(model, self.attractors)
        # the kernel instance: with the pair and attractor blocks, and the box kinds
        self.pair_mode = 2 if collide.has_box_pairs(model) else \
            int(collide.has_pairs(model) or bool(self.attractors))
        self.hf = ground if isinstance(ground, Heightfield) else None
        self.block = PAIR_BLOCK if self.pair_mode == 2 else BLOCK
        self._nc = len(contact.candidates(model)["geom"])
        self._npb = len(pair_bodies(model)) if self.pair_mode == 1 else 0
        self.tq_bodies = norm_torque_bodies(need_torque, model.nb)
        self.rows = make_rows(model)
        self.out_rows = model.nq + model.nv + 3 * model.nb + 3 * len(self.tq_bodies)
        self._tables = kernel_tables(model, sim_params, self.n_steps, ground,
                                     self.tq_bodies, self.attractors)
        self._dev_tables = {}
        self._tq_idx = torch.tensor(self.tq_bodies, dtype=torch.long)
        self._plain = build_plain_step_fn(model, sim_params, ground, self.attractors)
        self.sampler = ground_plane_sampler(model, self.hf) if self.hf is not None else None
        self.launches = 0

    @property
    def layout_bytes(self) -> int:
        """The bytes a block of the shared layout would take (over
        SMEM_BUDGET, the launch takes the local layout instead)."""
        m = self.model
        mi, mf = self._tables
        # the pair instance keeps its tables in device memory
        return layout_bytes(m.nb, m.nj, m.nq, m.nv, self._nc, self.block,
                            heightfield=self.hf is not None, rows=self.rows["total"],
                            tables=0 if self.pair_mode else len(mi) + len(mf),
                            pair_bodies=self._npb)

    @property
    def smem_bytes(self) -> int:
        if self.pair_mode == 2:
            return 0
        n = self.layout_bytes
        return n if n <= SMEM_BUDGET else 0

    def _on(self, dev):
        """(int table, float table, torque-body index) on `dev`, built once:
        copying them per call would be a synchronous host transfer."""
        if dev not in self._dev_tables:
            mi, mf = self._tables
            self._dev_tables[dev] = (torch.as_tensor(mi, device=dev),
                                     torch.as_tensor(mf, device=dev),
                                     self._tq_idx.to(dev))
        return self._dev_tables[dev]

    # ---- plain version (CPU path; the reference on the card) ----
    def plain(self, params, q, qd, ctrl, wrench):
        planes = None
        if self.sampler is not None:
            planes = self.sampler(q).reshape(q.shape[0], -1, 3)
        q, qd, net = self._plain(params, q, qd, ctrl, wrench, planes)
        mask = torch.zeros(self.model.nb, 1, device=q.device)
        mask[self._on(q.device)[2]] = 1.0
        return q, qd, torch.cat([net[..., 0:3], net[..., 3:6] * mask], dim=-1)

    # ---- packing ----
    def pack(self, params, q, qd, ctrl, wrench) -> torch.Tensor:
        """(R, B) float32 slab in ``_make_rows`` order."""
        B, m = q.shape[0], self.model
        for name, t, shape in (("q", q, (B, m.nq)), ("qd", qd, (B, m.nv)),
                               ("target_pos", ctrl.target_pos, (B, m.nj)),
                               ("target_vel", ctrl.target_vel, (B, m.nj)),
                               ("effort", ctrl.effort, (B, m.nj)),
                               ("wrench", wrench, (B, m.nb, 6)),
                               ("params.body_mass", params.body_mass, (B, m.nb))):
            if tuple(t.shape) != shape or t.device != q.device:
                raise ValueError(f"{name}: expected shape {shape} on {q.device}, "
                                 f"got {tuple(t.shape)} on {t.device}")
        Ic = params.body_inertia
        sym = torch.stack([Ic[..., 0, 0], Ic[..., 0, 1], Ic[..., 0, 2],
                           Ic[..., 1, 1], Ic[..., 1, 2], Ic[..., 2, 2]], dim=-1)
        dm = params.drive_mode
        cols = [q, qd, ctrl.target_pos, ctrl.target_vel, ctrl.effort,
                params.body_mass, params.body_com, sym, params.body_gravity_scale,
                params.dof_armature, params.dof_damping, params.dof_friction,
                params.dof_lower, params.dof_upper, params.dof_velocity_limit,
                dm == 1, dm == 2, dm == 3,
                params.drive_stiffness, params.drive_damping,
                params.drive_effort_limit, params.dof_locked,
                params.dof_locked_pos, params.geom_friction, params.gravity, wrench]
        if m.tendons:
            cols += [params.tendon_stiffness, params.tendon_damping]
        packed = torch.cat([c.to(torch.float32).reshape(B, -1).t() for c in cols], 0)
        if packed.shape[0] != self.rows["total"]:
            raise ValueError(f"packed {packed.shape[0]} rows, expected {self.rows['total']}")
        return packed.contiguous()

    def unpack(self, out: torch.Tensor, B: int):
        m = self.model
        nq, nv, nb = m.nq, m.nv, m.nb
        q = out[:nq].t().contiguous()
        qd = out[nq:nq + nv].t().contiguous()
        net3 = out[nq + nv:nq + nv + 3 * nb].t().reshape(B, nb, 3)
        tq = out.new_zeros(B, nb, 3)
        if self.tq_bodies:
            tq_rows = out[nq + nv + 3 * nb:].t().reshape(B, len(self.tq_bodies), 3)
            tq[:, self._on(out.device)[2]] = tq_rows
        return q, qd, torch.cat([net3, tq], dim=-1)

    # ---- the kernel ----
    def launch(self, packed: torch.Tensor) -> torch.Tensor:
        """Run the kernel on a packed (R, B) CUDA slab: (out_rows, B)."""
        if packed.device.type != "cuda":
            raise ValueError("the fused kernel takes CUDA tensors only")
        if packed.dtype != torch.float32 or not packed.is_contiguous() \
                or packed.dim() != 2 or packed.shape[0] != self.rows["total"]:
            raise ValueError(f"expected a contiguous float32 ({self.rows['total']}, B) "
                             f"slab, got {packed.dtype} {tuple(packed.shape)}")
        dev = packed.device
        mi_t, mf_t, _ = self._on(dev)
        hf_ptr = None
        if self.hf is not None:
            table = self.hf.table
            if table.device != dev or table.dtype != torch.float32 \
                    or not table.is_contiguous():
                raise ValueError(f"the heightfield table must be a contiguous float32 "
                                 f"tensor on {dev}, got {table.dtype} on {table.device}")
            hf_ptr = table.data_ptr()
        B = packed.shape[1]
        out = torch.empty(self.out_rows, B, device=dev, dtype=torch.float32)
        fn = load_library().fused_step_launch
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(mi_t.data_ptr(), mf_t.data_ptr(), hf_ptr, packed.data_ptr(),
                     out.data_ptr(), B, self.pair_mode, self.block, self.smem_bytes, stream)
        if err != 0:
            raise RuntimeError(f"fused_step kernel launch failed: CUDA error {err} "
                               f"(block {self.block}, {self.smem_bytes} shared bytes)")
        self.launches += 1
        return out

    def __call__(self, params, q, qd, ctrl, wrench):
        if q.device.type == "cpu":
            return self.plain(params, q, qd, ctrl, wrench)
        if q.device.type != "cuda":
            raise ValueError(f"unsupported device {q.device}")
        return self.unpack(self.launch(self.pack(params, q, qd, ctrl, wrench)), q.shape[0])


def build_fused_step_fn(model: RobotModel, sim_params: SimParams, *,
                        ground=0.0, attractors=None, need_torque=True) -> FusedStep:
    """step(params, q, qd, ctrl, wrench) -> (q', qd', net), running
    sim_params.substeps substeps in one kernel launch; `ground` is a
    constant height or a Heightfield; `attractors` (body, local_p, target,
    kp, kd) tuples."""
    return FusedStep(model, sim_params, ground=ground, attractors=attractors,
                     need_torque=need_torque)
