"""Operations and bytes of one launch of the port's physics kernel
(``csrc/fused_step.cu``): a frozen copy of the counts that ``chip_smoke.py``
keeps (``OPS``, ``kernel_ops_per_env`` and its byte rule), applied to a
model built by the benchmark's reference (``reference/port``).

An add, multiply, divide, min, max or compare counts one fp32 operation, and
so do sin, cos, tanh and sqrt; a negation counts none. Bytes: each input row
of the packed (R, B) slab read once and each output row written once.

Two counts of the operations: ``most`` counts the force of every contact
candidate (what the kernel could do at most, and what ``chip_smoke.py``
reports), ``needed`` counts the force only of the candidates these inputs
put in contact (``active`` gives their shares)."""
from __future__ import annotations

import numpy as np

from benchmark.reference.port.ops import collide, contact

# published peaks of one NVIDIA H100 SXM (dense): fp32 outside the tensor
# cores, HBM3 bandwidth
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

_CROSS, _V3, _QMUL, _QROT, _QTOMAT, _M3V, _MM = 9, 3, 28, 30, 30, 15, 45
_SPATIAL_XFORM = 2 * _M3V + _CROSS + _V3
_SPATIAL_CROSS = 3 * _CROSS + _V3
_SYMI_MUL = 4 * _M3V + 2 * _V3
OPS = dict(
    root=_QROT,
    joint_local={1: 1 + 2 + 3 + _QMUL + 3, 0: 3 + _QROT + _V3 + 3},
    joint_fk=_QTOMAT + _SPATIAL_XFORM + 6 + _SPATIAL_CROSS + _QMUL + _QROT + _V3,
    joint_drive=6 + 2 + 7 + 7 + 4 + 4 + 19,
    joint_inward=40 + 6 + 63 + _SYMI_MUL + 19
    + (27 + 4 * _MM + 18 + 2 * _MM + 12 + _MM + 9 + 2 * _MM + 6) + _SPATIAL_XFORM + 6,
    joint_outward=_SPATIAL_XFORM + 6 + 11 + 4 + 9,
    joint_euler=11,
    body=32 + _SYMI_MUL + (_QROT + 2 * _V3) + (6 + 2 * _QROT) + _SPATIAL_CROSS + 21,
    cand_geom=_QMUL + 2 * (_QROT + _V3) + 4,
    cand_rim=_QROT + 6 + 5 + 2 + 3 + 2 * _V3,
    cand_force=4 + (2 * _QROT + _CROSS + _V3) + 5 + 12 + 6 + 11 + 9 + 11 + 12,
    floating=198 + 188,
    hf_sample=4 + 2 + 6 + 13 + 12 + 4,
    hf_contact=4 + 6 + 2 + 1 + 5 + 5 + 6 + 2 + 7,
    pair_pose=2 * (_QMUL + _QROT + _V3),
    pair_kind={"sphere/0": 22, "sphere/1": 22 + _QROT + 10 + 6, "sphere/3": 110, "capcap": 176},
    pair_force=6 + 2 * (2 * _QROT + _CROSS + _V3) + 8 + 9 + 10 + 12 + 5 + 12 + 2 * _CROSS + 12,
    pair_inertia=5 + 2 * (3 + 2 * _QROT + _CROSS + 33 + 48),
    pair_body=12 + 21,
    sphere_box=33 + 6 + 3 + 3 + 7 + 3 + 5 + 9 + 6 + _QROT + 2 + 6,
    capbox=_QROT + 2 * (2 * _V3 + _QROT + 3) + 3 + 18 * (5 + 2 * 21 + 3) + 6 + 4 * 10,
    boxbox=60 + 3 + 45 + 30 + 18 + 30 + 12 + 5 + 19 + 18 + 16 * (18 + 21 + 8) + 11 + 9 * 34
    + 76 + 3,
    attractor=_QROT + _V3 + 3 + (2 * _QROT + _CROSS + _V3) + 4 + 6 + 12 + _CROSS + 6,
    tendon=4 + 1 + 2 + 6 + 4,
    tendon_term=4 + 2 + 3,
)

# the packed slab's per-env rows, in the kernel's order (before the tendon
# and plane rows)
_ROW_NAMES = ("q", "qd", "tp", "tv", "eff", "mass", "com", "inertia", "gscale",
              "armature", "damping", "friction", "lower", "upper", "vel_limit",
              "posm", "velm", "effm", "kp", "kd", "eff_lim", "locked",
              "locked_pos", "geom_fric", "gravity", "wrench")


def input_rows(model) -> int:
    """Float32 rows of one env's packed input (the CUDA slab: no plane rows)."""
    nq, nv, nj, nb, ng = model.nq, model.nv, model.nj, model.nb, model.ng
    nt = len(model.tendons)
    sizes = dict(q=nq, qd=nv, tp=nj, tv=nj, eff=nj, mass=nb, com=3 * nb,
                 inertia=6 * nb, gscale=nb, geom_fric=ng, gravity=3, wrench=6 * nb,
                 tstiff=nt, tdamp=nt)
    return sum(sizes.get(name, nj) for name in _ROW_NAMES + ("tstiff", "tdamp"))


def output_rows(model, torque_bodies: int) -> int:
    """q, qd, the net force of every body and the torque of the sensor bodies."""
    return model.nq + model.nv + 3 * model.nb + 3 * int(torque_bodies)


def pair_bodies(model) -> tuple:
    return tuple(sorted({model.geoms[i].body for ia, ib, _ in collide.pairs(model)
                         for i in (ia, ib)}))


def ops_per_env(model, n_steps: int, attractors=(), active=None) -> float:
    """fp32 operations of one env's physics step of `n_steps` substeps on
    flat ground. ``active`` None counts every candidate's force (``most``);
    a dict {"ground": share, "pairs": share} counts the force of that share
    of the ground and pair candidates (``needed``)."""
    share_g = 1.0 if active is None else float(active["ground"])
    share_p = 1.0 if active is None else float(active["pairs"])
    cand = contact.candidates(model)
    jt = np.asarray(model.joint_type)
    pair_ops = 0.0
    for _, ib, k in collide.pairs(model):
        n_cand = collide.CANDIDATES_PER_KIND[k]
        pair_ops += OPS["pair_pose"] + share_p * n_cand * (OPS["pair_force"] + OPS["pair_inertia"])
        if k in ("capbox", "boxbox"):
            pair_ops += OPS[k] + (4 * OPS["sphere_box"] if k == "capbox" else 0)
        elif k == "sphere" and model.geoms[ib].gtype == 2:
            pair_ops += OPS["sphere_box"]
        else:
            pair_ops += OPS["pair_kind"][k if k == "capcap" else f"{k}/{model.geoms[ib].gtype}"]
    tendon_ops = sum(OPS["tendon"] + OPS["tendon_term"] * int(np.count_nonzero(coef))
                     for coef, *_ in model.tendons)
    nc = len(cand["geom"])
    per_sub = (pair_ops + tendon_ops + len(pair_bodies(model)) * OPS["pair_body"]
               + len(attractors) * OPS["attractor"]
               + model.n_roots * OPS["root"]
               + sum(OPS["joint_local"][int(t == 1)] for t in jt)
               + model.nj * (OPS["joint_fk"] + OPS["joint_drive"] + OPS["joint_inward"]
                             + OPS["joint_outward"] + OPS["joint_euler"])
               + model.nb * OPS["body"]
               + nc * OPS["cand_geom"] + share_g * nc * OPS["cand_force"]
               + int(np.sum(cand["rim"])) * OPS["cand_rim"]
               + model.n_floating * OPS["floating"])
    return float(per_sub * n_steps)


def launch(model, n_steps: int, envs: int, torque_bodies: int, attractors=(),
           active=None) -> dict:
    """One launch at `envs` envs: its operations, bytes and least time."""
    flops = envs * ops_per_env(model, n_steps, attractors, active)
    nbytes = 4 * envs * (input_rows(model) + output_rows(model, torque_bodies))
    flops_s, bytes_s = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes, bound_s=max(flops_s, bytes_s),
                bound_by="operations" if flops_s >= bytes_s else "bytes")
