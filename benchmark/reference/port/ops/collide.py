"""Actor-vs-actor narrowphase with an implicit normal solve, batched over envs.

Port of ``thormang_isaacgym_tpu/ops/collide.py`` (the JAX op path), every
kind:

  "sphere"  sphere vs sphere / capsule / cylinder / box  -> 1 point
  "capcap"  capsule vs capsule (segment-segment)         -> 1 point
  "capbox"  capsule vs box                               -> 4 points
  "boxbox"  box vs box                                   -> 17 points

Pairs are enumerated once per model between geoms of DIFFERENT actors (no
self-collision within an actor); every candidate is evaluated for every env
and masked by penetration. Capsule vs box tests spheres at the two axis end
points, the axis midpoint and the closest axis point to the box, which an
18-step ternary search finds (masked off near an end or the middle). Box vs
box shares the pair's minimum-overlap face axis (SAT over the 6 face axes,
first minimum) among 8 + 8 corner-inside candidates, plus the edge-edge
candidate of the minimum-overlap cross axis, active only when all 15 axes
overlap and that edge axis beats every face axis by 1 %. This is the plain
version of the fused kernel's block B6; the kernel computes box vs box in
the TPU kernel's closed forms (``csrc/fused_step.cu``), the same function.

Contact model: a backward-Euler normal, f_n(t+h) = kn depth - D vn(t+h)
with D = h kn + kd. The spring (clamped to kn <= 0.25 m_red / h^2 for the
pair's reduced mass and to the depenetration bound) and the current-velocity
damper enter as an explicit world wrench; the reaction to the new velocity
enters the articulated-body solve as ADDED INERTIA per touched body (link
frame): (M_n - M_t) u u^T + M_t U U^T, u = [r x n; n], U = [skew(r); I],
M_n = h D, M_t = h c_t, with c_t = mu fn / max(|vt|, friction_vel) the
regularised-Coulomb tangent damper. Each update below is written in the
order ``csrc/fused_step.cu`` computes it.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from benchmark.reference.port.core import quat as Q
from benchmark.reference.port.models.robot import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE, ModelParams, RobotModel,
)
from benchmark.reference.port.ops.kinematics import BodyFrames

# geom-type pairs handled by the one-point sphere narrowphase (a first)
_SPHERE_FIRST = {
    (GEOM_SPHERE, GEOM_SPHERE), (GEOM_SPHERE, GEOM_CAPSULE),
    (GEOM_SPHERE, GEOM_BOX), (GEOM_SPHERE, GEOM_CYLINDER),
}
# contact candidates per pair of each kind (JAX ops/fused.py _pair_candidate_count)
CANDIDATES_PER_KIND = {"sphere": 1, "capcap": 1, "capbox": 4, "boxbox": 17}


@lru_cache(maxsize=64)
def pairs(model: RobotModel) -> tuple:
    """Static geom-pair list: ((geom_a, geom_b, kind), ...)."""
    actors = model.actors
    out = []
    for i, g1 in enumerate(model.geoms):
        for jj in range(i + 1, len(model.geoms)):
            g2 = model.geoms[jj]
            if actors[g1.body] == actors[g2.body]:
                continue
            t1, t2 = g1.gtype, g2.gtype
            if (t1, t2) in _SPHERE_FIRST:
                out.append((i, jj, "sphere"))
            elif (t2, t1) in _SPHERE_FIRST:
                out.append((jj, i, "sphere"))
            elif (t1, t2) == (GEOM_CAPSULE, GEOM_CAPSULE):
                out.append((i, jj, "capcap"))
            elif t1 == GEOM_BOX and t2 == GEOM_CAPSULE:
                out.append((jj, i, "capbox"))
            elif t1 == GEOM_CAPSULE and t2 == GEOM_BOX:
                out.append((i, jj, "capbox"))
            elif (t1, t2) == (GEOM_BOX, GEOM_BOX):
                out.append((i, jj, "boxbox"))
    return tuple(out)


def has_pairs(model: RobotModel) -> bool:
    return len(pairs(model)) > 0


def has_box_pairs(model: RobotModel) -> bool:
    """A pair of a box kind: sphere vs box, capsule vs box, box vs box."""
    return any(k in ("capbox", "boxbox") or model.geoms[ib].gtype == GEOM_BOX
               for _, ib, k in pairs(model))


def pair_candidate_count(model: RobotModel) -> int:
    return sum(CANDIDATES_PER_KIND[k] for (_, _, k) in pairs(model))


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def candidates(model: RobotModel, frames: BodyFrames) -> list:
    """Every contact candidate: [(geom_a, geom_b, body_a, body_b, n (B, 3)
    unit normal a -> b, depth (B,), cp (B, 3) world contact point)]."""
    dev, f32 = frames.pos.device, frames.pos.dtype
    zhat = torch.tensor([0.0, 0.0, 1.0], device=dev, dtype=f32)

    def gpose(i):
        g = model.geoms[i]
        bq = frames.quat[:, g.body]
        gq = Q.mul(bq, torch.tensor(g.quat, device=dev, dtype=f32))
        gp = frames.pos[:, g.body] + Q.rotate(bq, torch.tensor(g.pos, device=dev, dtype=f32))
        return gp, gq

    out = []
    for ia, ib, kind in pairs(model):
        ga, gb = model.geoms[ia], model.geoms[ib]
        pa, qa = gpose(ia)
        pb, qb = gpose(ib)
        if kind == "sphere":
            ra = float(ga.size[0])
            if gb.gtype in (GEOM_SPHERE, GEOM_CAPSULE):
                if gb.gtype == GEOM_SPHERE:
                    closest = pb
                else:
                    hl = float(gb.size[1])
                    axis = Q.rotate(qb, zhat)
                    t = torch.clamp(_dot(pa - pb, axis), -hl, hl)
                    closest = pb + axis * t[..., None]
                d = closest - pa
                dist = torch.sqrt(_dot(d, d)) + 1e-9
                n = d / dist[..., None]
                depth = (ra + float(gb.size[0])) - dist
                cp = pa + n * (ra - depth * 0.5)[..., None]
            elif gb.gtype == GEOM_BOX:
                n, depth, cp = _sphere_box_point(pa, ra, pb, qb, gb.size)
            else:  # cylinder: a flat disk (the tray), closest point in its frame
                R_cyl, hw = float(gb.size[0]), float(gb.size[1])
                local = Q.rotate_inv(qb, pa - pb)
                l0, l1, l2 = local.unbind(-1)
                r_xy = torch.sqrt(l0 * l0 + l1 * l1) + 1e-9
                sc = torch.clamp(R_cyl / r_xy, max=1.0)
                closest = torch.stack([l0 * sc, l1 * sc, torch.clamp(l2, -hw, hw)], -1)
                d_out = local - closest
                dist_out = torch.sqrt(_dot(d_out, d_out)) + 1e-9
                inside = (r_xy < R_cyl) & (torch.abs(l2) < hw)
                face_gap = hw - torch.abs(l2)
                wall_gap = R_cyl - r_xy
                zero = torch.zeros_like(l0)
                n_face = torch.stack([zero, zero, torch.sign(l2)], -1)
                n_wall = torch.stack([l0 / r_xy, l1 / r_xy, zero], -1)
                n_in = torch.where((face_gap < wall_gap)[..., None], n_face, n_wall)
                out_local = torch.where(inside[..., None], n_in, d_out / dist_out[..., None])
                depth = torch.where(inside, ra + torch.minimum(face_gap, wall_gap),
                                    ra - dist_out)
                n = -Q.rotate(qb, out_local)
                cp = pa + n * ra
        elif kind == "capbox":
            out.extend((ia, ib, ga.body, gb.body) + c
                       for c in _capsule_box_candidates(pa, qa, ga.size, pb, qb, gb.size))
            continue
        elif kind == "boxbox":
            out.extend((ia, ib, ga.body, gb.body) + c
                       for c in _box_box_candidates(pa, qa, ga.size, pb, qb, gb.size))
            continue
        else:  # capcap: closest points of the two axis segments
            r1, h1 = float(ga.size[0]), float(ga.size[1])
            r2, h2 = float(gb.size[0]), float(gb.size[1])
            a1, a2 = Q.rotate(qa, zhat), Q.rotate(qb, zhat)
            P1, Q1 = pa - a1 * h1, pa + a1 * h1
            P2, Q2 = pb - a2 * h2, pb + a2 * h2
            d1, d2 = Q1 - P1, Q2 - P2
            r0 = P1 - P2
            a_ = _dot(d1, d1) + 1e-9
            e_ = _dot(d2, d2) + 1e-9
            b_ = _dot(d1, d2)
            c_ = _dot(d1, r0)
            f_ = _dot(d2, r0)
            denom = a_ * e_ - b_ * b_
            nz = torch.abs(denom) > 1e-9
            s = torch.where(nz, torch.clamp((b_ * f_ - c_ * e_)
                                            / torch.where(nz, denom, torch.ones_like(denom)),
                                            0.0, 1.0), torch.zeros_like(denom))
            t = torch.clamp((b_ * s + f_) / e_, 0.0, 1.0)
            s = torch.clamp((b_ * t - c_) / a_, 0.0, 1.0)
            c1 = P1 + d1 * s[..., None]
            c2 = P2 + d2 * t[..., None]
            d = c2 - c1
            dist = torch.sqrt(_dot(d, d)) + 1e-9
            n = d / dist[..., None]
            depth = (r1 + r2) - dist
            cp = c1 + n * (r1 - depth * 0.5)[..., None]
        out.append((ia, ib, ga.body, gb.body, n, depth, cp))
    return out


def _sphere_box_point(center, r, box_pos, box_quat, half):
    """Sphere (center (B, 3), radius r) vs box (half extents `half`): (n
    a -> b, depth, cp). Outside, along the box's closest point; inside, out
    of the face of least gap (the first on ties)."""
    h = torch.tensor([float(x) for x in half], dtype=center.dtype, device=center.device)
    local = Q.rotate_inv(box_quat, center - box_pos)
    clamped = torch.clamp(local, -h, h)
    inside = (torch.abs(local) < h).all(-1)
    d_out = local - clamped
    dist_out = torch.sqrt(_dot(d_out, d_out)) + 1e-9
    face_gap = h - torch.abs(local)
    k = torch.argmin(face_gap, dim=-1, keepdim=True)
    onehot = torch.zeros_like(local).scatter_(-1, k, 1.0)
    out_local = torch.where(inside[..., None], torch.sign(local) * onehot,
                            d_out / dist_out[..., None])
    depth = torch.where(inside, float(r) + face_gap.gather(-1, k)[..., 0], float(r) - dist_out)
    n = -Q.rotate(box_quat, out_local)
    return n, depth, center + n * float(r)


def _capsule_box_candidates(pa, qa, size_a, pb, qb, half):
    """Capsule a (radius, half length) vs box b: [(n, depth, cp)] x 4,
    spheres at the axis points t = 0, t_opt, 1/2, 1. t_opt minimises the
    axis segment's distance to the box (convex along the segment) by an
    18-step ternary search; it is masked off within 2 % of an end or of the
    middle, where it would double a sphere's stiffness."""
    r1, h1 = float(size_a[0]), float(size_a[1])
    h = torch.tensor([float(x) for x in half], dtype=pa.dtype, device=pa.device)
    axis = Q.rotate(qa, torch.tensor([0.0, 0.0, 1.0], dtype=pa.dtype, device=pa.device))
    p0 = Q.rotate_inv(qb, (pa - axis * h1) - pb)
    p1 = Q.rotate_inv(qb, (pa + axis * h1) - pb)
    dp = p1 - p0

    def seg_dist(t):
        p = p0 + dp * t[..., None]
        d = p - torch.clamp(p, -h, h)
        return torch.sqrt(_dot(d, d))

    lo = torch.zeros_like(pa[..., 0])
    hi = torch.ones_like(lo)
    third = float(np.float32(1.0 / 3.0))
    for _ in range(18):
        span = hi - lo
        m1 = lo + span * third
        m2 = hi - span * third
        left = seg_dist(m1) < seg_dist(m2)
        lo, hi = torch.where(left, lo, m1), torch.where(left, m2, hi)
    t_opt = (lo + hi) * 0.5
    eps = 0.02
    interior = (t_opt > eps) & (t_opt < 1.0 - eps) & (torch.abs(t_opt - 0.5) > eps)
    out = []
    for i, tpar in enumerate((torch.zeros_like(t_opt), t_opt, torch.full_like(t_opt, 0.5),
                              torch.ones_like(t_opt))):
        n, depth, cp = _sphere_box_point(pa + axis * (h1 * (2.0 * tpar - 1.0))[..., None], r1,
                                         pb, qb, half)
        if i == 1:
            depth = torch.where(interior, depth, torch.full_like(depth, -1.0))
        out.append((n, depth, cp))
    return out


def _axes(q):
    """(B, 3, 3): row i is the world direction of the frame's axis i."""
    return Q.to_matrix(q).transpose(-1, -2)


def _abs_proj(L, axes, half):
    """sum_i |L . axes_i| half_i for each row of L (B, k, 3): (B, k)."""
    d = torch.abs(_dot(L[..., :, None, :], axes[..., None, :, :]))
    return (d[..., 0] * float(half[0]) + d[..., 1] * float(half[1])) + d[..., 2] * float(half[2])


def _box_box_candidates(pa, qa, half_a, pb, qb, half_b):
    """Box a vs box b: [(n, depth, cp)] x 17. Corners of a inside b, then
    corners of b inside a, all along the pair's minimum-overlap face axis n
    (a -> b): a's corner depth is (pv - pb) . n + h_b(n), b's is h_a(n) -
    (pv - pa) . n, with h(n) a box's half extent along n. Then the
    edge-edge candidate (:func:`_box_box_edge_candidate`)."""
    dev, f32 = pa.device, pa.dtype
    A, Bx = _axes(qa), _axes(qb)
    d = pb - pa
    axes6 = torch.cat([A, Bx], dim=-2)                       # (B, 6, 3)
    overlap6 = (_abs_proj(axes6, A, half_a) + _abs_proj(axes6, Bx, half_b)) \
        - torch.abs(_dot(axes6, d[..., None, :]))
    kf = torch.argmin(overlap6, dim=-1)
    n_raw = torch.gather(axes6, 1, kf[:, None, None].expand(-1, 1, 3))[:, 0]
    n = n_raw * torch.sign(_dot(n_raw, d) + 1e-12)[..., None]
    hB_n = _abs_proj(n[:, None], Bx, half_b)[:, 0]
    hA_n = _abs_proj(n[:, None], A, half_a)[:, 0]
    ha = torch.tensor([float(x) for x in half_a], dtype=f32, device=dev)
    hb = torch.tensor([float(x) for x in half_b], dtype=f32, device=dev)
    corners = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
    out = []
    for s3 in corners:
        pv = pa + Q.rotate(qa, torch.tensor(s3, dtype=f32, device=dev) * ha)
        local = Q.rotate_inv(qb, pv - pb)
        inside = (hb - torch.abs(local) > 0).all(-1)
        depth = torch.where(inside, _dot(pv - pb, n) + hB_n, torch.full_like(hB_n, -1.0))
        out.append((n, depth, pv))
    for s3 in corners:
        pv = pb + Q.rotate(qb, torch.tensor(s3, dtype=f32, device=dev) * hb)
        local = Q.rotate_inv(qa, pv - pa)
        inside = (ha - torch.abs(local) > 0).all(-1)
        depth = torch.where(inside, hA_n - _dot(pv - pa, n), torch.full_like(hA_n, -1.0))
        out.append((n, depth, pv))
    out.append(_box_box_edge_candidate(pa, A, half_a, pb, Bx, half_b))
    return out


def _box_box_edge_candidate(pa, A, half_a, pb, Bx, half_b):
    """The edge-edge candidate of a box pair (rows A, Bx of world axes):
    over the 9 cross axes a_i x b_j (a degenerate one, |a_i x b_j| < 1e-6,
    never wins), the one of least overlap (the first on ties); active when
    every face and cross axis overlaps and its overlap is below 0.99 times
    the least face overlap. Its point is the midpoint of the closest points
    of the two support edges (clamped to the edges). (n (B, 3) a -> b,
    depth (B,), -1 when inactive, cp (B, 3))."""
    B_ = pa.shape[0]
    d = pb - pa
    cross = _cross(A[:, :, None, :], Bx[:, None, :, :]).reshape(B_, 9, 3)
    norm = torch.sqrt(_dot(cross, cross))
    degenerate = norm < 1e-6
    L = cross / torch.clamp(norm, min=1e-6)[..., None]
    overlap_e = (_abs_proj(L, A, half_a) + _abs_proj(L, Bx, half_b)) \
        - torch.abs(_dot(L, d[:, None]))
    overlap_e = torch.where(degenerate, torch.full_like(overlap_e, float("inf")), overlap_e)
    overlap_f = torch.cat([
        (_abs_proj(ax, A, half_a) + _abs_proj(ax, Bx, half_b)) - torch.abs(_dot(ax, d[:, None]))
        for ax in (A, Bx)], dim=-1)
    all_overlap = (overlap_e > 0).all(-1) & (overlap_f > 0).all(-1)
    k = torch.argmin(overlap_e, dim=-1)
    depth = overlap_e.gather(-1, k[:, None])[:, 0]
    Lk = torch.gather(L, 1, k[:, None, None].expand(-1, 1, 3))[:, 0]
    n = Lk * torch.sign(_dot(Lk, d))[:, None]
    active = all_overlap & (depth < overlap_f.amin(-1) * 0.99)
    i_, j_ = k // 3, k % 3
    ha = torch.tensor([float(x) for x in half_a], dtype=pa.dtype, device=pa.device)
    hb = torch.tensor([float(x) for x in half_b], dtype=pa.dtype, device=pa.device)
    sa = torch.sign(_dot(A, n[:, None]))                       # (B, 3)
    sb = torch.sign(_dot(Bx, n[:, None]))
    oh_i = torch.zeros_like(sa).scatter_(-1, i_[:, None], 1.0)
    oh_j = torch.zeros_like(sb).scatter_(-1, j_[:, None], 1.0)
    wa = (1.0 - oh_i) * sa * ha
    wb = (1.0 - oh_j) * sb * hb
    ca = pa + ((wa[:, 0:1] * A[:, 0] + wa[:, 1:2] * A[:, 1]) + wa[:, 2:3] * A[:, 2])
    cb = pb - ((wb[:, 0:1] * Bx[:, 0] + wb[:, 1:2] * Bx[:, 1]) + wb[:, 2:3] * Bx[:, 2])
    ea = torch.gather(A, 1, i_[:, None, None].expand(-1, 1, 3))[:, 0]
    eb = torch.gather(Bx, 1, j_[:, None, None].expand(-1, 1, 3))[:, 0]
    r0 = cb - ca
    b_ = _dot(ea, eb)
    denom = torch.clamp(1.0 - b_ * b_, min=1e-6)
    s = (_dot(ea, r0) - b_ * _dot(eb, r0)) / denom
    t = (b_ * _dot(ea, r0) - _dot(eb, r0)) / denom
    ha_k = ha.expand_as(oh_i).gather(-1, i_[:, None])[:, 0]
    hb_k = hb.expand_as(oh_j).gather(-1, j_[:, None])[:, 0]
    s = torch.minimum(torch.maximum(s, -ha_k), ha_k)
    t = torch.minimum(torch.maximum(t, -hb_k), hb_k)
    cp = 0.5 * (((ca + ea * s[:, None]) + cb) + eb * t[:, None])
    depth = torch.where(active, depth, torch.full_like(depth, -1.0))
    return n, depth, cp


def _G(r, M):
    """M U U^T (B, 6, 6) with U = [skew(r); I]: [[M(|r|^2 I - r r^T),
    M skew(r)], [M skew(r)^T, M I]], each entry rounded as the kernel's."""
    B = r.shape[0]
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    Mrr = M * _dot(r, r)
    Mr = M[:, None] * r
    A = Mrr[:, None, None] * eye - Mr[:, :, None] * r[:, None, :]
    z = torch.zeros_like(M)
    sk = torch.stack([z, -Mr[:, 2], Mr[:, 1], Mr[:, 2], z, -Mr[:, 0],
                      -Mr[:, 1], Mr[:, 0], z], -1).reshape(B, 3, 3)
    return torch.cat([torch.cat([A, sk], -1),
                      torch.cat([sk.transpose(-1, -2), M[:, None, None] * eye], -1)], -2)


def pairwise_contact_forces(model: RobotModel, params: ModelParams,
                            frames: BodyFrames, *, stiffness: float, damping: float,
                            friction_vel: float, dt: float,
                            max_depenetration_velocity: float = 2.0):
    """Actor-pair contact: (f_ext_w (B, nb, 6) world [torque about the body
    origin, force], the explicit part; dIA (B, nb, 6, 6) added inertia in
    the link frame, for ``aba(extra_body_inertia=...)``; net (B, nb, 3)
    world contact force on each body)."""
    B, nb = frames.pos.shape[0], model.nb
    f_ext = frames.pos.new_zeros(B, nb, 6)
    dIA = frames.pos.new_zeros(B, nb, 6, 6)
    h = dt
    kn_cfg, max_dep = float(stiffness), float(max_depenetration_velocity)
    D_imp = h * kn_cfg + float(damping)
    for ia, ib, ba, bb, n, depth, cp in candidates(model, frames):
        active = depth > 0
        act = active.to(depth.dtype)
        va = frames.vel[:, ba] + _cross(frames.omega[:, ba], cp - frames.pos[:, ba])
        vb = frames.vel[:, bb] + _cross(frames.omega[:, bb], cp - frames.pos[:, bb])
        vrel = vb - va
        vn = _dot(vrel, n)
        m_a, m_b = params.body_mass[:, ba], params.body_mass[:, bb]
        m_red = m_a * m_b / (m_a + m_b)
        # explicit spring: stability clamp for the reduced mass, and the
        # depenetration bound on the steady separation speed kn depth / D
        kn_eff = torch.clamp(0.25 * m_red / (h * h), max=kn_cfg)
        spring = torch.clamp(kn_eff * depth, max=D_imp * max_dep)
        fn = torch.clamp(spring - D_imp * vn, min=0.0) * act
        cap = torch.where(vn > 0.0,
                          m_red * torch.clamp(max_dep - vn, min=0.0) / h + D_imp * max_dep,
                          torch.full_like(vn, float("inf")))
        fn_exp = torch.minimum(fn, cap)
        vt = vrel - n * vn[..., None]
        vt_norm = torch.sqrt(_dot(vt, vt))
        mu = torch.sqrt(params.geom_friction[:, ia] * params.geom_friction[:, ib])
        c_t = mu * fn_exp / torch.clamp(vt_norm, min=friction_vel)
        ft = vt * (-c_t)[..., None] * act[..., None]
        f_on_b = n * fn_exp[..., None] + ft
        f_ext[:, ba, 0:3] += _cross(cp - frames.pos[:, ba], -f_on_b)
        f_ext[:, ba, 3:6] -= f_on_b
        f_ext[:, bb, 0:3] += _cross(cp - frames.pos[:, bb], f_on_b)
        f_ext[:, bb, 3:6] += f_on_b
        # implicit velocity reaction, gated off while separating fast
        gate = (active & (vn < 0.5 * max_dep)).to(depth.dtype)
        M_n = (h * D_imp) * gate
        M_t = h * c_t * act
        for body in (ba, bb):
            bq = frames.quat[:, body]
            r_l = Q.rotate_inv(bq, cp - frames.pos[:, body])
            n_l = Q.rotate_inv(bq, n)
            u = torch.cat([_cross(r_l, n_l), n_l], -1)
            Mu = (M_n - M_t)[:, None] * u
            dIA[:, body] = dIA[:, body] + _G(r_l, M_t)
            dIA[:, body] = dIA[:, body] + Mu[:, :, None] * u[:, None, :]
    return f_ext, dIA, f_ext[..., 3:6].clone()


def attractor_forces(model: RobotModel, params: ModelParams, frames: BodyFrames,
                     attractors, dt: float) -> torch.Tensor:
    """World-point springs (gymapi rigid-body attractors): (B, nb, 6) world
    [torque, force]. Each attractor (body, local_p, target, kp, kd) pulls
    the body point local_p toward the world point target with gains clamped
    to the explicit stability bound of the point's effective mass (the body
    mass, or I_min / |local_p|^2 when smaller)."""
    B, h = frames.pos.shape[0], dt
    f_ext = frames.pos.new_zeros(B, model.nb, 6)
    for ab, local_p, target, kp, kd in attractors:
        bp, bq = frames.pos[:, ab], frames.quat[:, ab]
        lp = torch.tensor(local_p, dtype=bp.dtype, device=bp.device)
        wp = bp + Q.rotate(bq, lp)
        vp = frames.vel[:, ab] + _cross(frames.omega[:, ab], wp - bp)
        m_lin = params.body_mass[:, ab]
        I_min = torch.diagonal(params.body_inertia[:, ab], dim1=-2, dim2=-1).amin(-1)
        r2 = float(np.dot(np.asarray(local_p, np.float64), np.asarray(local_p, np.float64)))
        m_eff = torch.minimum(m_lin, I_min / (r2 + 1e-6)) if r2 > 1e-6 else m_lin
        kp_c = torch.clamp(0.25 * m_eff / (h * h), max=float(kp))
        kd_c = torch.clamp(0.5 * m_eff / h, max=float(kd))
        tgt = torch.tensor(target, dtype=bp.dtype, device=bp.device)
        F = (tgt - wp) * kp_c[..., None] - vp * kd_c[..., None]
        f_ext[:, ab, 0:3] += _cross(wp - bp, F)
        f_ext[:, ab, 3:6] += F
    return f_ext
