"""Tree level-scheduling for the plain dynamics sweeps.

Port of ``thormang_isaacgym_tpu/ops/levels.py``. The three ABA sweeps are
sequential in tree depth, not in body count: every joint at one depth is
independent, so the plain version processes one depth level per batched op.
Bodies are depth-major (the compilers sort them), so each level is a
contiguous index range whose parents all lie in the previous level.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from benchmark.reference.port.models.robot import REVOLUTE, RobotModel


@lru_cache(maxsize=64)
def body_levels(model: RobotModel):
    """(levels, depth): levels is a tuple of int32 arrays of body indices
    (depth >= 1) grouped by depth, shallow first."""
    nb = model.nb
    parent = model.parent
    depth = np.zeros(nb, np.int32)
    for i in range(nb):
        if parent[i] >= 0:
            depth[i] = depth[parent[i]] + 1
    levels = []
    for d in range(1, depth.max() + 1 if nb > 1 else 1):
        idx = np.nonzero(depth == d)[0].astype(np.int32)
        if idx.size:
            levels.append(idx)
    return tuple(levels), depth


@lru_cache(maxsize=64)
def level_structure(model: RobotModel):
    """Per-level dicts {start, end, parent_local}: the body range [start, end)
    and each body's parent position within the previous level's range.
    Level 0 of the list is depth 1 (children of the roots)."""
    levels, _ = body_levels(model)
    parent = np.array(model.parent, np.int32)
    out = []
    prev_start, prev_end = 0, model.n_roots
    for L in levels:
        start, end = int(L.min()), int(L.max()) + 1
        if not np.array_equal(L, np.arange(start, end)):
            raise ValueError("bodies are not depth-contiguous; recompile the model")
        p = parent[L]
        if not ((p >= prev_start).all() and (p < prev_end).all()):
            raise ValueError("a parent lies outside the previous depth level")
        out.append(dict(start=start, end=end,
                        parent_local=(p - prev_start).astype(np.int64)))
        prev_start, prev_end = start, end
    return out


@lru_cache(maxsize=64)
def static_arrays(model: RobotModel):
    """(parent, axis (nj,3), is_rev (nj,1), S (nj,6)): the joint motion
    subspace S is angular for revolute joints, linear for prismatic ones."""
    parent = np.array(model.parent, np.int32)
    axis = np.array(model.joint_axis, np.float32).reshape(-1, 3)
    jtype = np.array(model.joint_type, np.int32)
    is_rev = (jtype == REVOLUTE).astype(np.float32)[:, None]
    S = np.concatenate([axis * is_rev, axis * (1.0 - is_rev)], axis=1).astype(np.float32)
    return parent, axis, is_rev, S
