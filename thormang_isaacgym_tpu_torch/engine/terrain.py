"""Procedural terrain: heightfield generation (host, numpy) and the bilinear
height lookup on tensors.

Port of ``thormang_isaacgym_tpu/engine/terrain.py``. The sub-terrain
generators that :class:`TerrainGrid` uses and the grid itself are the JAX
package's numpy code, with the same ``RandomState`` call order, so a seed
gives bit-equal heights; so are the generators no grid uses (the linear
slope, stepping stones and the Perlin octaves of the reference's Gogoro
variants).

:class:`Heightfield` keeps the numpy ``heights`` and a float32 ``table``
(heights x vertical scale) on a device. ``height_fn`` and
``height_and_grad_fn`` are plain bilinear gathers with the JAX package's
conventions (``floor``, ``clip(i0, 0, H - 2)``, ``clip(f, 0, 1)``). The JAX
package's ``clustered_fn`` is not ported: it slices a per-env patch and
evaluates the surface as two matmuls because a gather inside a loop is slow
on a TPU; on a GPU the plain gather is the fast form. The two agree except
within one cell of the grid edge, where the clustered sampler clamps to its
patch and the plain one to the grid. The fused CUDA kernel samples the same
table itself (``csrc/fused_step.cu``, heightfield mode).
"""
from __future__ import annotations

import numpy as np
import torch


class Heightfield:
    """A (H, W) height grid with world-space scaling; row i is x, column j
    is y, cell (i, j) sits at origin + (i, j) * horizontal_scale."""

    def __init__(self, heights: np.ndarray, horizontal_scale: float,
                 vertical_scale: float = 1.0, origin=(0.0, 0.0), device="cpu"):
        self.heights = np.asarray(heights).astype(np.float32)
        self.h_scale = float(horizontal_scale)
        self.v_scale = float(vertical_scale)
        self.origin = np.asarray(origin, np.float32)
        self.table = torch.as_tensor(self.heights * self.v_scale, dtype=torch.float32,
                                     device=device)
        # the scale as a tensor: CUDA divides by a Python scalar as a product
        # with its reciprocal, by a tensor exactly, as the kernel does
        self._hs = torch.tensor(self.h_scale, dtype=torch.float32, device=device)

    @property
    def shape(self) -> tuple:
        return self.heights.shape

    def to(self, device) -> "Heightfield":
        """The same heightfield with its table on `device`."""
        return Heightfield(self.heights, self.h_scale, self.v_scale, self.origin, device)

    def _corners(self, x: torch.Tensor, y: torch.Tensor):
        if self.table.device != x.device:
            raise ValueError(f"heightfield table on {self.table.device}, points on "
                             f"{x.device}: move it with .to(device)")
        H, W = self.heights.shape
        gx = (x - float(self.origin[0])) / self._hs
        gy = (y - float(self.origin[1])) / self._hs
        i0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, H - 2)
        j0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, W - 2)
        fx = torch.clamp(gx - i0, 0.0, 1.0)
        fy = torch.clamp(gy - j0, 0.0, 1.0)
        flat = self.table.reshape(-1)
        k = i0 * W + j0
        return flat[k], flat[k + W], flat[k + 1], flat[k + W + 1], fx, fy

    def height_fn(self):
        """ground_height_fn(x, y) -> z, bilinear (the reference's get_heights)."""
        def fn(x, y):
            h00, h10, h01, h11, fx, fy = self._corners(x, y)
            return (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
                    + h01 * (1 - fx) * fy + h11 * fx * fy)
        return fn

    def height_and_grad_fn(self):
        """fn(x, y) -> (z, dz/dx, dz/dy): the bilinear height and the exact
        within-cell gradient of the bilinear patch."""
        def fn(x, y):
            h00, h10, h01, h11, fx, fy = self._corners(x, y)
            z = (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
                 + h01 * (1 - fx) * fy + h11 * fx * fy)
            dzdx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) / self._hs
            dzdy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / self._hs
            return z, dzdx, dzdy
        return fn


# ---------------------------------------------------------------------------
# sub-terrain generators (numpy; the JAX package's, call for call)
# ---------------------------------------------------------------------------

def random_uniform_terrain(shape, min_h, max_h, step, rng):
    levels = np.arange(min_h, max_h + step, step)
    return rng.choice(levels, size=shape).astype(np.float32)


def sloped_terrain(shape, slope):
    """Linear slope along x; slope in height units per cell."""
    i = np.arange(shape[0])[:, None]
    return np.broadcast_to(i * slope, shape).astype(np.float32)


def pyramid_sloped_terrain(shape, slope):
    """Pyramid: peak (or pit, slope < 0) at the centre."""
    H, W = shape
    i = np.abs(np.arange(H)[:, None] - H // 2)
    j = np.abs(np.arange(W)[None, :] - W // 2)
    d = np.maximum(i, j)
    return ((d.max() - d) * slope).astype(np.float32)


def pyramid_stairs_terrain(shape, step_width_cells, step_height):
    H, W = shape
    i = np.abs(np.arange(H)[:, None] - H // 2)
    j = np.abs(np.arange(W)[None, :] - W // 2)
    d = np.maximum(i, j)
    ring = (d.max() - d) // step_width_cells
    return (ring * step_height).astype(np.float32)


def discrete_obstacles_terrain(shape, max_height, min_size, max_size, num_rects, rng):
    hf = np.zeros(shape, np.float32)
    for _ in range(num_rects):
        w = rng.randint(min_size, max_size + 1)
        h = rng.randint(min_size, max_size + 1)
        i = rng.randint(0, max(1, shape[0] - w))
        j = rng.randint(0, max(1, shape[1] - h))
        hf[i:i + w, j:j + h] = rng.uniform(-max_height, max_height)
    return hf


def stepping_stones_terrain(shape, stone_size, stone_distance, max_height, depth, rng):
    hf = np.full(shape, depth, np.float32)
    pitch = stone_size + stone_distance
    for i0 in range(0, shape[0], pitch):
        for j0 in range(0, shape[1], pitch):
            hf[i0:i0 + stone_size, j0:j0 + stone_size] = rng.uniform(0, max_height)
    return hf


def perlin_terrain(shape, res=(2, 8), octaves=2, persistence=0.5, rng=None):
    """Perlin octaves (the reference's rand_perlin_2d, gogoro_new.py:764-790)."""
    rng = rng or np.random.RandomState(0)
    out = np.zeros(shape, np.float32)
    frequency, amplitude = 2, 1.0
    for _ in range(octaves):
        out += amplitude * _perlin(shape, (frequency * res[0], frequency * res[1]), rng)
        frequency *= 2
        amplitude *= persistence
    return out


def _perlin(shape, res, rng):
    d0, d1 = shape[0] // res[0], shape[1] // res[1]
    angles = 2 * np.pi * rng.rand(res[0] + 1, res[1] + 1)
    grads = np.stack([np.cos(angles), np.sin(angles)], -1)
    gy, gx = np.meshgrid(np.arange(shape[1]) / d1 % 1, np.arange(shape[0]) / d0 % 1)
    grid = np.stack([gx, gy], -1)

    def g(di, dj):
        gg = grads[di:di + res[0], dj:dj + res[1]]
        return np.repeat(np.repeat(gg, d0, 0), d1, 1)[:shape[0], :shape[1]]

    def dot(grad, sx, sy):
        return (np.stack([gx + sx, gy + sy], -1) * grad).sum(-1)

    n00 = dot(g(0, 0), 0, 0)
    n10 = dot(g(1, 0), -1, 0)
    n01 = dot(g(0, 1), 0, -1)
    n11 = dot(g(1, 1), -1, -1)
    t = 6 * grid**5 - 15 * grid**4 + 10 * grid**3
    nx0 = n00 * (1 - t[..., 0]) + n10 * t[..., 0]
    nx1 = n01 * (1 - t[..., 0]) + n11 * t[..., 0]
    return np.sqrt(2) * (nx0 * (1 - t[..., 1]) + nx1 * t[..., 1]).astype(np.float32)


class TerrainGrid:
    """Rows = difficulty (curriculum levels), columns = terrain types
    [smooth slope, rough slope, stairs up, stairs down, discrete obstacles]
    (every type past the fifth is discrete obstacles); difficulty scales
    slope and step height. Holds the
    per-(level, type) spawn origins and one stitched :class:`Heightfield`
    (on the CPU; ``.field.to(device)`` moves it)."""

    def __init__(self, num_levels=10, num_types=5, cells=80,
                 horizontal_scale=0.1, vertical_scale=1.0, border=10, seed=0):
        rng = np.random.RandomState(seed)
        self.num_levels = num_levels
        self.num_types = num_types
        self.cells = cells
        H = num_levels * cells + 2 * border
        W = num_types * cells + 2 * border
        hf = np.zeros((H, W), np.float32)
        self.env_origins = np.zeros((num_levels, num_types, 3), np.float32)
        for lev in range(num_levels):
            difficulty = (lev + 1) / num_levels
            for typ in range(num_types):
                sub = self._make(typ, difficulty, (cells, cells), horizontal_scale, rng)
                i0 = border + lev * cells
                j0 = border + typ * cells
                hf[i0:i0 + cells, j0:j0 + cells] = sub
                cx = (i0 + cells // 2) * horizontal_scale
                cy = (j0 + cells // 2) * horizontal_scale
                cz = float(sub[cells // 2, cells // 2]) * vertical_scale
                self.env_origins[lev, typ] = (cx, cy, cz)
        self.field = Heightfield(hf, horizontal_scale, vertical_scale)

    def _make(self, typ, difficulty, shape, hs, rng):
        if typ == 0:
            return pyramid_sloped_terrain(shape, slope=0.3 * difficulty * hs)
        if typ == 1:
            return (pyramid_sloped_terrain(shape, slope=0.3 * difficulty * hs)
                    + random_uniform_terrain(shape, -0.05, 0.05, 0.005, rng))
        if typ == 2:
            return pyramid_stairs_terrain(shape, max(2, int(0.31 / hs)),
                                          0.05 + 0.13 * difficulty)
        if typ == 3:
            return -pyramid_stairs_terrain(shape, max(2, int(0.31 / hs)),
                                           0.05 + 0.13 * difficulty)
        return discrete_obstacles_terrain(shape, 0.05 + difficulty * 0.1, 4, 8, 20, rng)
