"""Heightfield terrain: the bilinear height lookup on tensors.

Port of ``thormang_isaacgym_tpu/engine/terrain.py``, cut to the
:class:`Heightfield` type that ``ops/sim.py`` reads; the benchmark's cells
run on flat ground and the hand, so the generators are left out.

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
