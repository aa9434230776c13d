"""Conservative body-occupancy grid: O(1) per-point candidate test for the
5 cm human-region mask (port of ``mpsnerf_tpu/ops/body_grid.py``).

A voxel is marked iff some point inside it could lie within 5 cm of some
vertex, so ``grid[q] == 0`` proves q is farther than 5 cm and only marked
points go to the exact 1-NN.  The grid is built on the host in numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

HUMAN_DIST_THRESHOLD = 0.05  # 5 cm


class BodyGrid(NamedTuple):
    grid: np.ndarray     # (D, H, W) uint8 candidate flags (z, y, x order)
    origin: np.ndarray   # (3,) xyz of the (0, 0, 0) voxel corner
    voxel: np.ndarray    # () voxel edge length


def build_body_grid(
    verts: np.ndarray,
    voxel: float = 0.02,
    threshold: float = HUMAN_DIST_THRESHOLD,
    pad_to: int = 128,
) -> BodyGrid:
    """verts: (V, 3) in the frame the query points use (SMPL frame).  The
    grid is padded to ``pad_to`` per dim (bodies that do not fit round
    up to multiples of 32)."""
    verts = np.asarray(verts, np.float32)
    half_diag = 0.5 * np.sqrt(3.0) * voxel
    reach = threshold + half_diag

    lo = verts.min(0) - reach - voxel
    hi = verts.max(0) + reach + voxel
    shape = np.ceil((hi - lo) / voxel).astype(int) + 1
    if (shape <= pad_to).all():
        shape = np.full(3, pad_to, int)
    else:
        shape = (shape + 31) // 32 * 32

    # ball stencil of voxel offsets within `reach` of a vertex, tested
    # per cell against the vertex itself for tightness
    r = int(np.ceil(reach / voxel))
    ax = np.arange(-r, r + 1)
    oz, oy, ox = np.meshgrid(ax, ax, ax, indexing="ij")
    offs = np.stack([oz, oy, ox], -1).reshape(-1, 3)

    cell = np.floor((verts - lo) / voxel).astype(int)  # xyz order
    centers_rel = (cell + 0.5) * voxel + lo - verts

    grid = np.zeros(tuple(shape[[2, 1, 0]]), np.uint8)  # (z, y, x)
    off_xyz = offs[:, [2, 1, 0]]
    for chunk in range(0, len(offs), 256):
        o = off_xyz[chunk : chunk + 256]
        d = centers_rel[:, None, :] + o[None, :, :] * voxel
        ok = (d * d).sum(-1) <= reach * reach
        vi, ki = np.nonzero(ok)
        grid[cell[vi, 2] + o[ki, 2], cell[vi, 1] + o[ki, 1],
             cell[vi, 0] + o[ki, 0]] = 1
    return BodyGrid(grid=grid, origin=lo.astype(np.float32),
                    voxel=np.float32(voxel))


def grid_to(grid: BodyGrid, device) -> BodyGrid:
    """The grid's arrays as tensors on ``device``."""
    return BodyGrid(*(torch.as_tensor(np.array(x), device=device)
                      for x in grid))


def grid_lookup(grid: BodyGrid, pts: torch.Tensor) -> torch.Tensor:
    """Candidate test: (N, 3) xyz -> (N,) bool."""
    flags = torch.as_tensor(grid.grid, device=pts.device)
    origin = torch.as_tensor(grid.origin, device=pts.device)
    voxel = torch.as_tensor(grid.voxel, device=pts.device)
    idx = torch.floor((pts - origin) / voxel).to(torch.int64)
    d, h, w = flags.shape
    inside = (
        (idx[:, 0] >= 0) & (idx[:, 0] < w)
        & (idx[:, 1] >= 0) & (idx[:, 1] < h)
        & (idx[:, 2] >= 0) & (idx[:, 2] < d)
    )
    xi = idx[:, 0].clamp(0, w - 1)
    yi = idx[:, 1].clamp(0, h - 1)
    zi = idx[:, 2].clamp(0, d - 1)
    lin = (zi * h + yi) * w + xi
    return (flags.reshape(-1)[lin] > 0) & inside
