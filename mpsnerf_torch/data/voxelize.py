"""SMPL vertex voxelization (port of ``mpsnerf_tpu/data/voxelize.py``):
5 mm voxels in dhw (z, y, x) order, the grid shape rounded up to the next
multiple of 32."""

from __future__ import annotations

import numpy as np

VOXEL_SIZE = np.array([0.005, 0.005, 0.005])


def voxelize_vertices(xyz: np.ndarray, pad: float = 0.05):
    """Returns ``(feature (V,3), coord (V,3) int32 dhw, out_sh (3,) int32,
    bounds (2,3))`` for vertices in their native frame."""
    min_xyz = xyz.min(axis=0) - pad
    max_xyz = xyz.max(axis=0) + pad
    bounds = np.stack([min_xyz, max_xyz], axis=0)
    dhw = xyz[:, [2, 1, 0]]
    min_dhw = min_xyz[[2, 1, 0]]
    max_dhw = max_xyz[[2, 1, 0]]
    coord = np.round((dhw - min_dhw) / VOXEL_SIZE).astype(np.int32)
    out_sh = np.ceil((max_dhw - min_dhw) / VOXEL_SIZE).astype(np.int32)
    out_sh = (out_sh | (32 - 1)) + 1
    return xyz.astype(np.float32), coord, out_sh, bounds.astype(np.float32)
