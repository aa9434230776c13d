"""Host data for the port: the synthetic scene, voxelization, the body
grid, and the move of an item's arrays to the device."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
from mpsnerf_torch.data.voxelize import voxelize_vertices
from mpsnerf_torch.ops.body_grid import BodyGrid, build_body_grid, grid_to

# per-view ray and image stacks: read on the host by the view renderer
# (sliced per view); the trainer takes the ray stacks to the device
RAY_KEYS = ("ray_o_all", "ray_d_all", "rgb_all", "near_all", "far_all",
            "bkgd_msk_all")
HOST_ONLY_KEYS = RAY_KEYS + (
    "msk_all", "mask_at_box_all", "msk_cihp_all", "o_img_all",
)


def attach_body_grid(item: Dict, voxel: float = 0.02) -> Dict:
    """Add the conservative body-occupancy grid, built from the SMPL-frame
    vertices (the ``feature`` field)."""
    item["body_grid"] = build_body_grid(item["feature"], voxel=voxel)
    return item


def to_device_input(item: Dict, device="cuda", rays: bool = False) -> Dict:
    """Host item -> tensors on ``device`` (nested params and the body grid
    included; host-only stacks and ``_``-prefixed caches skipped, except
    the per-view ray stacks when ``rays``, as the trainer reads them)."""
    out = {}
    for k, v in item.items():
        if k.startswith("_") or (k in HOST_ONLY_KEYS
                                 and not (rays and k in RAY_KEYS)):
            continue
        if isinstance(v, BodyGrid):
            out[k] = grid_to(v, device)
        elif isinstance(v, dict):
            out[k] = {kk: torch.as_tensor(np.array(vv), device=device)
                      for kk, vv in v.items()}
        else:
            out[k] = torch.as_tensor(np.array(v), device=device)
    return out


__all__ = ["SyntheticHumanDataset", "voxelize_vertices", "attach_body_grid",
           "to_device_input"]
