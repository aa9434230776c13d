"""Mesh utilities: vertex normals for the smooth-loss SMPL normal (port of
``mpsnerf_tpu/smpl/mesh.py``): per-face cross products, normalized,
summed into the three corner vertices, renormalized."""

from __future__ import annotations

import torch


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(V, 3) vertices + (F, 3) int64 faces -> (V, 3) unit vertex normals."""
    tris = vertices[faces]  # (F, 3, 3)
    fn = _normalize(torch.linalg.cross(tris[:, 1] - tris[:, 0],
                                       tris[:, 2] - tris[:, 0]))
    vn = torch.zeros_like(vertices)
    for k in range(3):
        vn.index_add_(0, faces[:, k], fn)
    return _normalize(vn)
