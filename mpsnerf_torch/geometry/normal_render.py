"""Normal-map mesh rendering (port of
``mpsnerf_tpu/geometry/normal_render.py``, the ``render_thuman_mesh.py``
equivalent): the port's host rasteriser projects the mesh with the
pinhole intrinsics and interpolates per-vertex normal colours; RGB =
0.5 * normal + 0.5, a white background, alpha = coverage.  numpy and host
code only, as in the JAX package; the RGBA PNG is written by the port's
encoder (the card's machine has no OpenCV).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mpsnerf_torch.eval.protocol import encode_png
from mpsnerf_torch.native import rasterize_mesh


def _vertex_normals_np(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Host vertex normals: normalized face normals summed per vertex,
    renormalized."""
    tris = vertices[faces]
    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-8)
    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-8)
    return vn


def render_normal_map(
    verts: np.ndarray,
    tris: np.ndarray,
    K: np.ndarray,
    R: np.ndarray,
    T: np.ndarray,
    height: int = 512,
    width: int = 512,
    crop: Optional[Tuple[int, int, int, int]] = (0, 130, 512, 256),
    save_path: Optional[str] = None,
) -> np.ndarray:
    """An RGBA uint8 normal map of the mesh from camera ``(K, R, T)``,
    cropped like the reference (y, x, h, w = 0, 130, 512, 256); written
    as an RGBA PNG to ``save_path`` where given."""
    cam = verts @ R.T + T.reshape(1, 3)
    # the normals of the camera-frame mesh, as the reference computes them
    normals = _vertex_normals_np(cam.astype(np.float32), tris)
    colors = 0.5 * normals + 0.5  # (V, 3) in [0, 1]

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = cam[:, 2]
    sx = fx * cam[:, 0] / np.maximum(z, 1e-6) + cx
    sy = fy * cam[:, 1] / np.maximum(z, 1e-6) + cy
    screen = np.stack([sx, sy, z], axis=1).astype(np.float32)

    p2f, bary, _ = rasterize_mesh(screen, tris, height, width)
    hit = p2f >= 0

    img = np.ones((height, width, 3), np.float32)  # white background
    if hit.any():
        tri_cols = colors[tris[p2f[hit]]]  # (M, 3, 3)
        img[hit] = np.einsum("mk,mkc->mc", bary[hit], tri_cols)

    rgba = np.concatenate([(img * 255).astype(np.uint8),
                           (hit[..., None] * 255).astype(np.uint8)], axis=2)
    if crop is not None:
        y, x, h, w = crop
        rgba = rgba[y:y + h, x:x + w]
    if save_path is not None:
        with open(save_path, "wb") as f:
            f.write(encode_png(np.ascontiguousarray(rgba)))
    return rgba
