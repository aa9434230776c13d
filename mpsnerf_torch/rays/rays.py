"""Ray generation on the host (port of ``get_rays`` and ``get_near_far``
from ``mpsnerf_tpu/rays/rays.py``; numpy, no OpenCV)."""

from __future__ import annotations

import numpy as np


def get_rays(H: int, W: int, K: np.ndarray, R: np.ndarray, T: np.ndarray):
    """Pinhole rays in world space: ``(rays_o (H,W,3), rays_d (H,W,3))``,
    rays_d not normalized."""
    rays_o = -(R.T @ T).ravel()
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = xy1 @ np.linalg.inv(K).T
    pixel_world = (pixel_camera - T.ravel()) @ R
    rays_d = pixel_world - rays_o[None, None]
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def get_near_far(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray):
    """Near/far from the intersection with the AABB ``bounds`` (2, 3)
    padded by 1 cm.  Returns ``(near (M,), far (M,), mask_at_box (N,))``;
    a ray is inside only if it hits exactly two of the six box planes
    within the box (the reference's test, operation for operation)."""
    box = bounds + np.array([-0.01, 0.01])[:, None]
    d = ray_d.copy()
    d[d == 0.0] = 1e-8

    t_planes = ((box[None] - ray_o[:, None]) / d[:, None]).reshape(-1, 6)
    hit_pts = t_planes[..., None] * d[:, None] + ray_o[:, None]  # (N, 6, 3)

    eps = 1e-6
    lo, hi = box[0] - eps, box[1] + eps
    on_face = np.ones(hit_pts.shape[:2], dtype=bool)
    for ax in range(3):
        on_face &= (hit_pts[..., ax] >= lo[ax]) & (hit_pts[..., ax] <= hi[ax])

    mask_at_box = on_face.sum(-1) == 2
    entry_exit = hit_pts[mask_at_box][on_face[mask_at_box]].reshape(-1, 2, 3)
    o_in = ray_o[mask_at_box]
    d_len = np.linalg.norm(d[mask_at_box], axis=1)
    t0 = np.linalg.norm(entry_exit[:, 0] - o_in, axis=1) / d_len
    t1 = np.linalg.norm(entry_exit[:, 1] - o_in, axis=1) / d_len
    return np.minimum(t0, t1), np.maximum(t0, t1), mask_at_box


def full_image_rays(ray_o: np.ndarray, ray_d: np.ndarray, bounds: np.ndarray):
    """Every pixel's ray with near/far scattered into full-image arrays
    (near 0, far 1 where the box is missed).  Returns
    ``(ray_o (N,3), ray_d (N,3), near (N,), far (N,), mask_at_box (N,))``."""
    o = ray_o.reshape(-1, 3).astype(np.float32)
    d = ray_d.reshape(-1, 3).astype(np.float32)
    near, far, hit = get_near_far(bounds, o, d)
    near_all = np.zeros_like(o[:, 0])
    far_all = np.ones_like(o[:, 0])
    near_all[hit] = near
    far_all[hit] = far
    return o, d, near_all, far_all, hit
