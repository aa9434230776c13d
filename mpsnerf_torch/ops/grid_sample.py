"""Bilinear patch sampling of image / feature maps at continuous
coordinates (forward of ``mpsnerf_tpu/ops/grid_sample.py``'s
``grid_sample_2d_patch`` and ``index_features_patch``).

align_corners=True with border replication: the 2x2 patch start is
clipped to ``w - 2`` / ``h - 2`` and the bilinear weight recomputed against
the clipped start and clamped to [0, 1], which equals sampling the four
corners with clamped indices.  Plain torch indexing for now; its CUDA
forward and twice-differentiable backward come with the training slice.
"""

from __future__ import annotations

import torch


def grid_sample_2d_patch(image: torch.Tensor, coords: torch.Tensor):
    """Sample ``image`` (V, C, H, W) at normalized coords (V, N, 2) in
    [-1, 1] (x along the width first).  Returns (V, C, N)."""
    v, c, h, w = image.shape
    ix = (coords[..., 0] + 1.0) * 0.5 * (w - 1)  # (V, N)
    iy = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(ix).clamp(0, w - 2)
    y0 = torch.floor(iy).clamp(0, h - 2)
    wx = torch.clamp(ix - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(iy - y0, 0.0, 1.0)[..., None]

    flat = image.permute(0, 2, 3, 1).reshape(v, h * w, c)
    lin = y0.long() * w + x0.long()  # (V, N)

    def corner(offset):
        idx = (lin + offset)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx)  # (V, N, C)

    out = (
        corner(0) * ((1 - wx) * (1 - wy))
        + corner(1) * (wx * (1 - wy))
        + corner(w) * ((1 - wx) * wy)
        + corner(w + 1) * (wx * wy)
    )
    return out.permute(0, 2, 1)  # (V, C, N)


def index_features_patch(latent: torch.Tensor, uv: torch.Tensor, image_size):
    """Pixel-aligned feature lookup: ``uv`` (V, N, 2) are pixel coords of
    the full image of size ``image_size`` = (W, H); they are normalised
    against it, then sampled with align_corners against the (smaller)
    latent resolution."""
    size = torch.as_tensor(image_size, dtype=uv.dtype, device=uv.device)
    return grid_sample_2d_patch(latent, 2.0 * uv / size - 1.0)
