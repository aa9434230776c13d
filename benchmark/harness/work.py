"""The yardstick's arithmetic: the card's peaks, the bytes and operations
of the port's two hand-written kernels per launch, and the model's
products per view and per train step.

The kernels' counts are frozen copies of ``chip_smoke.py``'s (``_bound``,
``_bwd_work``, ``_bwd2_work`` and K1's bytes), with one change: an image
or image gradient counts the pixels the launch's coordinates touch (the
four corners of each sample), not the whole image, since that is what
these inputs need and a launch that touches a small part of a large image
would otherwise read above its roofline.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
FLOPS_FP32 = 67e12     # fp32 outside the tensor cores (an FMA counts 2)
HBM_BYTES_S = 3.35e12  # HBM3
F32 = 4


def bound_s(nbytes: float, ops: float) -> float:
    """The least time: bytes over the HBM rate or operations over the fp32
    rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_S, ops / FLOPS_FP32)


# ---- K1: nearest vertex ------------------------------------------------------

K1_PAIR_OPS = 8  # three differences, three squares summed, one compare


def k1_work(n: int, nv: int):
    """One search launch of ``n`` queries over ``nv`` vertices: each query
    (12 B) and vertex (12 B) read once, each distance (4 B) and id (8 B)
    written once, one pair evaluated per query."""
    return n * 12 + nv * 12 + n * 8 + n * 4, n * K1_PAIR_OPS


# ---- K2: bilinear patch sampling ---------------------------------------------

def touched_pixels(coords: torch.Tensor, h: int, w: int) -> int:
    """Distinct pixels that the four corners of each sample at coords
    (V, N, 2) in [-1, 1] touch, summed over the views."""
    ix = (coords[..., 0].float() + 1.0) * 0.5 * (w - 1)
    iy = (coords[..., 1].float() + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(ix).clamp(0, max(w - 2, 0)).long()
    y0 = torch.floor(iy).clamp(0, max(h - 2, 0)).long()
    view = torch.arange(x0.shape[0], device=x0.device)[:, None] * (h * w)
    keys = [((y0 + dy).clamp(max=h - 1) * w + (x0 + dx).clamp(max=w - 1)
             + view).reshape(-1) for dx, dy in ((0, 0), (1, 0), (0, 1),
                                                (1, 1))]
    return int(torch.unique(torch.cat(keys)).numel())


def k2_fwd_work(v, c, n, touched):
    """Forward: the touched pixels read, coords read, (V, C, N) written;
    four multiply-adds a channel."""
    return F32 * (touched * c + v * n * 2 + v * c * n), 8 * v * c * n


def k2_bwd_work(v, c, n, touched, need):
    """Backward with flags ``need`` = (image, coords): ``_bwd_work`` with
    the image's bytes at the touched pixels."""
    need_image, need_coords = need
    img_b, pts_b, vcn = F32 * touched * c, F32 * v * n * 2, F32 * v * c * n
    nbytes = vcn + pts_b + (img_b if need_image else 0) \
        + ((img_b + pts_b) if need_coords else 0)
    ops = v * c * n * ((8 if need_image else 0) + (20 if need_coords else 0))
    return nbytes, ops


def k2_bwd2_work(v, c, n, touched, gg_image, gg_coords, need):
    """Double backward: ``_bwd2_work`` with images at the touched
    pixels."""
    need_g, need_i, need_c = need
    need_i = need_i and gg_coords
    img_b, pts_b, vcn = F32 * touched * c, F32 * v * n * 2, F32 * v * c * n
    reads_corners = need_g or need_c
    nbytes = pts_b + (vcn if need_i or need_c else 0) \
        + (img_b if gg_coords and reads_corners else 0) \
        + (img_b if gg_image and reads_corners else 0) \
        + (pts_b if gg_coords else 0) + (vcn if need_g else 0) \
        + (img_b if need_i else 0) + (pts_b if need_c else 0)
    ops = v * c * n * ((7 if gg_image and need_g else 0)
                       + (17 if gg_coords and need_g else 0)
                       + (8 if need_i else 0)
                       + (18 if gg_image and need_c else 0)
                       + (5 if gg_coords and need_c else 0))
    return nbytes, ops


# ---- the model's products ----------------------------------------------------

def mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def encoder_flops(views: int, h: int, w: int, blocks: int = 3) -> int:
    """ResNet-34's 7x7 stem (3 -> 64, stride 2, on the 2x2-averaged image)
    and ``blocks`` basic blocks of two 3x3 64 -> 64 convolutions, all at
    a quarter of the image's side."""
    hw = (h // 4) * (w // 4)
    return views * (mm(hw, 3 * 49, 64) + 2 * blocks * mm(hw, 64 * 9, 64))


def point_flops(m: Dict) -> int:
    """Products of the transformer and the NeRF MLP for one sample.
    ``m``: views, latent, rgb_freqs, heads, dim_head, ff, depth,
    out_views (the rows the last layer must give), width, nerf_depth,
    skips, pts_freqs, views_width."""
    v, dim = m["views"], m["latent"] + 3 + 6 * m["rgb_freqs"]
    inner = m["heads"] * m["dim_head"]
    f = 0
    for layer in range(m["depth"]):
        rows = m["out_views"] if layer == m["depth"] - 1 else v
        f += mm(v, dim, 2 * inner) + mm(rows, dim, inner)   # k, v; q
        f += 2 * m["heads"] * rows * v * m["dim_head"] * 2  # logits, mix
        f += mm(rows, inner, dim)                           # to_out
        f += mm(rows, dim, m["ff"]) + mm(rows, m["ff"], dim)
    x = 3 + 6 * m["pts_freqs"] + dim
    w = m["width"]
    widths = [x] + [w + (x if i in m["skips"] else 0)
                    for i in range(m["nerf_depth"])]
    f += sum(mm(1, widths[i], w) for i in range(m["nerf_depth"]))
    f += mm(1, widths[-1], 1) + mm(1, widths[-1], w)
    f += mm(1, w + dim, m["views_width"]) + mm(1, m["views_width"], 3)
    return f


# the reverse pass of a product costs twice its forward (d input, d weight);
# a query with the occupancy normal runs the forward, the normal (d input
# only: one more forward's worth) and the reverse of both (2 + 2)
PLAIN_FACTOR = 3
NORMAL_FACTOR = 6


def train_step_flops(enc: int, per_point: int,
                     queries: Sequence[Sequence]) -> int:
    """One optimizer step: the encoder forward and backward, and per query
    (in-body points, with the normal or not) its factor of the per-point
    forward."""
    f = PLAIN_FACTOR * enc
    for n_body, normals in queries:
        f += (NORMAL_FACTOR if normals else PLAIN_FACTOR) * per_point * n_body
    return f
