"""Ray generation and the train-time ray sampler on the host (port of
``mpsnerf_tpu/rays/rays.py``: ``get_rays``, ``get_near_far``,
``project_points``, ``get_bound_2d_mask``, ``RayBatch`` and
``sample_rays_batch``; numpy, no OpenCV).

``get_bound_2d_mask`` rasterises the six faces of the projected box with
:func:`fill_poly`, a numpy/python transcription of OpenCV's ``fillPoly``
for 8-connected lines at integer vertices: each polygon's outline is drawn
with the 8-connected Bresenham line (clipped to the image as OpenCV clips
it), then its inside is filled by OpenCV's scanline walk over 16.16
fixed-point edges.  A side that leaves the image takes its edge's x from
its clipped ends, and its rows from them only where the clipped ends lie on
two rows, as OpenCV does.  The tests hold it equal to ``cv2.fillPoly`` for
convex polygons, for the projected faces of boxes in front of the camera
and for random (also self-intersecting) polygons that leave the image.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


# ---- OpenCV's fillPoly (8-connected lines, shift 0) -----------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _trunc_div(a: float, b: float) -> int:
    """C's ``(int64)(double / double)``: the quotient truncated to zero."""
    return int(a / b)


def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's ``clipLine``: ``(inside, p1, p2)`` with the endpoints moved
    onto the image's border (moved even when the line misses it)."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _trunc_div(float(a - y1) * (x2 - x1), y2 - y1)
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _trunc_div(float(a - y2) * (x2 - x1), y2 - y1)
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _trunc_div(float(a - x1) * (y2 - y1), x2 - x1)
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _trunc_div(float(a - x2) * (y2 - y1), x2 - x1)
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _outside(w: int, h: int, *pts) -> bool:
    return any(not (0 <= x < w and 0 <= y < h) for x, y in pts)


def _draw_line(mask: np.ndarray, p1, p2, color) -> None:
    """OpenCV's 8-connected ``Line`` (its ``LineIterator``, left to
    right), clipped to the image first."""
    h, w = mask.shape[:2]
    if _outside(w, h, p1, p2):
        inside, p1, p2 = _clip_line(w, h, p1, p2)
        if not inside:
            return
    (x, y), (x2, y2) = p1, p2
    dx, dy = x2 - x, y2 - y
    if dx < 0:  # left to right: start from the other end
        dx, dy, x, y = -dx, -dy, x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    if dy > dx:  # y is the major axis, x the minor
        dx, dy = dy, dx
        major, minor = (0, sy), (1, 0)
    else:
        major, minor = (1, 0), (0, sy)
    err = dx - 2 * dy
    for _ in range(dx + 1):
        mask[y, x] = color
        if err < 0:
            err += 2 * dx - 2 * dy
            x, y = x + major[0] + minor[0], y + major[1] + minor[1]
        else:
            err -= 2 * dy
            x, y = x + major[0], y + major[1]


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0, y1, x, dx):
        self.y0, self.y1, self.x, self.dx = y0, y1, x, dx
        self.next = None


def _collect_edges(mask: np.ndarray, pts, color, edges) -> None:
    """OpenCV's ``CollectPolyEdges`` at shift 0: draw every side with
    :func:`_draw_line` and collect the non-horizontal ones as 16.16
    fixed-point edges (a side that leaves the image starts from its
    clipped ends)."""
    h, w = mask.shape[:2]
    x0, y0 = (int(c) for c in pts[-1])
    for p in pts:
        x1, y1 = int(p[0]), int(p[1])
        _draw_line(mask, (x0, y0), (x1, y1), color)
        c0 = [x0 << _XY_SHIFT, y0]
        c1 = [x1 << _XY_SHIFT, y1]
        if _outside(w, h, (x0, y0), (x1, y1)):
            # the clipped ends give the edge's x always, its y only when
            # they differ: a side that touches the image in one point (or
            # misses it) keeps its rows but runs at the clipped x
            _, t0, t1 = _clip_line(w, h, (x0, y0), (x1, y1))
            if t0[1] != t1[1]:
                c0[1], c1[1] = t0[1], t1[1]
            c0[0], c1[0] = t0[0] << _XY_SHIFT, t1[0] << _XY_SHIFT
        if y0 != y1:
            num, den = c1[0] - c0[0], c1[1] - c0[1]
            dxe = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)
            if y0 < y1:
                edges.append(_Edge(y0, y1, c0[0] + (y0 - c0[1]) * dxe, dxe))
            else:
                edges.append(_Edge(y1, y0, c1[0] + (y1 - c1[1]) * dxe, dxe))
        x0, y0 = x1, y1


def _fill_edges(mask: np.ndarray, edges, color) -> None:
    """OpenCV's ``FillEdgeCollection``: walk the scanlines with an active
    edge list and fill between consecutive pairs of edges."""
    h, w = mask.shape[:2]
    if len(edges) < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    xs = [e.x for e in edges] + [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << _XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    total = len(edges)
    edges.append(_Edge(1 << 62, 0, 0, 0))  # sentinel
    head = _Edge(0, 0, 0, 0)
    i = 0
    e = edges[0]
    for y in range(e.y0, min(y_max, h)):
        draw = False
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last = last.next  # the edge ends here
                continue
            keep = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:  # the next edge starts on this scanline
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    lo, hi = sorted((keep.x, prelast.x))
                    # the span's pixels: ceil of the left x, floor of the right
                    x1 = (lo + _XY_ONE - 1) >> _XY_SHIFT
                    x2 = hi >> _XY_SHIFT
                    if x1 < w and x2 >= 0:
                        mask[y, max(x1, 0):min(x2, w - 1) + 1] = color
                keep.x += keep.dx
                prelast.x += prelast.dx
            draw = not draw
        # keep the active list sorted by x (stable, as OpenCV's bubble sort)
        active = []
        node = head.next
        while node is not None:
            active.append(node)
            node = node.next
        active.sort(key=lambda a: a.x)
        head.next = None
        for a in reversed(active):
            a.next, head.next = head.next, a


def fill_poly(mask: np.ndarray, polys, color=1) -> np.ndarray:
    """``cv2.fillPoly(mask, polys, color)`` for integer vertices with the
    default 8-connected line type: fills ``mask`` in place and returns it."""
    edges = []
    for pts in polys:
        _collect_edges(mask, np.asarray(pts).reshape(-1, 2), color, edges)
    _fill_edges(mask, edges, color)
    return mask


def _bound_corners(bounds: np.ndarray) -> np.ndarray:
    min_x, min_y, min_z = bounds[0]
    max_x, max_y, max_z = bounds[1]
    return np.array(
        [
            [min_x, min_y, min_z], [min_x, min_y, max_z],
            [min_x, max_y, min_z], [min_x, max_y, max_z],
            [max_x, min_y, min_z], [max_x, min_y, max_z],
            [max_x, max_y, min_z], [max_x, max_y, max_z],
        ]
    )


def project_points(xyz: np.ndarray, K: np.ndarray, R: np.ndarray,
                   T: np.ndarray):
    """World points -> pixel coords."""
    cam = xyz @ R.T + T.reshape(1, 3)
    pix = cam @ K.T
    return pix[:, :2] / pix[:, 2:]


def get_bound_2d_mask(bounds, K, pose, H, W) -> np.ndarray:
    """Rasterize the projected 3D bounding box's six faces into an (H, W)
    uint8 mask, one :func:`fill_poly` per face as the JAX package calls
    ``cv2.fillPoly``."""
    corners_3d = _bound_corners(bounds)
    R, T = pose[:, :3], pose[:, 3:]
    corners_2d = np.round(project_points(corners_3d, K, R, T)).astype(int)
    mask = np.zeros((H, W), dtype=np.uint8)
    for face in ([0, 1, 3, 2, 0], [4, 5, 7, 6, 5], [0, 1, 5, 4, 0],
                 [2, 3, 7, 6, 2], [0, 2, 6, 4, 0], [1, 3, 7, 5, 1]):
        fill_poly(mask, [corners_2d[face]], 1)
    return mask


class RayBatch(NamedTuple):
    """Fixed-shape per-view ray bundle (the device-facing schema)."""

    rgb: np.ndarray          # (N, 3)
    ray_o: np.ndarray        # (N, 3)
    ray_d: np.ndarray        # (N, 3)
    near: np.ndarray         # (N,)
    far: np.ndarray          # (N,)
    coord: np.ndarray        # (N, 2) pixel coords (train) / zeros (test)
    mask_at_box: np.ndarray  # (N,) bool (train: all True)
    bkgd_msk: np.ndarray     # (N, 1) 1=body pixel, 0=background


def sample_rays_batch(
    img: np.ndarray,
    msk: np.ndarray,
    K: np.ndarray,
    R: np.ndarray,
    T: np.ndarray,
    bounds: np.ndarray,
    n_rays: int,
    split: str,
    body_ratio: float = 0.8,
    rng: Optional[np.random.Generator] = None,
) -> RayBatch:
    """Train: body/background importance sampling inside the projected box,
    resampled until exactly ``n_rays`` rays hit the box; the draws come
    from ``rng`` in the JAX package's order, so one seed gives the same
    rays.  Test: every pixel, near/far scattered into full-image arrays."""
    if rng is None:
        rng = np.random.default_rng()
    H, W = img.shape[:2]
    ray_o, ray_d = get_rays(H, W, K, R, T)
    pose = np.concatenate([R, T.reshape(3, 1)], axis=1)
    bound_mask = get_bound_2d_mask(bounds, K, pose, H, W)

    msk = msk * bound_mask
    bound_mask = bound_mask.copy()
    bound_mask[msk == 100] = 0
    img = img.copy()
    img[bound_mask != 1] = 0

    if split != "train":
        o, d, near, far, hit = full_image_rays(ray_o, ray_d, bounds)
        return RayBatch(
            rgb=img.reshape(-1, 3).astype(np.float32), ray_o=o, ray_d=d,
            near=near.astype(np.float32), far=far.astype(np.float32),
            coord=np.zeros((len(o), 2), np.int64), mask_at_box=hit,
            bkgd_msk=np.ones((len(o), 1), np.float32),
        )

    lists = {k: [] for k in RayBatch._fields}
    n_sampled = 0
    coord_body = np.argwhere(msk == 1)
    coord_bg = np.argwhere((bound_mask == 1) & (msk != 1))
    # degenerate masks: fall back to any in-box pixel
    if len(coord_body) == 0:
        coord_body = np.argwhere(bound_mask == 1)
    if len(coord_bg) == 0:
        coord_bg = coord_body

    while n_sampled < n_rays:
        n_body = int((n_rays - n_sampled) * body_ratio)
        n_rand = (n_rays - n_sampled) - n_body
        cb = coord_body[rng.integers(0, len(coord_body), n_body)]
        cg = coord_bg[rng.integers(0, len(coord_bg), n_rand)]
        coord = np.concatenate([cb, cg], axis=0)
        bkgd = np.concatenate(
            [np.ones((n_body, 1)), np.zeros((n_rand, 1))], axis=0)

        o = ray_o[coord[:, 0], coord[:, 1]]
        d = ray_d[coord[:, 0], coord[:, 1]]
        rgb = img[coord[:, 0], coord[:, 1]]
        near, far, hit = get_near_far(bounds, o, d)

        lists["ray_o"].append(o[hit])
        lists["ray_d"].append(d[hit])
        lists["rgb"].append(rgb[hit])
        lists["near"].append(near)
        lists["far"].append(far)
        lists["coord"].append(coord[hit])
        lists["bkgd_msk"].append(bkgd[hit])
        lists["mask_at_box"].append(hit[hit])
        n_sampled += len(near)

    out = {k: np.concatenate(v)[:n_rays] for k, v in lists.items()}
    return RayBatch(
        rgb=out["rgb"].astype(np.float32),
        ray_o=out["ray_o"].astype(np.float32),
        ray_d=out["ray_d"].astype(np.float32),
        near=out["near"].astype(np.float32),
        far=out["far"].astype(np.float32),
        coord=out["coord"].astype(np.int64),
        mask_at_box=out["mask_at_box"],
        bkgd_msk=out["bkgd_msk"].astype(np.float32),
    )
