"""The benchmark's scene generator: a seeded synthetic subject on the SMPL
rig's layout (6890 vertices, 24 joints, SMPL's kinematic tree), cameras
on a ring, images made by splatting the posed vertices, and the items the
port and the reference both take (the port's item schema: ``img_all``,
``K_all``/``R_all``/``T_all``, ``params``, ``vertices``, ``t_vertices``,
the voxelisation fields, and per output view the ray stacks).

Numpy and plain PyTorch on the host; the skinning is the reference's
(``reference/plain.py``).  Two item kinds: a test item holds every pixel's
ray of each output view (near/far from the box of the posed vertices
5 cm out, ``mask_at_box_all`` the rays that hit it), a train item
``n_rays`` rays a view drawn from the seed, ``body_ratio`` of them on the
body's splat.  A pair item is a source item (its input views) and a target
item (its output views' rays) of two poses of one subject.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from scipy import ndimage

from benchmark.reference import plain

SMPL_PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
                17, 18, 19, 20, 21)
_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def synthetic_rig(n_verts: int = 6890, seed: int = 0) -> Dict:
    """A deterministic SMPL-like rig: joints on SMPL's tree, vertices
    around their owner joint, blend weights over the two nearest joints,
    random shape and pose blend directions and faces."""
    rng = np.random.default_rng(seed)
    joints = np.zeros((24, 3))
    for j in range(1, 24):
        step = rng.normal(size=3) * 0.12
        step[1] -= 0.08
        joints[j] = joints[SMPL_PARENTS[j]] + step
    owner = rng.integers(0, 24, size=n_verts)
    verts = joints[owner] + rng.normal(size=(n_verts, 3)) * 0.07
    j_reg = np.zeros((24, n_verts))
    for j in range(24):
        d = np.linalg.norm(verts - joints[j], axis=1)
        j_reg[j, np.argsort(d)[:32]] = 1.0 / 32.0
    d_vj = np.linalg.norm(verts[:, None] - joints[None], axis=2)
    w = np.exp(-(d_vj / 0.08) ** 2)
    mask = np.zeros_like(w)
    np.put_along_axis(mask, np.argsort(d_vj, axis=1)[:, :2], 1.0, axis=1)
    w = w * mask + 1e-6
    w = w / w.sum(1, keepdims=True)
    rig = {
        "v_template": verts, "shapedirs": rng.normal(size=(n_verts, 3, 10))
        * 0.01, "posedirs": rng.normal(size=(n_verts, 3, 207)) * 0.001,
        "J_regressor": j_reg, "weights": w,
        "faces": rng.integers(0, n_verts, size=(2 * n_verts - 4, 3)),
    }
    out = {k: v.astype(np.int64 if k == "faces" else np.float32)
           for k, v in rig.items()}
    out["parents"] = SMPL_PARENTS
    return out


def rig_tensors(rig: Dict, device) -> Dict:
    return {k: (v if k == "parents" else torch.as_tensor(v, device=device))
            for k, v in rig.items()}


def pose_params(rng: np.random.Generator) -> Dict:
    return {"poses": (rng.normal(size=72) * 0.2).astype(np.float32),
            "shapes": (rng.normal(size=10) * 0.3).astype(np.float32),
            "R": np.eye(3, dtype=np.float32),
            "Th": np.zeros((1, 3), np.float32)}


def ring_camera(i: int, n: int, size: int):
    """Camera ``i`` of ``n`` on a ring of radius 2.2 m looking at the
    origin: (K, R, T)."""
    a = 2 * np.pi * i / n
    eye = np.array([2.2 * np.cos(a), 0.1, 2.2 * np.sin(a)])
    z = -eye / np.linalg.norm(eye)
    x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    f = 0.9 * size
    K = np.array([[f, 0, size / 2.0], [0, f, size / 2.0], [0, 0, 1.0]])
    return K, R, (-R @ eye).reshape(3, 1)


def splat(verts, colors, K, R, T, size: int):
    """A z-buffered splat of the vertices, dilated 5x5 and blurred:
    (image (H, W, 3), mask (H, W))."""
    cam = verts @ R.T + T.ravel()
    uv = (cam @ K.T)[:, :2] / (cam @ K.T)[:, 2:]
    u, v = np.round(uv[:, 0]).astype(int), np.round(uv[:, 1]).astype(int)
    ok = (u >= 0) & (u < size) & (v >= 0) & (v < size) & (cam[:, 2] > 0.1)
    order = np.argsort(-cam[ok, 2])
    u, v, c = u[ok][order], v[ok][order], colors[ok][order]
    img = np.zeros((size, size, 3), np.float32)
    img[v, u] = c
    msk = np.zeros((size, size), np.float32)
    msk[v, u] = 1.0
    msk = ndimage.maximum_filter(msk, size=5, mode="nearest")
    img = ndimage.maximum_filter(img, size=(5, 5, 1), mode="nearest")
    for ax in (1, 0):
        img = ndimage.correlate1d(img, _GAUSS5, axis=ax, mode="mirror")
    img[msk == 0] = 0
    return img.astype(np.float32), msk


def camera_rays(K, R, T, size: int):
    """Every pixel's ray, row-major: (origins (H*W, 3), directions)."""
    i, j = np.meshgrid(np.arange(size, dtype=np.float64),
                       np.arange(size, dtype=np.float64), indexing="xy")
    pix = np.stack([i, j, np.ones_like(i)], -1).reshape(-1, 3)
    o = -(R.T @ T).ravel()
    d = (pix @ np.linalg.inv(K).T - T.ravel()) @ R - o
    return np.broadcast_to(o, d.shape).astype(np.float32), d.astype(np.float32)


def box_near_far(o, d, bounds):
    """Slab intersection with ``bounds`` (2, 3) 1 cm out: (near, far, hit)
    per ray (near 0, far 1 where it misses)."""
    lo, hi = bounds[0] - 0.01, bounds[1] + 0.01
    d = np.where(d == 0, 1e-8, d)
    t0, t1 = (lo - o) / d, (hi - o) / d
    near = np.minimum(t0, t1).max(1)
    far = np.maximum(t0, t1).min(1)
    hit = (far > near) & (far > 0)
    near = np.where(hit, np.maximum(near, 0), 0).astype(np.float32)
    return near, np.where(hit, far, 1).astype(np.float32), hit


def voxelize(xyz: np.ndarray):
    """5 mm voxels in (z, y, x) order, the grid rounded up to 32s:
    (feature, coord, out_sh, bounds) as the port's items hold them."""
    lo, hi = xyz.min(0) - 0.05, xyz.max(0) + 0.05
    coord = np.round((xyz[:, ::-1] - lo[::-1]) / 0.005).astype(np.int32)
    out_sh = (np.ceil((hi - lo)[::-1] / 0.005).astype(np.int32) | 31) + 1
    return (xyz.astype(np.float32), coord, out_sh,
            np.stack([lo, hi]).astype(np.float32))


class Subject:
    """A rig with its posed geometry and a camera ring of ``n_cameras``
    at ``size`` pixels."""

    def __init__(self, rig: Dict, n_cameras: int, size: int):
        self.rig, self.size = rig, size
        self.cams = [ring_camera(i, n_cameras, size) for i in range(n_cameras)]
        self._t = rig_tensors(rig, "cpu")

    def geometry(self, params: Dict):
        """(posed vertices (V, 3), canonical big-pose vertices)."""
        p = {k: torch.as_tensor(v) for k, v in params.items()}
        with torch.no_grad():
            verts = plain.posed_vertices(self._t, p).numpy()
            big = dict(p, poses=plain.big_pose("cpu"), R=torch.eye(3),
                       Th=torch.zeros(1, 3))
            can = plain.posed_vertices(self._t, big).numpy()
        return verts.astype(np.float32), can.astype(np.float32)

    def item(self, params: Dict, pose_index: int, inputs: Sequence[int],
             outputs: Sequence[int], n_rays: int = 0, body_ratio: float = 0.8,
             rng: np.random.Generator = None) -> Dict:
        """An item of pose ``params``: the input views' images, and per
        output view every pixel's ray (``n_rays`` 0) or ``n_rays`` drawn
        from ``rng``."""
        verts, can = self.geometry(params)
        colors = (can - can.min(0)) / (can.max(0) - can.min(0) + 1e-8)
        bounds = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
        views = {k: splat(verts, colors, *self.cams[k], self.size)
                 for k in sorted(set(inputs) | set(outputs))}
        stacks: Dict[str, List] = {k: [] for k in (
            "ray_o_all", "ray_d_all", "rgb_all", "near_all", "far_all",
            "mask_at_box_all", "bkgd_msk_all", "msk_all")}
        for k in outputs:
            img, msk = views[k]
            o, d = camera_rays(*self.cams[k], self.size)
            near, far, hit = box_near_far(o, d, bounds)
            rgb, body = img.reshape(-1, 3), msk.reshape(-1)
            if n_rays:
                on = np.flatnonzero(hit & (body > 0))
                off = np.flatnonzero(hit & (body == 0))
                nb = int(n_rays * body_ratio)
                sel = np.concatenate([on[rng.integers(0, len(on), nb)],
                                      off[rng.integers(0, len(off),
                                                       n_rays - nb)]])
                bk = np.concatenate([np.ones(nb), np.zeros(n_rays - nb)])
            else:
                sel, bk = np.arange(len(o)), np.ones(len(o))
            for key, val in (("ray_o_all", o[sel]), ("ray_d_all", d[sel]),
                             ("rgb_all", rgb[sel]),
                             ("near_all", near[sel, None]),
                             ("far_all", far[sel, None]),
                             ("mask_at_box_all", hit[sel]),
                             ("bkgd_msk_all", bk[:, None]),
                             ("msk_all", msk)):
                stacks[key].append(val)
        feature, coord, out_sh, vb = voxelize(verts)
        t_feature, t_coord, t_out_sh, t_vb = voxelize(can)
        item = {
            "pose_index": np.int32(pose_index), "instance_idx": np.int32(0),
            "gender": np.int32(2),
            "params": {k: v.astype(np.float32) for k, v in params.items()},
            "vertices": verts, "t_vertices": can, "feature": feature,
            "coord": coord, "out_sh": out_sh, "bounds": vb,
            "t_feature": t_feature, "t_coord": t_coord, "t_out_sh": t_out_sh,
            "t_bounds": t_vb,
            "img_all": np.stack([views[k][0].transpose(2, 0, 1)
                                 for k in inputs]),
            "K_all": np.stack([self.cams[k][0] for k in inputs]
                              ).astype(np.float32),
            "R_all": np.stack([self.cams[k][1] for k in inputs]
                              ).astype(np.float32),
            "T_all": np.stack([self.cams[k][2] for k in inputs]
                              ).astype(np.float32),
        }
        for key, vals in stacks.items():
            if not vals:
                continue
            item[key] = np.stack(vals).astype(
                bool if key == "mask_at_box_all" else np.float32)
        return item


def item_tensors(item: Dict, device) -> Dict:
    """The fields the reference reads, as fp32 tensors on ``device``."""
    keys = ("vertices", "t_vertices", "img_all", "K_all", "R_all", "T_all")
    out = {k: torch.as_tensor(np.asarray(item[k], np.float32), device=device)
           for k in keys}
    out["params"] = {k: torch.as_tensor(v, device=device)
                     for k, v in item["params"].items()}
    return out
