"""Procedural multi-view human scene (port of
``mpsnerf_tpu/data/synthetic.py``, without OpenCV and without jax).

The item schema is the JAX package's: a synthetic SMPL subject, cameras on
a ring, images made by splatting the posed vertices coloured by their
canonical position, masks from the splat footprint, and each output view's
rays from ``rays.sample_rays_batch``: ``n_rays`` body/background-sampled
rays in the train split (drawn from the dataset's seeded numpy generator
in the JAX package's order, so one seed gives the same rays), every
pixel's ray in the test split.  OpenCV's ``dilate`` (5x5 ones) and
``GaussianBlur((5, 5), 0)`` (the fixed [1, 4, 6, 4, 1] / 16 kernel,
reflect-101 border) are redone with scipy.  The default split is "test"
(the serving path's); the JAX package defaults to "train".
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from scipy import ndimage

from mpsnerf_torch.data.voxelize import voxelize_vertices
from mpsnerf_torch.rays.rays import RayBatch, sample_rays_batch
from mpsnerf_torch.smpl.kinematics import big_pose_vector
from mpsnerf_torch.smpl.lbs import posed_vertices
from mpsnerf_torch.smpl.model import SMPLModel, synthetic_smpl

_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _ring_camera(angle: float, radius: float, height: float, H: int, W: int):
    """Look-at camera on a ring around the origin; returns (K, R, T)."""
    eye = np.array([radius * np.cos(angle), height, radius * np.sin(angle)])
    z = -eye / np.linalg.norm(eye)
    x = np.cross(z, np.array([0.0, 1.0, 0.0]))
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)  # world -> cam rows
    T = (-R @ eye).reshape(3, 1)
    f = 0.9 * max(H, W)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    return K, R, T


def dilate5(img: np.ndarray) -> np.ndarray:
    """``cv2.dilate(img, np.ones((5, 5)))``: a 5x5 max over each channel
    (replicating the edge equals OpenCV's ignore-the-border default)."""
    size = (5, 5) + (1,) * (img.ndim - 2)
    return ndimage.maximum_filter(img, size=size, mode="nearest")


def gaussian_blur5(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (5, 5), 0)`` on float32 images."""
    out = ndimage.correlate1d(img, _GAUSS5, axis=1, mode="mirror")
    return ndimage.correlate1d(out, _GAUSS5, axis=0, mode="mirror")


def _splat_image(verts_world, colors, K, R, T, H: int, W: int):
    """Z-buffered point splat + blur: a consistent 'photo' of the body."""
    cam = verts_world @ R.T + T.ravel()
    z = cam[:, 2]
    pix = cam @ K.T
    uv = pix[:, :2] / pix[:, 2:]
    u = np.round(uv[:, 0]).astype(int)
    v = np.round(uv[:, 1]).astype(int)
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0.1)
    order = np.argsort(-z[ok])  # far -> near so near wins
    u, v, c = u[ok][order], v[ok][order], colors[ok][order]

    img = np.zeros((H, W, 3), np.float32)
    img[v, u] = c
    msk = np.zeros((H, W), np.float32)
    msk[v, u] = 1.0
    msk = dilate5(msk)
    img = gaussian_blur5(dilate5(img)).astype(np.float32)
    img[msk == 0] = 0
    return img, msk


class SyntheticHumanDataset:
    """Multi-pose, multi-view synthetic subject(s) with the sp/tp item
    schema."""

    def __init__(
        self,
        n_poses: int = 2,
        n_cameras: int = 6,
        input_views: Optional[List[int]] = None,
        image_size: int = 128,
        n_verts: int = 6890,
        num_instances: int = 1,
        seed: int = 0,
        split: str = "test",
        n_rays: int = 256,
    ):
        self.H = self.W = image_size
        self.split = split
        self.n_rays = n_rays
        self.n_poses = n_poses
        self.num_instances = num_instances
        self.input_view = input_views or list(range(min(3, n_cameras)))
        self.output_view = list(range(n_cameras))
        self.train_view = self.output_view
        self.rng = np.random.default_rng(seed)

        self.subjects = []
        for inst in range(num_instances):
            smpl = synthetic_smpl(n_verts=n_verts, seed=seed + inst,
                                  device="cpu")
            poses = []
            for p in range(n_poses):
                prng = np.random.default_rng(1000 * inst + p)
                poses.append({
                    "poses": (prng.normal(size=72) * 0.2).astype(np.float32),
                    "shapes": (prng.normal(size=10) * 0.3).astype(np.float32),
                    "R": np.eye(3, dtype=np.float32),
                    "Th": np.zeros((1, 3), np.float32),
                })
            self.subjects.append({"smpl": smpl, "poses": poses})

        self.cameras = [
            _ring_camera(2 * np.pi * i / n_cameras, 2.2, 0.1, self.H, self.W)
            for i in range(n_cameras)
        ]

    def __len__(self):
        return self.n_poses * self.num_instances

    def __getitem__(self, index: int) -> Dict:
        return self.get_item(index)

    def smpl_for(self, instance_idx: int, device="cuda") -> SMPLModel:
        return self.subjects[instance_idx]["smpl"].to(device)

    def get_item(self, index: int, instance_idx: Optional[int] = None) -> Dict:
        if instance_idx is None:
            instance_idx = self.rng.integers(self.num_instances)
        subj = self.subjects[instance_idx]
        smpl = subj["smpl"]
        pose_index = index % self.n_poses
        params = subj["poses"][pose_index]

        # host-side geometry, fp32 on the CPU
        with torch.no_grad():
            verts_world = posed_vertices(
                smpl, {k: torch.from_numpy(v) for k, v in params.items()}
            ).numpy()
            big = {
                "poses": big_pose_vector(),
                "shapes": torch.from_numpy(params["shapes"]),
                "R": torch.eye(3),
                "Th": torch.zeros(1, 3),
            }
            t_vertices = posed_vertices(smpl, big).numpy()

        tv = t_vertices
        colors = (tv - tv.min(0)) / (tv.max(0) - tv.min(0) + 1e-8)
        world_bounds = np.stack(
            [verts_world.min(0) - 0.05, verts_world.max(0) + 0.05], axis=0
        ).astype(np.float32)

        feature, coord, out_sh, bounds = voxelize_vertices(verts_world)
        t_feature, t_coord, t_out_sh, t_bounds = voxelize_vertices(t_vertices)

        keys = ("img_all ray_o_all ray_d_all rgb_all near_all far_all "
                "mask_at_box_all bkgd_msk_all msk_all K_all R_all "
                "T_all").split()
        per_view = {k: [] for k in keys}
        for vi in self.output_view:
            K, R, T = self.cameras[vi]
            img, msk = _splat_image(verts_world, colors, K, R, T, self.H,
                                    self.W)
            rb: RayBatch = sample_rays_batch(
                img, msk, K, R, T, world_bounds, self.n_rays, self.split,
                rng=self.rng,
            )
            if vi in self.input_view:
                per_view["img_all"].append(np.transpose(img, (2, 0, 1)))
                per_view["K_all"].append(K)
                per_view["R_all"].append(R)
                per_view["T_all"].append(T)
            per_view["msk_all"].append(msk)
            per_view["rgb_all"].append(rb.rgb)
            per_view["ray_o_all"].append(rb.ray_o)
            per_view["ray_d_all"].append(rb.ray_d)
            per_view["near_all"].append(rb.near[..., None])
            per_view["far_all"].append(rb.far[..., None])
            per_view["mask_at_box_all"].append(rb.mask_at_box)
            per_view["bkgd_msk_all"].append(rb.bkgd_msk)

        ret = {
            "pose_index": np.int32(pose_index),
            "instance_idx": np.int32(instance_idx),
            "gender": np.int32(2),
            "params": {k: v.astype(np.float32) for k, v in params.items()},
            "vertices": verts_world.astype(np.float32),
            "feature": feature,
            "coord": coord,
            "out_sh": out_sh,
            "bounds": bounds,
            "t_vertices": t_vertices.astype(np.float32),
            "t_feature": t_feature,
            "t_coord": t_coord,
            "t_out_sh": t_out_sh,
            "t_bounds": t_bounds,
        }
        for k in keys:
            ret[k] = np.stack(per_view[k], axis=0).astype(
                bool if k == "mask_at_box_all" else np.float32
            )
        return ret
