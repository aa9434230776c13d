"""Human3.6M loaders (port of ``mpsnerf_tpu/data/h36m.py``:
``H36MDatasetBatch``, ``H36MDataset``, ``H36MDatasetPair`` and
``H36MDatasetBatchAll``), with :mod:`mpsnerf_torch.data.imageio` where
the JAX package calls OpenCV.

What differs from THuman:
  * 4 cameras; every image resized to 1000 x 1000 (``INTER_AREA``, its
    mask ``INTER_NEAREST``) before the undistortion; translations in
    millimetres, divided by 1000;
  * the SMPL rotation stored as axis-angle ``Rh`` (Rodrigues);
  * masks carry the erode/dilate levels 1/100/200, and the H36M ray
    sampler draws part of the background from the outer border;
  * extra per-view outputs ``o_img_all`` (the image under the raw mask,
    the eval's ground truth) and ``msk_cihp_all``;
  * the canonical template: the subject's ``45_big_pose_tvertices.npy``
    or the neutral mean-shape template ``data/n_X_template_tvertices.npy``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from mpsnerf_torch.data import imageio
from mpsnerf_torch.data.thuman import (
    PER_VIEW_KEYS,
    append_rays,
    item_params,
    pose_pair,
    posed_input,
    stack_item,
    window_ims,
)
from mpsnerf_torch.data.voxelize import voxelize_vertices
from mpsnerf_torch.rays.rays import sample_rays_h36m_batch

H36M_HUMAN_DIRS = [
    "./data/h36m/S1/Posing", "./data/h36m/S5/Posing", "./data/h36m/S6/Posing",
    "./data/h36m/S7/Posing", "./data/h36m/S9/Posing",
]


def _rotation(params) -> np.ndarray:
    return imageio.rodrigues(np.asarray(params["Rh"], np.float32)
                             ).astype(np.float32)


class H36MDatasetBatch:
    def __init__(
        self,
        data_root: str,
        split: str = "test",
        view_num: int = 3,
        border: int = 5,
        N_rand: int = 1024 * 32,
        image_scaling: float = 1.0,
        multi_person: bool = False,
        num_instance: int = 1,
        start: int = 0,
        interval: int = 10,
        poses_num: int = 100,
        mean_shape: int = 1,
        new_mask: int = 0,
        seed: Optional[int] = None,
    ):
        self.data_root = data_root
        self.split = split
        self.mean_shape = mean_shape
        self.new_mask = new_mask
        self.border = border
        self.image_scaling = image_scaling
        self.nrays = N_rand
        self.num_instance = num_instance
        self.multi_person = multi_person
        self.rng = np.random.default_rng(seed)

        self.input_view = [0, 1, 2] if view_num == 3 else [0, 1, 2, 3]
        self.train_view = [0, 1, 2, 3]
        self.test_view = [0, 1, 2, 3]
        self.output_view = (self.train_view if split == "train"
                            else self.test_view)

        self.i = start
        self.i_intv = interval
        self.ni = poses_num

        self.root_list = ([data_root] if not multi_person
                          else list(H36M_HUMAN_DIRS))
        self._load_annots(data_root)

    def _load_annots(self, data_root: str) -> None:
        self.data_root = data_root
        annots = np.load(os.path.join(data_root, "annots.npy"),
                         allow_pickle=True).item()
        self.cams = annots["cams"]
        self.ims, _ = window_ims(annots, self.i, self.ni, self.i_intv,
                                 self.output_view)

    update = _load_annots

    def get_mask(self, index: int, view_index: int):
        """The mask with its border levels (1 body, 100 the eroded/dilated
        band, 200 the band of the wider dilation) and the raw mask."""
        msk_dir = "refined_mask" if self.new_mask else "mask_cihp"
        path = os.path.join(self.data_root, msk_dir,
                            self.ims[index][view_index])[:-4] + ".png"
        msk_cihp = imageio.imread(path)
        msk_cihp = ((msk_cihp > 200) if self.new_mask
                    else (msk_cihp != 0)).astype(np.uint8)
        msk = msk_cihp if msk_cihp.ndim == 2 else msk_cihp[..., 0]
        o_msk_cihp = msk.copy()

        msk_erode = (msk.copy() if self.new_mask
                     else imageio.erode(msk, self.border))
        msk_dilate = imageio.dilate(msk, self.border)
        msk_dilate_ = imageio.dilate(msk, self.border + 3)
        msk = msk.copy()
        msk[(msk_dilate - msk_erode) == 1] = 100
        msk[(msk_dilate_ - msk_dilate) == 1] = 200
        return msk, o_msk_cihp

    def _canonical_template_path(self) -> str:
        if self.mean_shape:
            return os.path.join("data", "n_X_template_tvertices.npy")
        return os.path.join(self.data_root, "45_big_pose_tvertices.npy")

    def prepare_input(self, i: int):
        (feature, coord, out_sh, world_bounds, bounds, vertices,
         params) = posed_input(self.data_root, i, _rotation)
        Rh = np.asarray(params["Rh"], np.float32)
        Th = np.asarray(params["Th"], np.float32)
        return (feature, coord, out_sh, world_bounds, bounds, Rh, Th,
                vertices, params)

    def __len__(self) -> int:
        return len(self.ims) * self.num_instance

    def __getitem__(self, pose_index: int) -> Dict:
        return self.get_item(pose_index)

    def get_item(self, pose_index: int,
                 instance_idx: Optional[int] = None) -> Dict:
        if instance_idx is None:
            instance_idx = (int(self.rng.integers(len(self.root_list)))
                            if self.multi_person else 0)
        self._load_annots(self.root_list[instance_idx])
        pose_index = pose_index % self.ni

        per_view: Dict[str, List] = {
            k: [] for k in PER_VIEW_KEYS + ["o_img_all", "msk_cihp_all"]}
        params = vertices = smpl_R = Th = None
        feature = coord = out_sh = world_bounds = bounds = None
        t_vertices = t_feature = t_coord = t_out_sh = t_bounds = None

        for idx, view_index in enumerate(self.output_view):
            img_path = os.path.join(
                self.data_root, self.ims[pose_index][idx].replace("\\", "/"))
            img = imageio.imread(img_path).astype(np.float32) / 255.0
            msk, msk_cihp = self.get_mask(pose_index, idx)

            img = imageio.resize(img, (1000, 1000), imageio.AREA)
            msk = imageio.resize(msk, (1000, 1000), imageio.NEAREST)
            msk_cihp = imageio.resize(msk_cihp, (1000, 1000),
                                      imageio.NEAREST)

            K = np.array(self.cams["K"][view_index])
            D = np.array(self.cams["D"][view_index])
            img = imageio.undistort(img, K, D)
            msk = imageio.undistort(msk, K, D)
            R = np.array(self.cams["R"][view_index])
            T = np.array(self.cams["T"][view_index]) / 1000.0

            ratio = self.image_scaling
            if ratio != 1.0:
                H, W = int(img.shape[0] * ratio), int(img.shape[1] * ratio)
                img = imageio.resize(img, (W, H), imageio.AREA)
                msk = imageio.resize(msk, (W, H), imageio.NEAREST)
                K = K.copy()
                K[:2] = K[:2] * ratio
            img[msk == 0] = 0

            if view_index == self.output_view[0]:
                i = int(os.path.basename(img_path)[:-4])
                (feature, coord, out_sh, world_bounds, bounds, Rh, Th,
                 vertices, params) = self.prepare_input(i)
                smpl_R = _rotation(params)
                params = dict(params)
                params["R"] = smpl_R
                t_vertices = np.load(self._canonical_template_path()
                                     ).astype(np.float32)
                t_feature, t_coord, t_out_sh, t_bounds = voxelize_vertices(
                    t_vertices)

            o_img = img.copy()
            if msk_cihp.shape[:2] == o_img.shape[:2]:
                o_img[msk_cihp == 0] = 0

            rb = sample_rays_h36m_batch(img, msk, K, R, T, world_bounds,
                                        self.nrays, self.split,
                                        body_ratio=0.6, rng=self.rng)

            if view_index in self.input_view:
                per_view["img_all"].append(np.transpose(img, (2, 0, 1)))
                per_view["K_all"].append(K)
                per_view["R_all"].append(R)
                per_view["T_all"].append(T)
            per_view["o_img_all"].append(np.transpose(o_img, (2, 0, 1)))
            per_view["msk_cihp_all"].append(msk_cihp)
            per_view["msk_all"].append(msk)
            append_rays(per_view, rb)

        ret = {
            "pose_index": np.int32(pose_index),
            "instance_idx": np.int32(instance_idx),
            "R": smpl_R,
            "Th": np.asarray(Th, np.float32),
            "gender": np.int32(2),
            "params": item_params(params),
            "vertices": np.asarray(vertices, np.float32),
            "feature": feature,
            "coord": coord,
            "out_sh": out_sh,
            "bounds": bounds,
            "t_vertices": t_vertices,
            "t_feature": t_feature,
            "t_coord": t_coord,
            "t_out_sh": t_out_sh,
            "t_bounds": t_bounds,
        }
        return stack_item(ret, per_view)


class H36MDataset(H36MDatasetBatch):
    """The legacy loader: the batch loader's behaviour at these tables."""


class H36MDatasetPair(H36MDatasetBatch):
    """Pair items for H36M_P training (:func:`~mpsnerf_torch.data.thuman.
    pose_pair`, within ``border`` poses)."""

    def __init__(self, *args, random_pair: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.random_pair = random_pair

    def __getitem__(self, index: int) -> Dict:
        return pose_pair(self, index)


class H36MDatasetBatchAll(H36MDatasetBatch):
    """Iterates subjects round-robin instead of sampling them."""

    def __getitem__(self, index: int) -> Dict:
        instance_idx = (index // self.ni) % len(self.root_list)
        return self.get_item(index % self.ni, instance_idx=instance_idx)
