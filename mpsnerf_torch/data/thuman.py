"""THuman multi-view loaders (port of ``mpsnerf_tpu/data/thuman.py``:
``THumanDatasetBatch``, ``THumanDataset``, ``THumanDatasetBatchRandom``
and ``THumanDatasetPair``), with :mod:`mpsnerf_torch.data.imageio` where
the JAX package calls OpenCV.

Directory layout:
  <data_root>/annots.npy            cams {K, D, R, T} + ims per pose
  <data_root>/<view>/<frame>.jpg    images
  <data_root>/mask_cihp/...         masks (png)
  <data_root>/new_vertices/<i>.npy  posed SMPL vertices (world)
  <data_root>/new_params/<i>.npy    SMPL params {poses, shapes, R, Th}
  <data_root>/X_vertices.npy        the subject's canonical (big-pose) verts
  data/{m,f}_X_template_tvertices.npy   mean-shape templates (mean_shape=1)
  data/THuman_1_{human,male}_list.txt   subject names (multi_person=1)

The ``data/`` paths are relative to the working directory, as in the JAX
package.  Items have the JAX package's keys, shapes and dtypes, and one
seed gives the same draws in the same order: ``instance_idx`` (with
``multi_person``) before each view's rays.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from mpsnerf_torch.data import imageio
from mpsnerf_torch.data.voxelize import voxelize_vertices
from mpsnerf_torch.rays.rays import sample_rays_batch

_INPUT_VIEWS = {
    8: [0, 3, 6, 9, 12, 15, 18, 21],
    6: [0, 4, 8, 12, 16, 20],
    4: [0, 6, 12, 18],
    3: [4, 12, 20],
    12: [0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22],
}

PER_VIEW_KEYS = ("img_all msk_all K_all R_all T_all rgb_all ray_o_all "
                 "ray_d_all near_all far_all mask_at_box_all "
                 "bkgd_msk_all").split()


def window_ims(annots: Dict, start: int, n: int, interval: int,
               views: List[int]):
    """The pose window's image paths and camera indices of ``views``."""
    window = annots["ims"][start:start + n * interval][::interval]
    ims = np.array([np.array(d["ims"])[views] for d in window])
    cam_inds = np.array([np.arange(len(d["ims"]))[views] for d in window])
    return ims, cam_inds


def stack_item(ret: Dict, per_view: Dict[str, List]) -> Dict:
    """Stack the per-view lists into the item (float32; bool masks)."""
    for k, v in per_view.items():
        if v:
            ret[k] = np.stack(v, axis=0).astype(
                np.float32 if k != "mask_at_box_all" else bool)
    return ret


def append_rays(per_view: Dict[str, List], rb) -> None:
    per_view["rgb_all"].append(rb.rgb)
    per_view["ray_o_all"].append(rb.ray_o)
    per_view["ray_d_all"].append(rb.ray_d)
    per_view["near_all"].append(rb.near[..., None])
    per_view["far_all"].append(rb.far[..., None])
    per_view["mask_at_box_all"].append(rb.mask_at_box)
    per_view["bkgd_msk_all"].append(rb.bkgd_msk)


def item_params(params: Dict) -> Dict:
    return {
        "poses": np.asarray(params["poses"], np.float32).reshape(-1),
        "shapes": np.asarray(params["shapes"], np.float32).reshape(-1),
        "R": np.asarray(params["R"], np.float32).reshape(3, 3),
        "Th": np.asarray(params["Th"], np.float32).reshape(1, 3),
    }


def posed_input(data_root: str, i: int, rotation):
    """Frame ``i``'s posed vertices, world bounds (5 cm pad), SMPL-frame
    voxelization and params; ``rotation(params)`` is the SMPL rotation."""
    xyz = np.load(os.path.join(data_root, "new_vertices", f"{i}.npy")
                  ).astype(np.float32)
    world_bounds = np.stack([xyz.min(0) - 0.05, xyz.max(0) + 0.05],
                            axis=0).astype(np.float32)
    params = np.load(os.path.join(data_root, "new_params", f"{i}.npy"),
                     allow_pickle=True).item()
    R = rotation(params)
    Th = np.asarray(params["Th"], np.float32)
    feature, coord, out_sh, bounds = voxelize_vertices(np.dot(xyz - Th, R))
    return feature, coord, out_sh, world_bounds, bounds, xyz, params


def pose_pair(dataset, index: int) -> Dict:
    """``{"sp_input", "tp_input"}``: half the pairs a pose with itself
    (with ``random_pair``), the others a random pose within ``border``;
    one instance for both."""
    instance_idx = (int(dataset.rng.integers(len(dataset.root_list)))
                    if dataset.multi_person else 0)
    sp_pose = index % dataset.ni
    if dataset.random_pair and dataset.rng.uniform() >= 0.5:
        lo = max(0, sp_pose - dataset.border)
        hi = min(dataset.ni - 1, sp_pose + dataset.border)
        tp_pose = int(dataset.rng.integers(lo, hi + 1))
    else:
        tp_pose = sp_pose
    sp = dataset.get_item(sp_pose, instance_idx=instance_idx)
    tp = dataset.get_item(tp_pose, instance_idx=instance_idx)
    return {"sp_input": sp, "tp_input": tp}


class THumanDatasetBatch:
    """Per-pose multi-view items for one or many THuman subjects."""

    def __init__(
        self,
        data_root: str,
        split: str = "test",
        view_num: int = 24,
        N_rand: int = 1024 * 32,
        multi_person: bool = False,
        num_instance: int = 1,
        start: int = 0,
        interval: int = 1,
        poses_num: int = 30,
        image_scaling: float = 1.0,
        male: int = 0,
        mean_shape: int = 0,
        model: Optional[str] = None,
        finetune: bool = False,
        human_list: Optional[str] = None,
        seed: Optional[int] = None,
    ):
        self.data_root = data_root
        self.split = split
        self.nrays = N_rand
        self.mean_shape = mean_shape
        self.image_scaling = image_scaling
        self.rng = np.random.default_rng(seed)

        self.input_view = _INPUT_VIEWS.get(view_num, list(range(view_num)))
        self.train_view = (self.input_view
                           if (model == "ani_nerf" or finetune)
                           else list(range(24)))
        self.test_view = list(range(24))
        self.output_view = (self.train_view if split == "train"
                            else self.test_view)

        self.i = start
        self.i_intv = interval
        self.ni = poses_num

        self.multi_person = multi_person
        self.num_instance = num_instance
        all_human_root = os.path.dirname(data_root)
        if human_list is None:
            human_list = os.path.join(
                "data", "THuman_1_male_list.txt" if male == 1
                else "THuman_1_human_list.txt")
        self.human_list = human_list
        if multi_person:
            with open(human_list) as f:
                dirs = [x.strip() for x in f.readlines()[:num_instance]]
            self.root_list = [os.path.join(all_human_root, d) for d in dirs]
        else:
            self.root_list = [data_root]

        self._load_annots(data_root)

    def _load_annots(self, data_root: str) -> None:
        self.data_root = data_root
        annots = np.load(os.path.join(data_root, "annots.npy"),
                         allow_pickle=True).item()
        self.cams = annots["cams"]
        self.ims, self.cam_inds = window_ims(annots, self.i, self.ni,
                                             self.i_intv, self.output_view)

    update = _load_annots

    def get_mask(self, pose_index: int, view_index: int) -> np.ndarray:
        path = os.path.join(
            self.data_root, "mask_cihp",
            self.ims[pose_index][view_index].replace("\\", "/")
            .replace("jpg", "png"))
        msk = imageio.imread(path)
        if msk.ndim == 3:
            msk = msk[..., 0]
        msk = msk.copy()
        msk[msk != 0] = 255
        return msk

    def _canonical_template_path(self) -> str:
        if self.mean_shape:
            name = ("m_X_template_tvertices.npy" if self.data_root[-1] == "M"
                    else "f_X_template_tvertices.npy")
            return os.path.join("data", name)
        return os.path.join(self.data_root, "X_vertices.npy")

    def prepare_input(self, i):
        """Posed SMPL: world verts + SMPL-frame voxelization + params."""
        (feature, coord, out_sh, world_bounds, bounds, vertices,
         params) = posed_input(self.data_root, i,
                               lambda p: np.asarray(p["R"], np.float32))
        return feature, coord, out_sh, world_bounds, bounds, vertices, params

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

        per_view: Dict[str, List] = {k: [] for k in PER_VIEW_KEYS}
        params = vertices = None
        feature = coord = out_sh = world_bounds = bounds = None
        t_vertices = t_feature = t_coord = t_out_sh = t_bounds = None

        for idx, view_index in enumerate(self.output_view):
            img_path = os.path.join(
                self.data_root, self.ims[pose_index][idx].replace("\\", "/"))
            img = imageio.imread(img_path).astype(np.float32) / 255.0
            msk = np.asarray(self.get_mask(pose_index, idx)) / 255.0
            img = img.copy()
            img[msk == 0] = 0
            K = np.array(self.cams["K"][view_index])
            D = np.array(self.cams["D"][view_index])
            img = imageio.undistort(img, K, D)
            msk = imageio.undistort(msk, K, D)
            R = np.array(self.cams["R"][view_index])
            T = np.array(self.cams["T"][view_index])

            ratio = self.image_scaling
            if ratio != 1.0:
                h, w = int(img.shape[0] * ratio), int(img.shape[1] * ratio)
                img = imageio.resize(img, (w, h), imageio.AREA)
                msk = imageio.resize(msk, (w, h), imageio.NEAREST)
                K = K.copy()
                K[:2] = K[:2] * ratio

            if view_index == self.output_view[0]:
                i = int(os.path.basename(img_path)[:-4])
                (feature, coord, out_sh, world_bounds, bounds, vertices,
                 params) = self.prepare_input(i)
                t_path = self._canonical_template_path()
                t_vertices = np.load(t_path).astype(np.float32)
                t_feature, t_coord, t_out_sh, t_bounds = voxelize_vertices(
                    t_vertices)

            rb = sample_rays_batch(img, msk, K, R, T, world_bounds,
                                   self.nrays, self.split, rng=self.rng)

            if view_index in self.input_view:
                per_view["img_all"].append(np.transpose(img, (2, 0, 1)))
                per_view["K_all"].append(K)
                per_view["R_all"].append(R)
                per_view["T_all"].append(T)
            per_view["msk_all"].append(msk)
            append_rays(per_view, rb)

        ret = {
            "pose_index": np.int32(pose_index),
            "params": item_params(params),
            "instance_idx": np.int32(instance_idx),
            "gender": np.int32(1 if self.data_root[-1] == "M" else 0),
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


class THumanDataset(THumanDatasetBatch):
    """The legacy loader's view tables: train views [0, 6, 12, 18] at
    view_num=4 (all views otherwise) and paired input views."""

    def __init__(self, *args, view_num: int = 24, split: str = "test",
                 **kwargs):
        super().__init__(*args, view_num=view_num, split=split, **kwargs)
        self.train_view = ([0, 6, 12, 18] if view_num == 4
                           else list(range(view_num)))
        self.input_view = ([0, 6, 12, 18] if view_num == 4
                           else [0, 1, 6, 7, 12, 13, 18, 19])
        self.test_view = list(range(24))
        self.output_view = (self.train_view if split == "train"
                            else self.test_view)


class THumanDatasetBatchRandom(THumanDatasetBatch):
    """The alternate 4-view input subset [0, 4, 12, 16]."""

    def __init__(self, *args, view_num: int = 24, **kwargs):
        super().__init__(*args, view_num=view_num, **kwargs)
        if view_num == 4:
            self.input_view = [0, 4, 12, 16]
        self.train_view = list(range(24))
        self.output_view = (self.train_view if self.split == "train"
                            else self.test_view)


class THumanDatasetPair(THumanDatasetBatch):
    """Pair items ``{"sp_input", "tp_input"}`` for pose-pair training
    (:func:`pose_pair`)."""

    def __init__(self, *args, border: int = 5, random_pair: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.border = border
        self.random_pair = random_pair

    def __getitem__(self, index: int) -> Dict:
        return pose_pair(self, index)
