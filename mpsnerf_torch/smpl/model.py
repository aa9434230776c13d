"""SMPL rig container and loaders (port of ``mpsnerf_tpu/smpl/model.py``).

The rig is a dataclass of tensors.  ``synthetic_smpl`` runs the same numpy
code as the JAX package, so the same seed gives the same rig.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Tuple

import numpy as np
import torch

N_VERTS = 6890
N_JOINTS = 24
N_SHAPES = 10
N_POSE_FEATURES = (N_JOINTS - 1) * 9  # 207


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    """SMPL rig as tensors (float32, faces int64).  ``parents`` is the
    static 24-joint kinematic chain as python ints."""

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, 10)
    posedirs: torch.Tensor     # (V, 3, 207)
    J_regressor: torch.Tensor  # (24, V)
    weights: torch.Tensor      # (V, 24) LBS blend weights
    faces: torch.Tensor        # (F, 3)
    parents: Tuple[int, ...] = ()

    @property
    def n_verts(self) -> int:
        return self.v_template.shape[0]

    def to(self, device) -> "SMPLModel":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "parents"
        })


def _from_numpy(v_template, shapedirs, posedirs, J_regressor, weights,
                faces, parents, device) -> SMPLModel:
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return SMPLModel(
        v_template=f32(v_template),
        shapedirs=f32(shapedirs),
        posedirs=f32(posedirs),
        J_regressor=f32(J_regressor),
        weights=f32(weights),
        faces=torch.as_tensor(np.asarray(faces, np.int64), device=device),
        parents=tuple(int(p) for p in parents),
    )


def load_smpl_pickle(path: str, device="cuda") -> SMPLModel:
    """Load a standard SMPL ``.pkl`` (latin1-pickled, scipy-sparse
    regressor)."""
    with open(path, "rb") as f:
        params = pickle.load(f, encoding="latin1")
    j_reg = params["J_regressor"]
    if hasattr(j_reg, "toarray"):  # scipy sparse
        j_reg = j_reg.toarray()
    parents = np.asarray(params["kintree_table"]).astype(np.int64)[0].copy()
    parents[0] = 0  # the root's stored parent is a sentinel; never read
    return _from_numpy(
        params["v_template"], params["shapedirs"], params["posedirs"],
        j_reg, params["weights"], params["f"], parents, device,
    )


# The real SMPL kinematic tree (kintree_table row 0), root parent set to 0.
_SMPL_PARENTS = np.array(
    [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
     20, 21],
    dtype=np.int32,
)


def synthetic_smpl(
    n_verts: int = N_VERTS, seed: int = 0, scale: float = 1.0, device="cuda"
) -> SMPLModel:
    """The deterministic synthetic SMPL-like rig of the JAX package (same
    numpy draws, same seed -> same rig)."""
    rng = np.random.default_rng(seed)

    joint_pos = np.zeros((N_JOINTS, 3), np.float64)
    for j in range(1, N_JOINTS):
        p = _SMPL_PARENTS[j]
        step = rng.normal(size=3) * 0.12
        step[1] -= 0.08
        joint_pos[j] = joint_pos[p] + step

    owner = rng.integers(0, N_JOINTS, size=n_verts)
    verts = joint_pos[owner] + rng.normal(size=(n_verts, 3)) * 0.07
    verts = verts * scale

    j_reg = np.zeros((N_JOINTS, n_verts), np.float64)
    for j in range(N_JOINTS):
        d = np.linalg.norm(verts - joint_pos[j] * scale, axis=1)
        j_reg[j, np.argsort(d)[:32]] = 1.0 / 32.0

    d_vj = np.linalg.norm(
        verts[:, None, :] - joint_pos[None, :, :] * scale, axis=2
    )
    w = np.exp(-(d_vj / 0.08) ** 2)
    top2 = np.argsort(d_vj, axis=1)[:, :2]
    mask = np.zeros_like(w)
    np.put_along_axis(mask, top2, 1.0, axis=1)
    w = w * mask + 1e-6
    w = w / w.sum(axis=1, keepdims=True)

    shapedirs = rng.normal(size=(n_verts, 3, N_SHAPES)) * 0.01
    posedirs = rng.normal(size=(n_verts, 3, N_POSE_FEATURES)) * 0.001
    n_faces = 2 * n_verts - 4 if n_verts > 3 else 1
    faces = rng.integers(0, n_verts, size=(n_faces, 3)).astype(np.int64)

    return _from_numpy(verts, shapedirs, posedirs, j_reg, w, faces,
                       _SMPL_PARENTS, device)
