"""SMPL kinematics: Rodrigues, rigid chain transforms, blend offsets
(port of ``mpsnerf_tpu/smpl/kinematics.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mpsnerf_torch.smpl.model import N_JOINTS, SMPLModel

# Canonical "big pose": shoulders at +/-45 deg, elbows at -/+30 deg about z
# (pose-vector entries 5, 8, 23, 26).
BIG_POSE_AXES: Tuple[Tuple[int, float], ...] = (
    (5, np.pi / 4.0),
    (8, -np.pi / 4.0),
    (23, -np.pi / 6.0),
    (26, np.pi / 6.0),
)


def big_pose_vector(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The 72-dim canonical big-pose axis-angle vector."""
    v = np.zeros(72, np.float64)
    for idx, val in BIG_POSE_AXES:
        v[idx] = val
    return torch.as_tensor(v, dtype=dtype, device=device)


def rodrigues(r: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3).  The epsilon is
    added to the vector before the norm, so zero vectors map to identity."""
    angle = torch.linalg.norm(r + eps, dim=-1, keepdim=True)
    axis = r / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(r.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=r.dtype, device=r.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)


def rigid_transforms(
    rot_mats: torch.Tensor, joints: torch.Tensor, parents
) -> torch.Tensor:
    """(24, 3, 3) local rotations + (24, 3) rest joints -> (24, 4, 4)
    transforms mapping rest points bound to each joint to the posed space."""
    parents = np.asarray(parents)
    rel = joints - joints[torch.as_tensor(parents, device=joints.device)]
    rel = torch.cat([joints[:1], rel[1:]], dim=0)

    local = torch.cat([rot_mats, rel[:, :, None]], dim=2)  # (24, 3, 4)
    bottom = torch.tensor(
        [[0.0, 0.0, 0.0, 1.0]], dtype=rot_mats.dtype, device=rot_mats.device
    ).expand(N_JOINTS, 1, 4)
    local = torch.cat([local, bottom], dim=1)  # (24, 4, 4)

    chain = [local[0]]
    for j in range(1, N_JOINTS):
        chain.append(chain[int(parents[j])] @ local[j])
    transforms = torch.stack(chain, dim=0)

    joints_h = torch.cat([joints, joints.new_zeros(N_JOINTS, 1)], dim=1)
    posed_joint = torch.einsum("jab,jb->ja", transforms, joints_h)
    last_col = transforms[:, :, 3] - posed_joint
    return torch.cat([transforms[:, :, :3], last_col[:, :, None]], dim=2)


def shape_blend_offsets(smpl: SMPLModel, shapes: torch.Tensor) -> torch.Tensor:
    """Per-vertex shape blend offsets (V, 3)."""
    return torch.einsum("vds,s->vd", smpl.shapedirs, shapes.reshape(-1))


def pose_blend_offsets(smpl: SMPLModel, poses: torch.Tensor) -> torch.Tensor:
    """Per-vertex pose blend offsets (V, 3) from the flattened (R_j - I)
    of the 23 non-root joints."""
    rot = rodrigues(poses.reshape(-1, 3))
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    feat = (rot[1:] - eye).reshape(-1)  # (207,)
    v = smpl.v_template.shape[0]
    return (smpl.posedirs.reshape(v * 3, -1) @ feat).reshape(v, 3)


def transform_params(
    smpl: SMPLModel, poses: torch.Tensor, shapes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint transforms for a pose/shape: (A (24, 4, 4), joints (24, 3))."""
    v_shaped = smpl.v_template + shape_blend_offsets(smpl, shapes)
    rot_mats = rodrigues(poses.reshape(-1, 3))
    joints = smpl.J_regressor @ v_shaped
    return rigid_transforms(rot_mats, joints, smpl.parents), joints

