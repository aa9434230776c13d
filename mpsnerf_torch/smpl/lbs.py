"""Linear-blend-skinning warps between target, canonical and source spaces
(port of ``mpsnerf_tpu/smpl/lbs.py``).

Per-pose quantities (joint transforms, blend offsets) are computed once in
:class:`PoseTransforms`; each point then gathers its nearest vertex's blend
weights, blends the joint transforms with one (N, 24) @ (24, 16) product
and inverts a 3x3 in closed form.  Only the unfused gathers are ported:
the JAX package's fused (V, 30) row table is an XLA layout trick that
reads the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpsnerf_torch.smpl.kinematics import (
    big_pose_vector,
    pose_blend_offsets,
    shape_blend_offsets,
    transform_params,
)
from mpsnerf_torch.smpl.model import SMPLModel


def _right_mul3(pts: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``pts @ m`` for (N, 3) x (3, 3), written as elementwise products so
    it rounds the same way on every device (the body masks downstream
    compare these coordinates against thresholds)."""
    return (pts[:, 0:1] * m[0] + pts[:, 1:2] * m[1]) + pts[:, 2:3] * m[2]


def world_to_smpl(pts: torch.Tensor, R: torch.Tensor, Th: torch.Tensor):
    """World -> SMPL coordinates: ``(x - Th) @ R``."""
    return _right_mul3(pts - Th.reshape(1, 3), R.reshape(3, 3))


def smpl_to_world(pts: torch.Tensor, R: torch.Tensor, Th: torch.Tensor):
    """SMPL -> world coordinates: ``x @ R^-1 + Th``."""
    return _right_mul3(pts, inv3x3(R.reshape(3, 3))) + Th.reshape(1, 3)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [
            co_a, -(b * i - c * h), b * f - c * e,
            co_b, a * i - c * g, -(a * f - c * d),
            co_c, -(a * h - b * g), a * e - b * d,
        ],
        dim=-1,
    ).reshape(m.shape)
    return adj / det[..., None, None]


class PoseTransforms(NamedTuple):
    """Everything per pose that the warps need, computed once."""

    A: torch.Tensor              # (24, 4, 4) joint rigid transforms
    A_big: torch.Tensor          # (24, 4, 4) big-pose joint transforms
    R: torch.Tensor              # (3, 3) global rotation
    Th: torch.Tensor             # (3,) global translation
    joints: torch.Tensor         # (24, 3) rest joints
    pose_offsets: torch.Tensor   # (V, 3)
    shape_offsets: torch.Tensor  # (V, 3)

    @staticmethod
    def create(smpl: SMPLModel, params) -> "PoseTransforms":
        """``params``: dict with 'poses' (72,), 'shapes' (10,), 'R', 'Th'."""
        poses = params["poses"].reshape(-1)
        shapes = params["shapes"].reshape(-1)
        A, joints = transform_params(smpl, poses, shapes)
        big = big_pose_vector(poses.dtype, poses.device)
        A_big, _ = transform_params(smpl, big, shapes)
        return PoseTransforms(
            A=A,
            A_big=A_big,
            R=params["R"].reshape(3, 3),
            Th=params["Th"].reshape(3),
            joints=joints,
            pose_offsets=pose_blend_offsets(smpl, poses),
            shape_offsets=shape_blend_offsets(smpl, shapes),
        )


def _blend_A(bweights: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """(N, 24) blend weights x (24, 4, 4) -> per-point (N, 4, 4)."""
    return (bweights @ A.reshape(24, 16)).reshape(-1, 4, 4)


def _apply(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-point (N, 3, 3) @ (N, 3)."""
    return torch.einsum("nij,nj->ni", m, x)


def deform_target_to_canonical(
    smpl: SMPLModel,
    tf: PoseTransforms,
    query_pts: torch.Tensor,   # (N, 3) target SMPL space
    vert_ids: torch.Tensor,    # (N,) nearest SMPL vertex (int64)
    mean_shape: bool = True,
) -> torch.Tensor:
    """Inverse-LBS warp: target-pose SMPL space -> canonical big pose."""
    bweights = smpl.weights[vert_ids]
    A = _blend_A(bweights, tf.A)
    can = _apply(inv3x3(A[:, :3, :3]), query_pts - A[:, :3, 3])
    if mean_shape:
        can = can - tf.pose_offsets[vert_ids]
        can = can - tf.shape_offsets[vert_ids]
    A_b = _blend_A(bweights, tf.A_big)
    return _apply(A_b[:, :3, :3], can) + A_b[:, :3, 3]


def deform_canonical_to_source(
    smpl: SMPLModel,
    tf: PoseTransforms,
    query_pts: torch.Tensor,   # (N, 3) canonical big-pose points
    vert_ids: torch.Tensor,    # (N,) nearest canonical vertex
    mean_shape: bool = True,
):
    """Forward-LBS warp: canonical big pose -> source pose -> world.
    Returns ``(smpl_src_pts, world_src_pts, bweights)``."""
    bweights = smpl.weights[vert_ids]
    A_b = _blend_A(bweights, tf.A_big)
    pts = _apply(inv3x3(A_b[:, :3, :3]), query_pts - A_b[:, :3, 3])
    if mean_shape:
        pts = pts + tf.shape_offsets[vert_ids]
        pts = pts + tf.pose_offsets[vert_ids]
    A_s = _blend_A(bweights, tf.A)
    smpl_src = _apply(A_s[:, :3, :3], pts) + A_s[:, :3, 3]
    return smpl_src, smpl_to_world(smpl_src, tf.R, tf.Th), bweights


def posed_vertices(smpl: SMPLModel, params) -> torch.Tensor:
    """Full forward LBS of the template mesh to world space."""
    poses = params["poses"].reshape(-1)
    shapes = params["shapes"].reshape(-1)
    A, _ = transform_params(smpl, poses, shapes)
    v = (
        smpl.v_template
        + shape_blend_offsets(smpl, shapes)
        + pose_blend_offsets(smpl, poses)
    )
    A_pt = _blend_A(smpl.weights, A)
    v_posed = _apply(A_pt[:, :3, :3], v) + A_pt[:, :3, 3]
    return smpl_to_world(v_posed, params["R"], params["Th"])
