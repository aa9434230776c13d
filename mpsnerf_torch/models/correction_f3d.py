"""The numpy-era per-sample correction models (port of
``mpsnerf_tpu/models/correction_f3d.py``): ``CorrectionF3D``
(``--model correction_by_f3d`` and ``correction_by_f3d_fagg``) and
``CorrectionUvhAgg`` (``correction_by_uvh_agg`` and
``correction_by_uvh_agg_fagg``).

``CorrectionF3D``, per query point:
  1. world -> target SMPL space; with ``human_sample`` the 5 cm mask;
  2. the 3D encoder's feature of the posed grid at the query points;
  3. the forward correction field (depth 3, zero-init output) on PE6(q),
     the offsets to the 24 posed joints, that feature [and the windowed
     2D aggregate] moves the coarse inverse-LBS warp:
     canonical = coarse(q) + correction;
  4. the backward correction field (depth 3) on PE6(canonical), the
     offsets to the 24 canonical joints [and the aggregate] moves the
     forward warp: smpl_src = coarse(canonical) + correction_;
  5. the NeRF on PE6(canonical), the canonical grid's 3D feature [and the
     fused 2D feature, ``use_f2d``];
  6. with ``compute_normals`` (the smooth step), the column norms of each
     field's Jacobian by its point input, in the ``occ_normal`` and
     ``nearest_smpl_normal`` slots (the smooth loss compares them).

``CorrectionUvhAgg`` has depth-8 fields on PE10 inputs, distance features
in the reference's mixed frames (as the JAX package reproduces them) and
the per-view 2D feature summed over views; no mask and no smoothness
branch, so its smoothness slots are zeros.

The windowed aggregate is the mean of 25 patch samples (K2) at a 5 x 5
pixel window around each point's coarse source-pose projection, averaged
over views; the samples are summed as they come (at a 524,288-point
chunk each is 0.8 GB).  Nothing is compacted: every sample runs the
network, so ``compact_fraction`` is None and the view renderer takes its
chunked path.  The input widths torch needs (flax infers them) follow the
2D encoder's latent channels (128 at the default two stages).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mpsnerf_torch.models.deform import DeformField
from mpsnerf_torch.models.layers import TorchLinear
from mpsnerf_torch.models.mps_nerf import (
    HUMAN_DIST_THRESHOLD_SQ,
    MASK_FILL,
    SPCONV_CH,
    RawOutput,
)
from mpsnerf_torch.models.resnet import SpatialEncoder
from mpsnerf_torch.models.sparse_conv import SparseConvNet3D
from mpsnerf_torch.models.transformer import ViewFusionTransformer
from mpsnerf_torch.ops.grid_sample import index_features_patch
from mpsnerf_torch.ops.knn import VertexBuckets, kernel_buckets, nearest_vertex
from mpsnerf_torch.ops.positional import pe_dim, positional_encoding
from mpsnerf_torch.smpl.lbs import (
    PoseTransforms,
    deform_canonical_to_source,
    deform_target_to_canonical,
    smpl_to_world,
    world_to_smpl,
)
from mpsnerf_torch.smpl.model import SMPLModel

N_JOINTS = 24
WINDOW = (-2.0, -1.0, 0.0, 1.0, 2.0)  # the aggregate's pixel offsets


def _joint_offsets(pts: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    """(N, 3) x (24, 3) -> (N, 72) offsets to each joint."""
    return (pts[:, None, :] - joints[None]).reshape(pts.shape[0],
                                                    3 * N_JOINTS)


def _posed_joints(tf: PoseTransforms) -> torch.Tensor:
    """The rest joints through the pose's rigid transforms: ``A @ [J, 1]``."""
    return (torch.einsum("jab,jb->ja", tf.A[:, :3, :3], tf.joints)
            + tf.A[:, :3, 3])


def _project_points_uv(sp_input, world_pts):
    """World points -> per-view pixel coords (V, N, 2), image (W, H)."""
    T_all = sp_input["T_all"].reshape(-1, 1, 3)
    img_all = sp_input["img_all"]
    image_size = (float(img_all.shape[-1]), float(img_all.shape[-2]))
    cam = torch.einsum("vij,nj->vni", sp_input["R_all"], world_pts) + T_all
    pix = torch.einsum("vij,vnj->vni", sp_input["K_all"], cam)
    return pix[..., :2] / (pix[..., 2:] + 1e-5), image_size


def _window_agg_feature(latent, uv, image_size):
    """The 5 x 5 pixel-window mean of the pixel-aligned features, averaged
    over views: (N, C).  The shifted lookup is the reference's, axes
    swapped: (uv_y + dx, uv_x + dy).  The 25 samples are summed as they
    come."""
    total = None
    for dx in WINDOW:
        for dy in WINDOW:
            shifted = torch.stack([uv[:, :, 1] + dx, uv[:, :, 0] + dy],
                                  dim=-1)
            f = index_features_patch(latent, shifted, image_size)  # (V, C, N)
            total = f if total is None else total + f
    return (total / float(len(WINDOW) ** 2)).mean(dim=0).t()


def _canonical_features(encoder_3d, sp_input, canonical):
    """The 3D encoder on the canonical grid at the canonical points."""
    b = sp_input["t_bounds"]
    center, half = 0.5 * (b[0] + b[1]), 0.5 * (b[1] - b[0])
    return encoder_3d(sp_input["t_feature"], sp_input["t_spconv_plan"],
                      (canonical - center) / half)


def _coarse_source_agg(smpl, tf_s, sp_input, latent, coarse_can, t_buckets):
    """The windowed aggregate at the coarse points warped to the source
    pose (one more canonical 1-NN)."""
    _, ids = nearest_vertex(coarse_can.detach().contiguous(),
                            sp_input["t_vertices"], t_buckets)
    _, world, _ = deform_canonical_to_source(smpl, tf_s, coarse_can, ids,
                                             False)
    uv, image_size = _project_points_uv(sp_input, world)
    return _window_agg_feature(latent, uv, image_size)


class _NeRFHead(nn.Module):
    """The NeRF MLP (skip concatenations in ``skips``) and the rgb head."""

    def __init__(self, in_ch: int, rgb_in: int, width: int, depth: int,
                 skips: tuple):
        super().__init__()
        self.nerf_skips = tuple(skips)
        widths = [in_ch] + [width + (in_ch if i in self.nerf_skips else 0)
                            for i in range(depth)]
        self.pts_linears = nn.ModuleList(
            [TorchLinear(widths[i], width) for i in range(depth)])
        self.alpha_linear = TorchLinear(widths[-1], 1)
        self.feature_linear = TorchLinear(widths[-1], width)
        self.views_linear = TorchLinear(width + rgb_in, width // 2)
        self.rgb_linear = TorchLinear(width // 2, 3)

    def _head(self, x, rgb_parts):
        h = x
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if i in self.nerf_skips:
                h = torch.cat([x, h], dim=-1)
        alpha = self.alpha_linear(h)[..., 0]
        h2 = torch.cat([self.feature_linear(h), *rgb_parts], dim=-1)
        return self.rgb_linear(F.relu(self.views_linear(h2))), alpha


def _col_norms(field, fused_of, pts):
    """Per input coordinate, the norm over the 3 outputs of the field's
    Jacobian by its point input: (N, 3).  One gradient per output channel
    (the reference's three ``autograd.grad``), kept in the graph so the
    smooth loss differentiates them again."""
    with torch.enable_grad():
        x = pts.detach().requires_grad_(True)
        out = field(fused_of(x))
        rows = [torch.autograd.grad(out[:, u].sum(), x, create_graph=True)[0]
                for u in range(3)]                        # dC_u / dq
    return torch.linalg.norm(torch.stack(rows, dim=2), dim=-1)


class CorrectionF3D(_NeRFHead):
    """``CorrectionByf3d`` / ``correction_by_f3d_fagg``: the JAX class's
    fields under its names and defaults.  ``correction_field`` (the
    trainer and the CLI attach sparse-conv plans), ``canonical_grid``
    (with the canonical grid's) and ``compact_fraction`` None (no
    compaction) are what the renderer, the trainer and the CLI read."""

    correction_field = True
    canonical_grid = True
    compact_fraction = None

    def __init__(self, use_agg: bool = False, use_f2d: bool = True,
                 with_viewdirs: bool = False, human_sample: bool = False,
                 use_transformer: bool = False, encoder_layers: int = 2,
                 nerf_width: int = 256, nerf_depth: int = 8,
                 nerf_skips: tuple = (4,)):
        encoder_2d = SpatialEncoder(encoder_layers)
        lat = encoder_2d.latent_channels
        agg = lat if use_agg else 0
        super().__init__(
            pe_dim(6) + SPCONV_CH + (lat if use_f2d else 0),
            lat + (pe_dim(4) if with_viewdirs else 0),
            nerf_width, nerf_depth, nerf_skips)
        self.use_agg = bool(use_agg)
        self.use_f2d = bool(use_f2d)
        self.with_viewdirs = bool(with_viewdirs)
        self.human_sample = bool(human_sample)
        self.use_transformer = bool(use_transformer)
        self.encoder_2d = encoder_2d
        self.encoder_3d = SparseConvNet3D()
        joints = 3 * N_JOINTS
        self.forward_deform = DeformField(
            pe_dim(6) + joints + SPCONV_CH + agg, depth=3, out_ch=3,
            deform_type="correction")
        self.backward_deform = DeformField(
            pe_dim(6) + joints + agg, depth=3, out_ch=3,
            deform_type="correction")
        if self.use_transformer:
            self.transformer = ViewFusionTransformer(dim=lat)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder_2d(images)

    @staticmethod
    def _forward_fused(q, tj, p3d, agg):
        parts = [positional_encoding(q, 6), _joint_offsets(q, tj), p3d]
        return torch.cat(parts + ([agg] if agg is not None else []), dim=-1)

    @staticmethod
    def _backward_fused(can, cj, agg):
        parts = [positional_encoding(can, 6), _joint_offsets(can, cj)]
        return torch.cat(parts + ([agg] if agg is not None else []), dim=-1)

    def query(
        self,
        smpl: SMPLModel,
        sp_input: Dict[str, Any],
        tp_input: Dict[str, Any],
        latent: torch.Tensor,
        world_pts: torch.Tensor,
        viewdirs: torch.Tensor,
        nn_ids: Optional[torch.Tensor] = None,
        compute_normals: bool = False,
        t_buckets: Optional[VertexBuckets] = None,
    ) -> RawOutput:
        """``MPSNeRF.query``'s signature, so that the renderer and the
        trainer drive this model unchanged; ``compute_normals`` selects the
        Jacobian norms.  ``nn_ids`` (the global path's) is not taken."""
        if nn_ids is not None:
            raise ValueError("CorrectionF3D.query runs its own 1-NN: the "
                             "global path's nn_ids are MPSNeRF's")
        n = world_pts.shape[0]
        tf_t = PoseTransforms.create(smpl, tp_input["params"])
        tf_s = PoseTransforms.create(smpl, sp_input["params"])
        t_vertices = sp_input["t_vertices"]
        if t_buckets is None:
            t_buckets = kernel_buckets(t_vertices)

        q = world_to_smpl(world_pts, tf_t.R, tf_t.Th)
        tar_smpl = world_to_smpl(tp_input["vertices"], tf_t.R, tf_t.Th)
        d2, ids_t = nearest_vertex(q.detach().contiguous(), tar_smpl)
        if self.human_sample:
            pts_mask = (d2 < HUMAN_DIST_THRESHOLD_SQ).to(torch.int32)
        else:
            pts_mask = torch.ones(n, dtype=torch.int32,
                                  device=world_pts.device)

        # the posed grid's 3D feature at the (normalized) query points
        b = tp_input["bounds"]
        center, half = 0.5 * (b[0] + b[1]), 0.5 * (b[1] - b[0])
        p3d_0 = self.encoder_3d(tp_input["feature"], tp_input["spconv_plan"],
                                (q - center) / half)

        coarse_can = deform_target_to_canonical(smpl, tf_t, q, ids_t,
                                                mean_shape=False)
        tj = _posed_joints(tf_t)   # target-pose joints (SMPL space)
        cj = tf_t.joints           # canonical joints
        agg = (_coarse_source_agg(smpl, tf_s, sp_input, latent, coarse_can,
                                  t_buckets) if self.use_agg else None)

        correction = self.forward_deform(self._forward_fused(q, tj, p3d_0,
                                                             agg))
        canonical = coarse_can + correction
        _, ids_c = nearest_vertex(canonical.detach().contiguous(), t_vertices,
                                  t_buckets)
        coarse_src, _, bweights = deform_canonical_to_source(
            smpl, tf_s, canonical, ids_c, False)
        correction_ = self.backward_deform(self._backward_fused(canonical, cj,
                                                                agg))
        smpl_src = coarse_src + correction_
        world_src = smpl_to_world(smpl_src, tf_s.R, tf_s.Th)

        p3d_t = _canonical_features(self.encoder_3d, sp_input, canonical)
        uv, image_size = _project_points_uv(sp_input, world_src)
        f2d = index_features_patch(latent, uv, image_size).permute(0, 2, 1)
        if self.use_transformer:
            fused = self.transformer(f2d, out_views=2)
            f1, f2 = fused[0], fused[1]
        else:
            f1 = f2 = torch.mean(f2d, dim=0)
        x = torch.cat([positional_encoding(canonical, 6), p3d_t]
                      + ([f1] if self.use_f2d else []), dim=-1)
        rgb_parts = ([positional_encoding(viewdirs, 4)]
                     if self.with_viewdirs else []) + [f2]
        rgb, alpha = self._head(x, rgb_parts)

        grad_deform = grad_deform_ = None
        if compute_normals:
            # the non-point conditioning detached, as in the reference
            p3d_sg = p3d_0.detach()
            agg_sg = agg.detach() if agg is not None else None
            grad_deform = _col_norms(
                self.forward_deform,
                lambda p: self._forward_fused(p, tj, p3d_sg, agg_sg), q)
            grad_deform_ = _col_norms(
                self.backward_deform,
                lambda p: self._backward_fused(p, cj, agg_sg), canonical)

        maskf = pts_mask.to(rgb.dtype)[:, None]
        zeros = rgb.new_zeros(n, 3)

        def zmask(v):
            return zeros if v is None else v * maskf

        return RawOutput(
            rgb=torch.where(maskf > 0, rgb, torch.full_like(rgb, MASK_FILL)),
            sigma=torch.where(maskf[:, 0] > 0, alpha,
                              torch.full_like(alpha, MASK_FILL)),
            pts_mask=pts_mask,
            correction=zmask(correction),
            correction_=zmask(correction_),
            smpl_query_pts=zmask(q),
            smpl_src_pts=zmask(smpl_src),
            occ_normal=zmask(grad_deform),
            nearest_smpl_normal=zmask(grad_deform_),
            world_src_pts=world_src,
            bweights=bweights,
            n_dropped=torch.zeros((), dtype=torch.int64,
                                  device=world_pts.device),
        )


class CorrectionUvhAgg(_NeRFHead):
    """``CorrectionByUvhAgg``, the reference's fallthrough model, as the
    JAX package resolves its latent errors (``PARITY.md``): depth-8
    fields; forward on PE10(q), the nearest canonical vertex, the distance
    to the nearest vertex (``|q_smpl - vertices_world[ids]|``, mixed frames
    as written) [and the aggregate]; backward on PE10(canonical), the
    distance to the nearest canonical vertex [and the aggregate]; the NeRF
    on PE10(canonical), the canonical grid's 3D feature [and the per-view
    2D feature summed over views, ``use_f2d``]; the rgb head always reads
    PE4(viewdirs) and that sum."""

    correction_field = True
    canonical_grid = True
    compact_fraction = None

    def __init__(self, use_agg: bool = False, use_f2d: bool = True,
                 encoder_layers: int = 2, nerf_width: int = 256,
                 nerf_depth: int = 8, nerf_skips: tuple = (4,)):
        encoder_2d = SpatialEncoder(encoder_layers)
        lat = encoder_2d.latent_channels
        agg = lat if use_agg else 0
        super().__init__(pe_dim(10) + SPCONV_CH + (lat if use_f2d else 0),
                         pe_dim(4) + lat, nerf_width, nerf_depth, nerf_skips)
        self.use_agg = bool(use_agg)
        self.use_f2d = bool(use_f2d)
        self.encoder_2d = encoder_2d
        self.encoder_3d = SparseConvNet3D()
        self.forward_deform = DeformField(pe_dim(10) + 3 + 1 + agg, depth=8,
                                          out_ch=3, deform_type="correction")
        self.backward_deform = DeformField(pe_dim(10) + 1 + agg, depth=8,
                                           out_ch=3, deform_type="correction")

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder_2d(images)

    def query(
        self,
        smpl: SMPLModel,
        sp_input: Dict[str, Any],
        tp_input: Dict[str, Any],
        latent: torch.Tensor,
        world_pts: torch.Tensor,
        viewdirs: torch.Tensor,
        nn_ids: Optional[torch.Tensor] = None,
        compute_normals: bool = False,
        t_buckets: Optional[VertexBuckets] = None,
    ) -> RawOutput:
        """As :meth:`CorrectionF3D.query`; ``compute_normals`` gives zeros
        (no smoothness branch)."""
        if nn_ids is not None:
            raise ValueError("CorrectionUvhAgg.query runs its own 1-NN: the "
                             "global path's nn_ids are MPSNeRF's")
        n = world_pts.shape[0]
        tf_t = PoseTransforms.create(smpl, tp_input["params"])
        tf_s = PoseTransforms.create(smpl, sp_input["params"])
        t_vertices = sp_input["t_vertices"]
        if t_buckets is None:
            t_buckets = kernel_buckets(t_vertices)

        q = world_to_smpl(world_pts, tf_t.R, tf_t.Th)
        tar_smpl = world_to_smpl(tp_input["vertices"], tf_t.R, tf_t.Th)
        _, ids_t = nearest_vertex(q.detach().contiguous(), tar_smpl)
        coarse_can = deform_target_to_canonical(smpl, tf_t, q, ids_t,
                                                mean_shape=False)
        agg = (_coarse_source_agg(smpl, tf_s, sp_input, latent, coarse_can,
                                  t_buckets) if self.use_agg else None)
        extra = [agg] if agg is not None else []

        dist_f = torch.linalg.norm(q - tp_input["vertices"][ids_t], dim=-1,
                                   keepdim=True)
        correction = self.forward_deform(torch.cat(
            [positional_encoding(q, 10), tp_input["t_vertices"][ids_t],
             dist_f] + extra, dim=-1))
        canonical = coarse_can + correction

        _, ids_c = nearest_vertex(canonical.detach().contiguous(), t_vertices,
                                  t_buckets)
        coarse_src, _, bweights = deform_canonical_to_source(
            smpl, tf_s, canonical, ids_c, False)
        dist_b = torch.linalg.norm(
            canonical - tp_input["t_vertices"][ids_c], dim=-1, keepdim=True)
        correction_ = self.backward_deform(torch.cat(
            [positional_encoding(canonical, 10), dist_b] + extra, dim=-1))
        smpl_src = coarse_src + correction_
        world_src = smpl_to_world(smpl_src, tf_s.R, tf_s.Th)

        p3d = _canonical_features(self.encoder_3d, sp_input, canonical)
        uv, image_size = _project_points_uv(sp_input, world_src)
        f2d = torch.sum(index_features_patch(latent, uv, image_size),
                        dim=0).t()  # (N, C)
        x = torch.cat([positional_encoding(canonical, 10), p3d]
                      + ([f2d] if self.use_f2d else []), dim=-1)
        rgb, alpha = self._head(x, [positional_encoding(viewdirs, 4), f2d])

        zeros = rgb.new_zeros(n, 3)
        return RawOutput(
            rgb=rgb,
            sigma=alpha,
            pts_mask=torch.ones(n, dtype=torch.int32, device=world_pts.device),
            correction=correction,
            correction_=correction_,
            smpl_query_pts=q,
            smpl_src_pts=smpl_src,
            occ_normal=zeros,
            nearest_smpl_normal=zeros,
            world_src_pts=world_src,
            bweights=bweights,
            n_dropped=torch.zeros((), dtype=torch.int64,
                                  device=world_pts.device),
        )
