"""The flagship generalizable human NeRF (port of
``mpsnerf_tpu/models/mps_nerf.py`` at the flagship configuration:
transformer fusion, appended rgb, human-region sampling, no correction or
skinning fields, ``mean_shape`` off, PE-conditioned MLP, fp32).

Per query point (world space, target pose):
  1. world -> target SMPL space;
  2. human-region mask: 1-NN distance to the posed SMPL vertices < 5 cm;
  3. inverse LBS to the canonical big pose;
  4. canonical 1-NN, forward LBS to the source pose and world;
  5. projection into each source view, patch sampling of the latent and
     the PE'd image rgb;
  6. transformer fusion across views -> f1 (density), f2 (rgb);
  7. NeRF MLP -> (rgb, sigma); masked points get raw = -80.

With ``compute_normals`` (the smooth-loss train step) the occupancy normal
is the gradient of the tail's density by the canonical points, taken with
``create_graph`` so the loss can differentiate it again, and the nearest
SMPL vertex's normal comes with it.  The encoder's BatchNorm follows the
module's train/eval mode.

Module names follow the reference checkpoint, so ``state_dict()`` is what
``mpsnerf_tpu/compat/torch_import.py:convert_reference_state_dict`` reads.
The reference's per-instance ``latent_codes`` are only read by the
skinning field, which this configuration leaves off, so they are absent.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mpsnerf_torch.models.layers import TorchLinear
from mpsnerf_torch.models.resnet import SpatialEncoder
from mpsnerf_torch.models.transformer import ViewFusionTransformer
from mpsnerf_torch.ops.body_grid import grid_lookup
from mpsnerf_torch.ops.compact import compact, expand_gather, plan_compaction
from mpsnerf_torch.ops.grid_sample import (
    grid_sample_2d_patch,
    index_features_patch,
)
from mpsnerf_torch.ops.knn import (
    VertexBuckets,
    kernel_buckets,
    nearest_vertex,
)
from mpsnerf_torch.ops.positional import pe_dim, positional_encoding
from mpsnerf_torch.smpl.lbs import (
    PoseTransforms,
    deform_canonical_to_source,
    deform_target_to_canonical,
    world_to_smpl,
)
from mpsnerf_torch.smpl.mesh import vertex_normals
from mpsnerf_torch.smpl.model import SMPLModel

HUMAN_DIST_THRESHOLD_SQ = 0.05 ** 2  # 5 cm
MASK_FILL = -80.0
NERF_WIDTH, NERF_DEPTH, NERF_SKIPS = 256, 8, (4,)


class RawOutput(NamedTuple):
    """The JAX package's ``RawOutput``, in its field order.  The
    correction fields are zeros in this configuration; the normals are
    zeros unless ``compute_normals``."""

    rgb: torch.Tensor                  # (N, 3) pre-activation (masked: -80)
    sigma: torch.Tensor                # (N,)   pre-activation (masked: -80)
    pts_mask: torch.Tensor             # (N,)   1 = inside the human region
    correction: torch.Tensor           # (N, 3)
    correction_: torch.Tensor          # (N, 3)
    smpl_query_pts: torch.Tensor       # (N, 3)
    smpl_src_pts: torch.Tensor         # (N, 3)
    occ_normal: torch.Tensor           # (N, 3) d wide_sigmoid(sigma) / d can
    nearest_smpl_normal: torch.Tensor  # (N, 3)
    world_src_pts: torch.Tensor        # (N, 3)
    bweights: torch.Tensor             # (N, 24)
    n_dropped: torch.Tensor            # () valid points lost to capacity


class MPSNeRF(nn.Module):
    """Generalizable human NeRF with LBS canonicalization.

    ``compact_fraction``: the tail capacity of a query as a fraction of its
    points (train batches run ~35-42 % in-body samples, hence 0.5; eval
    renders use tighter fractions, see ``eval/runner.py``).  None runs the
    tail on every point, uncompacted (exact at any in-body share)."""

    def __init__(self, compact_fraction: Optional[float] = 0.5):
        super().__init__()
        self.compact_fraction = compact_fraction
        self.encoder_2d = SpatialEncoder()
        feat_ch = SpatialEncoder.LATENT_CHANNELS + pe_dim(4)  # + PE'd rgb
        self.transformer = ViewFusionTransformer(dim=feat_ch)
        in_ch = pe_dim(6) + feat_ch
        w = NERF_WIDTH
        self.pts_linears = nn.ModuleList(
            [TorchLinear(in_ch, w)]
            + [TorchLinear(w + (in_ch if i in NERF_SKIPS else 0), w)
               for i in range(NERF_DEPTH - 1)]
        )
        self.alpha_linear = TorchLinear(w, 1)
        self.feature_linear = TorchLinear(w, w)
        self.views_linear = TorchLinear(w + feat_ch, w // 2)
        self.rgb_linear = TorchLinear(w // 2, 3)

    def with_compact_fraction(self, fraction: Optional[float]) -> "MPSNeRF":
        """The same model at another ``compact_fraction`` (JAX's
        ``model.clone(compact_fraction=...)``): a shallow copy that shares
        every parameter, buffer and submodule, so nothing is copied and a
        later ``.to()`` or weight update reaches both."""
        view = copy.copy(self)
        view.compact_fraction = fraction
        return view

    # ---- stage 1: per-view image encoding --------------------------------

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images (V, 3, H, W) -> latent (V, C, H/4, W/4), channels-last
        in memory (see ``SpatialEncoder``)."""
        return self.encoder_2d(images)

    # ---- stage 2: per-point query ------------------------------------------

    def _nerf_mlp(self, can_pts, f1, f2):
        x = torch.cat([positional_encoding(can_pts, 6), f1], dim=-1)
        h = x
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if i in NERF_SKIPS:
                h = torch.cat([x, h], dim=-1)
        alpha = self.alpha_linear(h)[..., 0]
        h = torch.cat([self.feature_linear(h), f2], dim=-1)
        h = F.relu(self.views_linear(h))
        return self.rgb_linear(h), alpha

    @staticmethod
    def _project_uv(sp_input, world_src_pts):
        """World points -> per-view pixel coords (V, N, 2), image (W, H)."""
        R_all = sp_input["R_all"]                      # (V, 3, 3)
        T_all = sp_input["T_all"].reshape(-1, 1, 3)     # (V, 1, 3)
        K_all = sp_input["K_all"]                      # (V, 3, 3)
        img_all = sp_input["img_all"]
        image_size = (float(img_all.shape[-1]), float(img_all.shape[-2]))
        cam = torch.einsum("vij,nj->vni", R_all, world_src_pts) + T_all
        pix = torch.einsum("vij,vnj->vni", K_all, cam)
        return pix[..., :2] / (pix[..., 2:] + 1e-5), image_size

    def _view_features(self, sp_input, latent, world_src_pts):
        """Project points into each source view, sample pixel-aligned
        features (+ PE'd image rgb), fuse across views -> (f1, f2)."""
        uv, image_size = self._project_uv(sp_input, world_src_pts)
        feats = index_features_patch(latent, uv, image_size).permute(0, 2, 1)
        size = torch.as_tensor(image_size, dtype=uv.dtype, device=uv.device)
        rgb_s = grid_sample_2d_patch(
            sp_input["img_all"], 2.0 * uv / size - 1.0
        ).permute(0, 2, 1)  # (V, N, 3)
        feats = torch.cat([feats, positional_encoding(rgb_s, 4)], dim=-1)
        # only fused[0] (density) and fused[1] (rgb) are read
        fused = self.transformer(feats, out_views=2)
        return fused[0], fused[1]

    def query(
        self,
        smpl: SMPLModel,
        sp_input: Dict[str, Any],
        tp_input: Dict[str, Any],
        latent: torch.Tensor,
        world_pts: torch.Tensor,   # (N, 3)
        viewdirs: torch.Tensor,    # (N, 3)
        nn_ids: Optional[torch.Tensor] = None,
        compute_normals: bool = False,
        t_buckets: Optional[VertexBuckets] = None,
    ) -> RawOutput:
        """Raw (rgb, sigma) and geometry at world points.  Three branches,
        as in the JAX package: caller-supplied nearest-vertex ids (every
        point in-body), the body-grid cull with compaction (when compaction
        is on and the target has a body grid), or one exact 1-NN over every
        point, compacted unless ``compact_fraction`` is None.
        ``t_buckets``: the 1-NN buckets of
        ``sp_input["t_vertices"]``; a caller that queries a view tile by
        tile builds them once and passes them, else they are built here,
        once per query (for a CUDA table; a CPU one needs none)."""
        n = world_pts.shape[0]
        tf_t = PoseTransforms.create(smpl, tp_input["params"])
        tf_s = PoseTransforms.create(smpl, sp_input["params"])
        cplan = None
        n_dropped = torch.zeros((), dtype=torch.int64, device=world_pts.device)

        smpl_query_pts = world_to_smpl(world_pts, tf_t.R, tf_t.Th)
        q_stop = smpl_query_pts.detach()

        use_compact = self.compact_fraction is not None
        capacity = max(1024, min(
            int(np.ceil(n * (self.compact_fraction or 0) / 1024)) * 1024, n))
        if nn_ids is not None:
            # the caller ran the exact 5 cm cull: every point is in-body
            pts_mask = torch.ones(n, dtype=torch.int32, device=world_pts.device)
            q_pts, q_ids = smpl_query_pts, nn_ids
        elif use_compact and "body_grid" in tp_input:
            cand = grid_lookup(tp_input["body_grid"], q_stop)
            cplan = plan_compaction(cand, capacity)
            tar_smpl_pts = world_to_smpl(tp_input["vertices"], tf_t.R, tf_t.Th)
            d2, q_ids = nearest_vertex(compact(cplan, q_stop), tar_smpl_pts)
            in_domain = (torch.arange(d2.shape[0], device=d2.device)
                         < cplan.n_valid)
            fine = ((d2 < HUMAN_DIST_THRESHOLD_SQ) & in_domain).to(torch.int32)
            q_pts = compact(cplan, smpl_query_pts)
            viewdirs = compact(cplan, viewdirs)
            # candidates beyond 5 cm run the tail and are masked below
            pts_mask = expand_gather(cplan, fine, 0)
        else:
            tar_smpl_pts = world_to_smpl(tp_input["vertices"], tf_t.R, tf_t.Th)
            d2, vert_ids_t = nearest_vertex(q_stop, tar_smpl_pts)
            pts_mask = (d2 < HUMAN_DIST_THRESHOLD_SQ).to(torch.int32)
            q_pts, q_ids = smpl_query_pts, vert_ids_t
            if use_compact:
                cplan = plan_compaction(pts_mask, capacity)
                q_pts = compact(cplan, smpl_query_pts)
                q_ids = compact(cplan, vert_ids_t)
                viewdirs = compact(cplan, viewdirs)
        if cplan is not None:
            n_dropped = torch.clamp(cplan.n_valid - capacity, min=0)

        can_pts = deform_target_to_canonical(
            smpl, tf_t, q_pts, q_ids, mean_shape=False)
        t_vertices = sp_input["t_vertices"]
        if t_buckets is None:
            t_buckets = kernel_buckets(t_vertices)

        def tail(can):
            # canonical 1-NN (no gradient), forward LBS, conditioning, MLP
            _, ids_c = nearest_vertex(can.detach().contiguous(), t_vertices,
                                      t_buckets)
            src, world, bw = deform_canonical_to_source(
                smpl, tf_s, can, ids_c, mean_shape=False)
            f1, f2 = self._view_features(sp_input, latent, world)
            rgb_, alpha_ = self._nerf_mlp(can, f1, f2)
            return alpha_, rgb_, src, world, bw, ids_c

        if compute_normals:
            with torch.enable_grad():
                if not can_pts.requires_grad:
                    can_pts = can_pts.detach().requires_grad_(True)
                alpha, rgb, smpl_src, world_src, bweights, vert_ids_c = \
                    tail(can_pts)
                # occ_normal = d wide_sigmoid(alpha) / d can_pts; the
                # cotangent stays in the graph (its own derivative is part
                # of the smooth loss's gradient, as under jax.vjp)
                s = torch.sigmoid(alpha)
                cot = (1.0 + 2.0 * 1e-4) * s * (1.0 - s)
                (occ_normal,) = torch.autograd.grad(
                    alpha, can_pts, cot, create_graph=True)
            # no normal where the density gradient vanishes; the double
            # where keeps sqrt(0) out of the double backward
            n2 = torch.sum(occ_normal * occ_normal, dim=-1, keepdim=True)
            valid = (n2 > 1e-8).detach()
            denom = torch.sqrt(torch.where(valid, n2, torch.ones_like(n2)))
            occ_normal = torch.where(valid, occ_normal / denom,
                                     torch.zeros_like(occ_normal))
            nearest_smpl_normal = vertex_normals(
                t_vertices, smpl.faces)[vert_ids_c]
        else:
            alpha, rgb, smpl_src, world_src, bweights, vert_ids_c = \
                tail(can_pts)
            occ_normal = nearest_smpl_normal = None

        if cplan is not None:
            # effective mask: valid AND within capacity, AND the branch's
            # own mask (beyond-5cm body-grid candidates)
            pts_mask = pts_mask * cplan.take.to(torch.int32)
            rgb = expand_gather(cplan, rgb, 0.0)
            alpha = expand_gather(cplan, alpha, 0.0)
            smpl_src = expand_gather(cplan, smpl_src, 0.0)
            world_src = expand_gather(cplan, world_src, 0.0)
            bweights = expand_gather(cplan, bweights, 0.0)
            if compute_normals:
                occ_normal = expand_gather(cplan, occ_normal, 0.0)
                nearest_smpl_normal = expand_gather(
                    cplan, nearest_smpl_normal, 0.0)

        maskf = pts_mask.to(rgb.dtype)[:, None]
        zeros = rgb.new_zeros(rgb.shape[0], 3)  # no correction field here
        return RawOutput(
            rgb=torch.where(maskf > 0, rgb, torch.full_like(rgb, MASK_FILL)),
            sigma=torch.where(maskf[:, 0] > 0, alpha,
                              torch.full_like(alpha, MASK_FILL)),
            pts_mask=pts_mask,
            correction=zeros,
            correction_=zeros,
            smpl_query_pts=smpl_query_pts * maskf,
            smpl_src_pts=smpl_src * maskf,
            occ_normal=zeros if occ_normal is None else occ_normal * maskf,
            nearest_smpl_normal=(zeros if nearest_smpl_normal is None
                                 else nearest_smpl_normal * maskf),
            world_src_pts=world_src,
            bweights=bweights,
            n_dropped=n_dropped,
        )
