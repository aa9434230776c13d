"""The generalizable human NeRF (port of ``mpsnerf_tpu/models/
mps_nerf.py``, every option of the JAX class).

Per query point (world space, target pose):
  1. world -> target SMPL space;
  2. human-region mask: 1-NN distance to the posed SMPL vertices < 5 cm;
  3. inverse LBS to the canonical big pose;
  4. optionally the correction field (a zero-init MLP on the PE'd points
     and the sparse 3D encoder's features, with the view-averaged latent
     (``"aggregate"``) or the target pose and an instance code
     (``"instance"``)) moves the canonical points;
  5. canonical 1-NN, forward LBS to the source pose and world, the blend
     weights optionally corrected by the skinning field; the instance
     style corrects the source-pose points a second time;
  6. projection into each source view, patch sampling of the latent and
     the PE'd image rgb;
  7. transformer fusion across views (or their mean) -> f1 (density), f2
     (rgb);
  8. NeRF MLP -> (rgb, sigma), the rgb optionally a softmax blend of the
     sampled image rgb (``blend_rgb``); masked points get raw = -80.

With ``compute_normals`` (the smooth-loss train step) the occupancy normal
is the gradient of the tail's density by the canonical points, taken with
``create_graph`` so the loss can differentiate it again, and the nearest
SMPL vertex's normal comes with it.  The encoder's BatchNorm follows the
module's train/eval mode.

``compute_dtype="bfloat16"`` runs the MLP's and the transformer's
products in bf16 (parameters, geometry, LayerNorm statistics, softmax and
compositing stay fp32).  Sub-modules exist only where a flag reads them
(``latent_codes`` for the skinning field and the instance correction, the
3D encoder and the deform fields for theirs), so the flagship's state dict
is unchanged.  ``human_sample=False`` evaluates every point (no 5 cm mask,
no compaction).

Module names follow the reference checkpoint, so ``state_dict()`` is what
``mpsnerf_tpu/compat/torch_import.py:convert_reference_state_dict`` reads
(except ``backward_correction``, which it does not map).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mpsnerf_torch.models.deform import DeformField
from mpsnerf_torch.models.layers import TorchLinear, compute_dtype_of
from mpsnerf_torch.models.resnet import SpatialEncoder
from mpsnerf_torch.models.sparse_conv import SparseConvNet3D
from mpsnerf_torch.models.transformer import ViewFusionTransformer
from mpsnerf_torch.ops.body_grid import grid_lookup
from mpsnerf_torch.ops.compact import compact, expand_gather, plan_compaction
from mpsnerf_torch.ops.grid_sample import grid_sample_2d_patch
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
    smpl_to_world,
    world_to_smpl,
)
from mpsnerf_torch.smpl.mesh import vertex_normals
from mpsnerf_torch.smpl.model import SMPLModel
from mpsnerf_torch.utils.constants import device_constant

HUMAN_DIST_THRESHOLD_SQ = 0.05 ** 2  # 5 cm
MASK_FILL = -80.0
INSTANCE_CODE = 128  # the per-instance embedding's width
SPCONV_CH = 32       # the sparse 3D encoder's output channels


class RawOutput(NamedTuple):
    """The JAX package's ``RawOutput``, in its field order.  The
    correction fields are zeros without a correction field; the normals
    are zeros unless ``compute_normals``."""

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
    """Generalizable human NeRF with LBS canonicalization; the JAX class's
    fields under its names and defaults.

    ``compact_fraction``: the tail capacity of a query as a fraction of its
    points (train batches run ~35-42 % in-body samples, hence 0.5; eval
    renders use tighter fractions, see ``eval/runner.py``).  None runs the
    tail on every point, uncompacted (exact at any in-body share).
    ``bn_axis_name``: the 2D encoder's BatchNorm averages its train-mode
    statistics over that axis of the bound mesh (cross-replica BatchNorm,
    ``models/resnet.py``); a train-mode encode outside a mesh raises."""

    def __init__(
        self,
        num_instances: int = 25,
        use_transformer: bool = True,
        append_rgb: bool = True,
        with_viewdirs: bool = False,
        human_sample: bool = True,
        mean_shape: bool = False,
        correction_field: bool = False,
        skinning_field: bool = False,
        correction_style: str = "aggregate",
        pe_condition: bool = True,
        compute_dtype: str = "float32",
        encoder_layers: int = 2,
        nerf_width: int = 256,
        nerf_depth: int = 8,
        nerf_skips: tuple = (4,),
        bn_axis_name: Optional[str] = None,
        pair_mode: bool = False,
        blend_rgb: bool = False,
        n_input_views: int = 3,
        compact_fraction: Optional[float] = 0.5,
    ):
        super().__init__()
        if correction_style not in ("aggregate", "instance"):
            raise ValueError(f"correction_style {correction_style!r}: "
                             "aggregate or instance")
        self.num_instances = num_instances
        self.use_transformer = bool(use_transformer)
        self.append_rgb = bool(append_rgb)
        self.with_viewdirs = bool(with_viewdirs)
        self.human_sample = bool(human_sample)
        self.mean_shape = bool(mean_shape)
        self.correction_field = bool(correction_field)
        self.skinning_field = bool(skinning_field)
        self.correction_style = correction_style
        self.pe_condition = bool(pe_condition)
        self.compute_dtype = compute_dtype
        self.nerf_skips = tuple(nerf_skips)
        self.pair_mode = bool(pair_mode)
        self.blend_rgb = bool(blend_rgb)
        self.n_input_views = n_input_views
        self.compact_fraction = compact_fraction
        cdt = compute_dtype_of(compute_dtype)
        self._cdt = cdt
        instance = self.correction_field and correction_style == "instance"

        self.encoder_2d = SpatialEncoder(encoder_layers, bn_axis_name)
        lat_ch = self.encoder_2d.latent_channels
        feat_ch = lat_ch + (pe_dim(4) if self.append_rgb else 0)
        if self.use_transformer:
            self.transformer = ViewFusionTransformer(dim=feat_ch, dtype=cdt)
        if self.skinning_field or instance:
            self.latent_codes = nn.Embedding(num_instances, INSTANCE_CODE)
            nn.init.normal_(self.latent_codes.weight, std=0.01)
        if self.correction_field:
            self.encoder_3d = SparseConvNet3D()
            if instance:
                # PE + target poses + instance code + 3D feature, depth 4
                in_c = pe_dim(6) + 72 + INSTANCE_CODE + SPCONV_CH
                self.forward_deform = DeformField(
                    in_c, depth=4, out_ch=3, deform_type="correction")
                self.backward_correction = DeformField(
                    in_c, depth=4, out_ch=3, deform_type="correction")
            else:
                # PE + 3D feature + the view-averaged latent, depth 2
                self.forward_deform = DeformField(
                    pe_dim(6) + SPCONV_CH + lat_ch, depth=2, out_ch=3,
                    deform_type="correction")
        if self.skinning_field:
            self.backward_deform = DeformField(
                pe_dim(6) + INSTANCE_CODE, depth=4, out_ch=24,
                deform_type="weights")

        in_ch = (pe_dim(6) if self.pe_condition else 0) + feat_ch
        w = nerf_width
        widths = [in_ch] + [w + (in_ch if i in self.nerf_skips else 0)
                            for i in range(nerf_depth)]
        self.pts_linears = nn.ModuleList(
            [TorchLinear(widths[i], w, dtype=cdt) for i in range(nerf_depth)])
        self.alpha_linear = TorchLinear(widths[-1], 1, dtype=cdt)
        self.feature_linear = TorchLinear(widths[-1], w, dtype=cdt)
        self.views_linear = TorchLinear(
            w + (pe_dim(4) if self.with_viewdirs else 0) + feat_ch, w // 2,
            dtype=cdt)
        self.rgb_linear = TorchLinear(
            w // 2, n_input_views if self.blend_rgb else 3, dtype=cdt)

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

    def _nerf_mlp(self, can_pts, f1, f2, viewdirs, rgb_samples=None):
        x = (torch.cat([positional_encoding(can_pts, 6), f1], dim=-1)
             if self.pe_condition else f1)
        if self._cdt is not None:
            # one cast up front keeps the skip concatenations in bf16
            x, f2 = x.to(self._cdt), f2.to(self._cdt)
        h = x
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if i in self.nerf_skips:
                h = torch.cat([x, h], dim=-1)
        alpha = self.alpha_linear(h)[..., 0]
        feature = self.feature_linear(h)
        if self.with_viewdirs:
            vd = positional_encoding(viewdirs, 4).to(feature.dtype)
            h = torch.cat([feature, vd, f2], dim=-1)
        else:
            h = torch.cat([feature, f2], dim=-1)
        h = F.relu(self.views_linear(h))
        if self.blend_rgb:
            # per-view weights of the sampled image rgb, blended in fp32
            wts = torch.softmax(self.rgb_linear(h).float(), dim=-1)  # (N, V)
            rgb = torch.einsum("nv,vnc->nc", wts, rgb_samples)
        else:
            rgb = self.rgb_linear(h)
        return rgb.float(), alpha.float()

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

    def _view_coords(self, sp_input, world_src_pts):
        """World points -> each source view's normalized image coords
        (V, N, 2), in [-1, 1] over the full image; the latent and the
        image are both sampled there (align_corners against each one's
        own resolution)."""
        uv, image_size = self._project_uv(sp_input, world_src_pts)
        size = device_constant(image_size, uv.dtype, uv.device)
        return 2.0 * uv / size - 1.0

    def _sample_views(self, sp_input, latent, coords):
        """K2 at ``coords``: the latent samples (V, N, C) and, where the
        model reads them, the image rgb samples (V, N, 3) (else None)."""
        feats = grid_sample_2d_patch(latent, coords).permute(0, 2, 1)
        rgb_s = None
        if self.append_rgb or self.blend_rgb:
            rgb_s = grid_sample_2d_patch(sp_input["img_all"],
                                         coords).permute(0, 2, 1)
        return feats, rgb_s

    def _fuse_views(self, feats, rgb_s):
        """The view fusion of the sampled features (+ the PE'd image rgb)
        -> (f1 (density), f2 (rgb)), each (N, C')."""
        if self.append_rgb:
            feats = torch.cat([feats, positional_encoding(rgb_s, 4)], dim=-1)
        if self.use_transformer:
            # only fused[0] (density) and fused[1] (rgb) are read
            fused = self.transformer(feats, out_views=2)
            return fused[0], fused[1]
        mean = torch.mean(feats, dim=0)
        return mean, mean

    # The fine-mode query of a tile is three stretches between its kernel
    # launches: ``_to_canonical`` (after ``world_to_smpl``), the canonical
    # 1-NN (K1), ``_to_source_views``, the two K2 samples
    # (``_sample_views``), ``_raw_from_views``.  ``query``'s tail runs them
    # eagerly; ``renderer/tile_graphs.py`` captures the same three methods
    # as CUDA graphs and replays them around the same eager K1 and K2.

    def _to_canonical(self, smpl, tf_t, q_pts, q_ids):
        """Target-pose SMPL points with their nearest target vertices ->
        the canonical big pose (the inverse LBS)."""
        return deform_target_to_canonical(smpl, tf_t, q_pts, q_ids,
                                          mean_shape=self.mean_shape)

    def _to_source_views(self, smpl, tf_s, sp_input, can, ids_c,
                         weights_corr=None, instance=False):
        """Canonical points with their nearest canonical vertices -> the
        source pose (the forward LBS, then the instance model's backward
        correction where ``instance``) and each source view's normalized
        image coords: (src, world, bweights, the correction or None,
        coords (V, N, 2))."""
        src, world, bw = deform_canonical_to_source(
            smpl, tf_s, can, ids_c, self.mean_shape, weights_corr)
        corr_b = None
        if instance:
            # the backward correction of the source-pose points, from the
            # source's voxel grid at the (detached) warped points
            p3d_s = self._features_3d(sp_input, src.detach())
            corr_b = self.backward_correction(
                self._instance_input(src, sp_input, p3d_s))
            src = src + corr_b
            world = smpl_to_world(src, tf_s.R, tf_s.Th)
        return src, world, bw, corr_b, self._view_coords(sp_input, world)

    def _raw_from_views(self, can, viewdirs, feats, rgb_s):
        """The views' samples at canonical points -> (rgb, alpha): the
        view fusion and the NeRF MLP."""
        f1, f2 = self._fuse_views(feats, rgb_s)
        return self._nerf_mlp(can, f1, f2, viewdirs, rgb_s)

    def _instance_code(self, item, k):
        idx = item["instance_idx"].reshape(1).long()
        return self.latent_codes(idx)[0].expand(k, INSTANCE_CODE)

    def _instance_input(self, pts, item, p3d):
        """The instance style's field input: PE, the item's poses (72),
        its instance code (128), the 3D feature."""
        k = pts.shape[0]
        poses = item["params"]["poses"].reshape(1, 72).expand(k, 72)
        return torch.cat([positional_encoding(pts, 6), poses,
                          self._instance_code(item, k), p3d], dim=-1)

    def _features_3d(self, item, pts):
        """The 3D encoder on the item's voxel grid at its points,
        normalized to the item's bounds."""
        b = item["bounds"]
        center, half = 0.5 * (b[0] + b[1]), 0.5 * (b[1] - b[0])
        return self.encoder_3d(item["feature"], item["spconv_plan"],
                               (pts - center) / half)

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
        mode: str = "full",
        transforms: Optional[Tuple[PoseTransforms, PoseTransforms]] = None,
    ) -> RawOutput:
        """Raw (rgb, sigma) and geometry at world points.  Three branches,
        as in the JAX package: caller-supplied nearest-vertex ids (every
        point in-body), the body-grid cull with compaction (when compaction
        is on and the target has a body grid), or one exact 1-NN over every
        point, compacted unless ``compact_fraction`` is None or
        ``human_sample`` is off.  ``mode`` ``"extract_mesh"`` or
        ``"mesh_animation"`` (the geometry-only query of the mesh
        extraction and the mesh animation) takes the points as canonical
        already: no world -> SMPL step, no 5 cm mask, no compaction and no
        correction field; the canonical 1-NN, the forward LBS to the source
        and the tail run as in ``"full"``.  ``t_buckets``: the 1-NN buckets of
        ``sp_input["t_vertices"]``; a caller that queries a view tile by
        tile builds them once and passes them, else they are built here,
        once per query (for a CUDA table; a CPU one needs none).
        ``transforms``: the (source, target) :class:`PoseTransforms` of
        ``sp_input``'s and ``tp_input``'s poses; a caller that queries a
        view tile by tile builds them once and passes them, else they are
        built here, once per query.  The 3D encoder's BatchNorm and the
        encoder's follow the module's train/eval mode."""
        if mode not in ("full", "extract_mesh", "mesh_animation"):
            raise ValueError(f"query: mode {mode!r}, not full, extract_mesh "
                             "or mesh_animation")
        n = world_pts.shape[0]
        cplan = None
        n_dropped = torch.zeros((), dtype=torch.int64, device=world_pts.device)
        geometry_only = mode != "full"
        if transforms is None:
            transforms = (PoseTransforms.create(smpl, sp_input["params"]),
                          None if geometry_only else
                          PoseTransforms.create(smpl, tp_input["params"]))
        tf_s, tf_t = transforms
        if not geometry_only:
            smpl_query_pts = world_to_smpl(world_pts, tf_t.R, tf_t.Th)
            q_stop = smpl_query_pts.detach()

        use_compact = self.compact_fraction is not None and self.human_sample
        capacity = max(1024, min(
            int(np.ceil(n * (self.compact_fraction or 0) / 1024)) * 1024, n))
        if geometry_only:
            # canonical points already: every point runs the tail
            smpl_query_pts = can_pts = world_pts
            pts_mask = torch.ones(n, dtype=torch.int32,
                                  device=world_pts.device)
        elif nn_ids is not None:
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
            if self.human_sample:
                pts_mask = (d2 < HUMAN_DIST_THRESHOLD_SQ).to(torch.int32)
            else:
                pts_mask = torch.ones(n, dtype=torch.int32,
                                      device=world_pts.device)
            q_pts, q_ids = smpl_query_pts, vert_ids_t
            if use_compact:
                cplan = plan_compaction(pts_mask, capacity)
                q_pts = compact(cplan, smpl_query_pts)
                q_ids = compact(cplan, vert_ids_t)
                viewdirs = compact(cplan, viewdirs)
        if cplan is not None:
            n_dropped = torch.clamp(cplan.n_valid - capacity, min=0)

        if not geometry_only:
            can_pts = self._to_canonical(smpl, tf_t, q_pts, q_ids)
        t_vertices = sp_input["t_vertices"]
        if t_buckets is None:
            t_buckets = kernel_buckets(t_vertices)

        correction_c = None
        if self.correction_field and not geometry_only:
            p3d = self._features_3d(tp_input, q_pts)  # (K, 32)
            if self.correction_style == "instance":
                fused = self._instance_input(q_pts, tp_input, p3d)
            else:
                if self.pair_mode:
                    # the latent at the coarse points warped to the source
                    # pose (one more canonical 1-NN)
                    _, ids = nearest_vertex(can_pts.detach().contiguous(),
                                            t_vertices, t_buckets)
                    _, agg_pts, _ = deform_canonical_to_source(
                        smpl, tf_s, can_pts, ids, self.mean_shape)
                else:
                    agg_pts = (compact(cplan, world_pts) if cplan is not None
                               else world_pts).detach()
                # the latent sampled in each source view (V, N, C),
                # averaged over the views
                agg = grid_sample_2d_patch(
                    latent, self._view_coords(sp_input, agg_pts)
                ).permute(0, 2, 1).mean(dim=0)
                fused = torch.cat([positional_encoding(q_pts, 6), p3d, agg],
                                  dim=-1)
            correction_c = self.forward_deform(fused)
            can_pts = can_pts + correction_c

        instance = self.correction_field and \
            self.correction_style == "instance" and not geometry_only

        def tail(can):
            # canonical 1-NN (no gradient), forward LBS, conditioning, MLP
            _, ids_c = nearest_vertex(can.detach().contiguous(), t_vertices,
                                      t_buckets)
            weights_corr = None
            if self.skinning_field:
                code = torch.cat([positional_encoding(can, 6),
                                  self._instance_code(tp_input,
                                                      can.shape[0])], dim=-1)
                weights_corr = self.backward_deform(code)
            src, world, bw, corr_b, coords = self._to_source_views(
                smpl, tf_s, sp_input, can, ids_c, weights_corr, instance)
            feats, rgb_s = self._sample_views(sp_input, latent, coords)
            rgb_, alpha_ = self._raw_from_views(can, viewdirs, feats, rgb_s)
            return alpha_, rgb_, src, world, bw, ids_c, corr_b

        if compute_normals:
            with torch.enable_grad():
                if not can_pts.requires_grad:
                    can_pts = can_pts.detach().requires_grad_(True)
                alpha, rgb, smpl_src, world_src, bweights, vert_ids_c, \
                    correction_b = tail(can_pts)
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
            alpha, rgb, smpl_src, world_src, bweights, vert_ids_c, \
                correction_b = tail(can_pts)
            occ_normal = nearest_smpl_normal = None

        if cplan is not None:
            # effective mask: valid AND within capacity, AND the branch's
            # own mask (beyond-5cm body-grid candidates)
            pts_mask = pts_mask * cplan.take.to(torch.int32)

            def expand(x):
                return None if x is None else expand_gather(cplan, x, 0.0)

            rgb, alpha, smpl_src, world_src, bweights, occ_normal, \
                nearest_smpl_normal, correction_c, correction_b = map(
                    expand, (rgb, alpha, smpl_src, world_src, bweights,
                             occ_normal, nearest_smpl_normal, correction_c,
                             correction_b))

        maskf = pts_mask.to(rgb.dtype)[:, None]
        zeros = rgb.new_zeros(rgb.shape[0], 3)

        def zmask(x):
            return zeros if x is None else x * maskf

        return RawOutput(
            rgb=torch.where(maskf > 0, rgb, torch.full_like(rgb, MASK_FILL)),
            sigma=torch.where(maskf[:, 0] > 0, alpha,
                              torch.full_like(alpha, MASK_FILL)),
            pts_mask=pts_mask,
            correction=zmask(correction_c),
            correction_=zmask(correction_b),
            smpl_query_pts=smpl_query_pts * maskf,
            smpl_src_pts=smpl_src * maskf,
            occ_normal=zmask(occ_normal),
            nearest_smpl_normal=zmask(nearest_smpl_normal),
            world_src_pts=world_src,
            bweights=bweights,
            n_dropped=n_dropped,
        )
