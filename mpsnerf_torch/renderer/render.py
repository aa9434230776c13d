"""Ray rendering: sampling -> model query -> compositing (port of
``mpsnerf_tpu/renderer/render.py``).

The serving path is the global-compaction render of a whole view, in
three steps that share one deterministic (perturb = 0) sample ladder:
:func:`plan_rays_compact` (body-grid cull + one compaction plan over every
sample of the view), :func:`fine_rays_compact` (one exact 1-NN over the
candidates: the true 5 cm mask and the nearest-vertex ids) and
:func:`render_rays_compact` (the model's tail over fixed tiles of the
compacted body points, a scatter back and one compositing pass).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from mpsnerf_torch.models.mps_nerf import (
    HUMAN_DIST_THRESHOLD_SQ,
    MASK_FILL,
    MPSNeRF,
    RawOutput,
)
from mpsnerf_torch.ops.body_grid import grid_lookup
from mpsnerf_torch.ops.compact import (
    Compaction,
    compact,
    expand_scatter,
    plan_compaction,
    resize_plan,
)
from mpsnerf_torch.ops.composite import composite_rays, stratified_z_vals
from mpsnerf_torch.ops.knn import kernel_buckets, nearest_vertex
from mpsnerf_torch.smpl.lbs import PoseTransforms, world_to_smpl
from mpsnerf_torch.smpl.model import SMPLModel


class RenderResult(NamedTuple):
    rgb_map: torch.Tensor    # (R, 3)
    disp_map: torch.Tensor   # (R,)
    acc_map: torch.Tensor    # (R,)
    depth_map: torch.Tensor  # (R,)
    weights: torch.Tensor    # (R, S)
    raw: RawOutput           # per-sample fields reshaped (R, S, ...)


def _sample_points(rays_o, rays_d, near, far, n_samples):
    """The deterministic (perturb = 0) sample ladder and its points."""
    z_vals = stratified_z_vals(near[:, None], far[:, None], n_samples)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    return z_vals, pts.reshape(-1, 3)


def _viewdirs(rays_d: torch.Tensor, n_samples: int) -> torch.Tensor:
    vd = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return vd[:, None, :].expand(-1, n_samples, -1).reshape(-1, 3)


def render_rays(
    model: MPSNeRF,
    smpl: SMPLModel,
    sp_input: Dict[str, Any],
    tp_input: Dict[str, Any],
    latent: torch.Tensor,
    rays_o: torch.Tensor,   # (R, 3)
    rays_d: torch.Tensor,   # (R, 3)
    near: torch.Tensor,     # (R,)
    far: torch.Tensor,      # (R,)
    n_samples: int,
) -> RenderResult:
    """Render one block of rays (``n_importance = 0``, ``perturb = 0``)."""
    r = rays_o.shape[0]
    z_vals, pts = _sample_points(rays_o, rays_d, near, far, n_samples)
    raw = model.query(smpl, sp_input, tp_input, latent, pts,
                      _viewdirs(rays_d, n_samples))
    out = composite_rays(
        raw.rgb.reshape(r, n_samples, 3), raw.sigma.reshape(r, n_samples),
        z_vals, rays_d,
    )
    raw_shaped = RawOutput(*(
        x.reshape((r, n_samples) + tuple(x.shape[1:]))
        if x.dim() and x.shape[0] == r * n_samples else x
        for x in raw
    ))
    return RenderResult(out.rgb_map, out.disp_map, out.acc_map,
                        out.depth_map, out.weights, raw_shaped)


@torch.no_grad()
def plan_rays_compact(
    smpl: SMPLModel,
    tp_input: Dict[str, Any],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    cap_max: Optional[int] = None,
) -> Compaction:
    """Capacity pre-pass: the body-grid cull and ONE compaction plan over
    the view's deterministic sample set.  ``plan.n_valid`` is the exact
    candidate count; the render consumes this same plan, so the pre-pass
    and the render cannot disagree.  ``cap_max`` defaults to the sample
    count (never drops)."""
    _, pts = _sample_points(rays_o, rays_d, near, far, n_samples)
    tf_t = PoseTransforms.create(smpl, tp_input["params"])
    q = world_to_smpl(pts, tf_t.R, tf_t.Th)
    cand = grid_lookup(tp_input["body_grid"], q)
    return plan_compaction(cand, cap_max or pts.shape[0])


@torch.no_grad()
def fine_rays_compact(
    smpl: SMPLModel,
    tp_input: Dict[str, Any],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    plan: Compaction,
    capacity: int,
):
    """Stage-2 pre-pass: one exact 1-NN over the candidate buffer (its
    buckets of the posed vertices built once, here) gives the true 5 cm
    body mask and the warp's nearest-vertex ids.  Returns
    ``(fine_plan, nn_ids (capacity,))``; ``fine_plan.n_valid`` is the exact
    body-point count."""
    _, pts = _sample_points(rays_o, rays_d, near, far, n_samples)
    tf_t = PoseTransforms.create(smpl, tp_input["params"])
    plan_c = resize_plan(plan, capacity)
    q_c = world_to_smpl(compact(plan_c, pts), tf_t.R, tf_t.Th)
    tar_smpl = world_to_smpl(tp_input["vertices"], tf_t.R, tf_t.Th)
    d2, nn_ids = nearest_vertex(q_c, tar_smpl)
    in_domain = torch.arange(capacity, device=d2.device) < plan_c.n_valid
    fine = (d2 < HUMAN_DIST_THRESHOLD_SQ) & in_domain
    return plan_compaction(fine, capacity), nn_ids


@torch.no_grad()
def render_rays_compact(
    model: MPSNeRF,
    smpl: SMPLModel,
    sp_input: Dict[str, Any],
    tp_input: Dict[str, Any],
    latent: torch.Tensor,
    rays_o: torch.Tensor,   # (R, 3)
    rays_d: torch.Tensor,
    near: torch.Tensor,     # (R,)
    far: torch.Tensor,
    n_samples: int,
    capacity: int,          # candidate buffer (multiple of tile)
    fine_capacity: int,     # body-point buffer (multiple of tile)
    plan: Compaction,       # from plan_rays_compact
    fine_plan: Compaction,  # from fine_rays_compact
    fine_ids: torch.Tensor,  # from fine_rays_compact
    tile: int = 16384,
):
    """Whole-view render with global compaction (the JAX package's
    ``fine_capacity`` mode).  Returns ``(rgb (R, 3), disp (R,), acc (R,),
    n_dropped ())``; ``n_dropped > 0`` means a capacity was too small and
    the image is not exact.

    The tail runs only on the ``fine_rays_compact`` body points, in tiles,
    with their nearest-vertex ids and the canonical vertices' 1-NN buckets
    (built once for the view); every other sample composites through the
    -80 fill.  The plans must come from the pre-passes over the same
    rays, so the pre-passes and the render cannot disagree."""
    assert capacity % tile == 0 and fine_capacity % tile == 0, (
        capacity, fine_capacity, tile)
    r = rays_o.shape[0]
    z_vals, pts = _sample_points(rays_o, rays_d, near, far, n_samples)
    vd = _viewdirs(rays_d, n_samples)
    plan = resize_plan(plan, capacity)
    plan2 = resize_plan(fine_plan, fine_capacity)
    n_dropped = (torch.clamp(plan.n_valid - capacity, min=0)
                 + torch.clamp(plan2.n_valid - fine_capacity, min=0))
    # fine slot -> full sample row, so the scatter below is one step
    comp_idx = plan.gather_idx[plan2.gather_idx]
    out_plan = Compaction(gather_idx=comp_idx, slot=plan.slot,
                          take=plan.take, n_valid=plan2.n_valid)
    cids = compact(plan2, fine_ids)
    cpts, cvd = pts[comp_idx], vd[comp_idx]
    t_buckets = kernel_buckets(sp_input["t_vertices"])
    rgb_t = pts.new_empty(fine_capacity, 3)
    sig_t = pts.new_empty(fine_capacity)
    for s in range(0, fine_capacity, tile):
        raw = model.query(smpl, sp_input, tp_input, latent, cpts[s:s + tile],
                          cvd[s:s + tile], nn_ids=cids[s:s + tile],
                          t_buckets=t_buckets)
        rgb_t[s:s + tile] = raw.rgb
        sig_t[s:s + tile] = raw.sigma

    full4 = expand_scatter(
        out_plan, torch.cat([rgb_t, sig_t[:, None]], dim=-1), MASK_FILL)
    out = composite_rays(
        full4[:, :3].reshape(r, n_samples, 3),
        full4[:, 3].reshape(r, n_samples),
        z_vals, rays_d,
    )
    return out.rgb_map, out.disp_map, out.acc_map, n_dropped
