"""Ray rendering: sampling -> model query -> compositing (port of
``mpsnerf_tpu/renderer/render.py``).

Two ways to render a view.  The block renderer :func:`render_rays` runs
one block of rays end to end (optionally with the hierarchical pass);
:func:`render_rays_mapped` loops it over fixed chunks on the device and
:func:`render_image` over host-padded chunks.  The global-compaction
render of a whole view runs in three steps that share one deterministic
(perturb = 0) sample ladder: :func:`plan_rays_compact` (body-grid cull +
one compaction plan over every sample of the view), :func:`fine_rays_compact`
(one exact 1-NN over the candidates: the true 5 cm mask and the
nearest-vertex ids) and :func:`render_rays_compact` (the model's tail over
fixed tiles of the compacted points, a scatter back and one compositing
pass).

Randomness is explicit: the stratified jitter ``u`` (R, S) and the
importance draws ``u_imp`` (R, n_importance) are injected by the caller or
drawn from its ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
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
from mpsnerf_torch.ops.composite import (
    composite_rays,
    sample_pdf,
    stratified_z_vals,
)
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


def z_ladder(near: torch.Tensor, far: torch.Tensor, n_samples: int,
             perturb: float = 0.0, u: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stratified z (R, S) for (R,) near/far; with ``perturb > 0`` the
    jitter is ``u`` or, when not given, drawn from ``generator``."""
    if perturb > 0.0 and u is None:
        u = torch.rand(near.shape[0], n_samples, generator=generator,
                       device=near.device)
    return stratified_z_vals(near[:, None], far[:, None], n_samples, perturb,
                             u)


def query_rays(model: MPSNeRF, smpl, sp_input, tp_input, latent, rays_o,
               rays_d, z_vals, compute_normals=False,
               jitter: Optional[torch.Tensor] = None) -> RawOutput:
    """The model at every sample ``rays_o + rays_d * z`` of (R, S) z,
    moved by ``jitter`` (R * S, 3) when given (the smooth loss's points)."""
    s = z_vals.shape[1]
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
           ).reshape(-1, 3)
    if jitter is not None:
        pts = pts + jitter
    return model.query(smpl, sp_input, tp_input, latent, pts,
                       _viewdirs(rays_d, s), compute_normals=compute_normals)


def importance_z(query: Callable[[torch.Tensor], RawOutput],
                 z_vals: torch.Tensor, rays_d: torch.Tensor,
                 n_importance: int, perturb: float = 0.0,
                 occupancy: bool = False, white_bkgd: bool = False,
                 u_imp: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """NeRF's hierarchical pass (section 5.2): a coarse query at ``z_vals``
    (no normals), its compositing weights, ``sample_pdf`` over the
    mid-points (deterministic at ``perturb == 0``, else ``u_imp`` or draws
    from ``generator``) and the sorted union with the detached fine z.
    Returns ``(z (R, S + n_importance), the coarse pass's n_dropped)``.
    The coarse pass only places samples (its z leave the graph), so it
    runs without autograd."""
    r, s = z_vals.shape
    with torch.no_grad():
        coarse_raw = query(z_vals)
        coarse = composite_rays(
            coarse_raw.rgb.reshape(r, s, 3), coarse_raw.sigma.reshape(r, s),
            z_vals, rays_d, occupancy=occupancy, white_bkgd=white_bkgd)
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_fine = sample_pdf(mids, coarse.weights[..., 1:-1], n_importance,
                            det=(perturb == 0.0), u=u_imp,
                            generator=generator)
    z_all, _ = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1)
    return z_all, coarse_raw.n_dropped


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
    perturb: float = 0.0,
    train: bool = False,
    compute_normals: bool = False,
    occupancy: bool = False,
    white_bkgd: bool = False,
    n_importance: int = 0,
    u: Optional[torch.Tensor] = None,
    u_imp: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> RenderResult:
    """Render one block of rays.  ``train``: autograd records the render
    (the caller differentiates it); otherwise it runs as an eval render,
    without a graph.  ``n_importance > 0`` adds the hierarchical pass
    (:func:`importance_z`) and queries the model again at the sorted union
    of ``n_samples + n_importance`` z; ``raw.n_dropped`` then sums both
    passes' drops (a truncated coarse pass misplaces the fine samples)."""
    with torch.set_grad_enabled(train):
        r = rays_o.shape[0]
        z_vals = z_ladder(near, far, n_samples, perturb, u, generator)

        def query(z, normals=False):
            return query_rays(model, smpl, sp_input, tp_input, latent, rays_o,
                              rays_d, z, normals)

        coarse_dropped = None
        if n_importance > 0:
            z_vals, coarse_dropped = importance_z(
                query, z_vals, rays_d, n_importance, perturb, occupancy,
                white_bkgd, u_imp, generator)
        s = z_vals.shape[1]
        raw = query(z_vals, compute_normals)
        if coarse_dropped is not None:
            raw = raw._replace(n_dropped=raw.n_dropped + coarse_dropped)
        out = composite_rays(
            raw.rgb.reshape(r, s, 3), raw.sigma.reshape(r, s), z_vals, rays_d,
            occupancy=occupancy, white_bkgd=white_bkgd)
    raw_shaped = RawOutput(*(
        x.reshape((r, s) + tuple(x.shape[1:]))
        if x.dim() and x.shape[0] == r * s else x
        for x in raw
    ))
    return RenderResult(out.rgb_map, out.disp_map, out.acc_map,
                        out.depth_map, out.weights, raw_shaped)


def render_rays_mapped(
    model: MPSNeRF,
    smpl: SMPLModel,
    sp_input: Dict[str, Any],
    tp_input: Dict[str, Any],
    latent: torch.Tensor,
    rays_o: torch.Tensor,   # (N, 3), N a multiple of chunk
    rays_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    chunk: int,
    n_samples: int,
    with_dropped: bool = False,
    generator: Optional[torch.Generator] = None,
    **kwargs,
):
    """Render many rays by :func:`render_rays` over fixed chunks on the
    device (the JAX package's ``lax.map``): ``(rgb (N, 3), disp (N,), acc
    (N,))``, with ``with_dropped`` a 4th element, the largest per-chunk
    compaction drop (0 = no valid point was dropped anywhere).  Each
    chunk's jitter is drawn from ``generator`` in turn (a shared jitter
    would band at chunk boundaries)."""
    n = rays_o.shape[0]
    if n % chunk:
        raise ValueError(f"render_rays_mapped: {n} rays are not a multiple "
                         f"of the chunk {chunk}")
    outs = []
    for s in range(0, n, chunk):
        out = render_rays(model, smpl, sp_input, tp_input, latent,
                          rays_o[s:s + chunk], rays_d[s:s + chunk],
                          near[s:s + chunk], far[s:s + chunk], n_samples,
                          generator=generator, **kwargs)
        outs.append((out.rgb_map, out.disp_map, out.acc_map,
                     out.raw.n_dropped))
    rgb, disp, acc, nd = (list(x) for x in zip(*outs))
    res = (torch.cat(rgb), torch.cat(disp), torch.cat(acc))
    if with_dropped:
        return res + (torch.stack(nd).max(),)
    return res


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
    tile: int = 16384,
    fine_capacity: int = 0,  # body-point buffer (multiple of tile); 0: none
    occupancy: bool = False,
    white_bkgd: bool = False,
    plan: Optional[Compaction] = None,       # from plan_rays_compact
    fine_plan: Optional[Compaction] = None,  # from fine_rays_compact
    fine_ids: Optional[torch.Tensor] = None,  # from fine_rays_compact
):
    """Whole-view render with global compaction (perturb = 0).  Returns
    ``(rgb (R, 3), disp (R,), acc (R,), n_dropped ())``; ``n_dropped > 0``
    means a capacity was too small and the image is not exact.

    With ``fine_capacity`` (the fine mode) the tail runs only on the
    ``fine_rays_compact`` body points, in tiles, with their nearest-vertex
    ids and the canonical vertices' 1-NN buckets (built once for the
    view).  With ``fine_capacity = 0`` (grid-only) it runs on every
    body-grid candidate, in tiles of the model uncompacted, whose own exact
    1-NN masks candidates beyond 5 cm.  Every other sample composites
    through the -80 fill.  ``plan`` (from the pre-pass over the same rays)
    saves the in-render cull; without it the body grid is read here."""
    if capacity % tile or fine_capacity % tile:
        raise ValueError(f"render_rays_compact: capacities {capacity}, "
                         f"{fine_capacity} are not multiples of {tile}")
    r = rays_o.shape[0]
    z_vals, pts = _sample_points(rays_o, rays_d, near, far, n_samples)
    vd = _viewdirs(rays_d, n_samples)
    if plan is None:
        tf_t = PoseTransforms.create(smpl, tp_input["params"])
        cand = grid_lookup(tp_input["body_grid"],
                           world_to_smpl(pts, tf_t.R, tf_t.Th))
        plan = plan_compaction(cand, capacity)
    else:
        plan = resize_plan(plan, capacity)
    n_dropped = torch.clamp(plan.n_valid - capacity, min=0)
    t_buckets = kernel_buckets(sp_input["t_vertices"])

    if fine_capacity:
        if fine_plan is None or fine_ids is None:
            raise ValueError("render_rays_compact: fine_capacity needs the "
                             "fine_rays_compact outputs (fine_plan, fine_ids)")
        plan2 = resize_plan(fine_plan, fine_capacity)
        n_dropped = n_dropped + torch.clamp(plan2.n_valid - fine_capacity,
                                            min=0)
        # fine slot -> full sample row, so the scatter below is one step
        comp_idx = plan.gather_idx[plan2.gather_idx]
        out_plan = Compaction(gather_idx=comp_idx, slot=plan.slot,
                              take=plan.take, n_valid=plan2.n_valid)
        cids = compact(plan2, fine_ids)
        cpts, cvd = pts[comp_idx], vd[comp_idx]
        out_cap, tail_model = fine_capacity, model
    else:
        out_plan, cids = plan, None
        cpts, cvd = compact(plan, pts), compact(plan, vd)
        out_cap = capacity
        tail_model = (model if model.compact_fraction is None
                      else model.with_compact_fraction(None))
    rgb_t = pts.new_empty(out_cap, 3)
    sig_t = pts.new_empty(out_cap)
    for s in range(0, out_cap, tile):
        raw = tail_model.query(
            smpl, sp_input, tp_input, latent, cpts[s:s + tile],
            cvd[s:s + tile], nn_ids=None if cids is None else cids[s:s + tile],
            t_buckets=t_buckets)
        rgb_t[s:s + tile] = raw.rgb
        sig_t[s:s + tile] = raw.sigma

    full4 = expand_scatter(
        out_plan, torch.cat([rgb_t, sig_t[:, None]], dim=-1), MASK_FILL)
    out = composite_rays(
        full4[:, :3].reshape(r, n_samples, 3),
        full4[:, 3].reshape(r, n_samples),
        z_vals, rays_d, occupancy=occupancy, white_bkgd=white_bkgd,
    )
    return out.rgb_map, out.disp_map, out.acc_map, n_dropped


def render_image(
    render_chunk_fn: Callable,
    rays_o: np.ndarray,
    rays_d: np.ndarray,
    near: np.ndarray,
    far: np.ndarray,
    chunk: int,
    device="cuda",
):
    """Render arbitrarily many host rays by looping a fixed-size chunk:
    ``render_chunk_fn(rays_o, rays_d, near, far) -> (rgb, disp, acc)`` on
    (chunk,)-shaped tensors on ``device`` (it draws any jitter from its own
    generator).  Rays are padded to a chunk multiple with zeros; the
    padding is sliced off.  Returns host ``[rgb (N, 3), disp (N,), acc
    (N,)]``."""
    n = rays_o.shape[0]
    n_pad = -(-n // chunk) * chunk

    def pad(x):
        return np.concatenate(
            [x, np.zeros((n_pad - n,) + x.shape[1:], x.dtype)], axis=0)

    arrays = [pad(np.asarray(x, np.float32))
              for x in (rays_o, rays_d, near, far)]
    outs = []
    for i in range(0, n_pad, chunk):
        block = [torch.from_numpy(x[i:i + chunk]).to(device) for x in arrays]
        outs.append([o.cpu().numpy() for o in render_chunk_fn(*block)[:3]])
    return [np.concatenate([o[k] for o in outs], 0)[:n] for k in range(3)]
