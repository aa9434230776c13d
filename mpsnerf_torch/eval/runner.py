"""Whole-view rendering and the eval entry points (port of
``mpsnerf_tpu/eval/runner.py``): the synthetic protocol, THuman's
``test_THuman_ssim`` (held-out humans 25-29 of the list, start poses
[20, 24, 27, 25, 28], novel views [1, 5, 7, 11, 13, 17, 19, 23]), H36M's
``test_H36M`` (per-subject pose tables, novel view camera 3,
masked-ray rendering, the unmasked image as the ground truth) and the
reference's inline ``test`` for every other data set
(:func:`run_legacy_test`: every 12th view, side-by-side PNGs, the sweep
videos).

:class:`ViewRenderer` renders a target view conditioned on a source item
on one of two paths:

- the global path (the default; ``n_importance == 0``): the box cull
  (only rays that hit the body's AABB run, the rest provably composite to
  the background), the latent encoded once and cached on the source item,
  the plan pre-pass, the capacity rounded up to a multiple of the tile,
  the fine pre-pass (exact 5 cm mask and nearest-vertex ids; ``fine``),
  the render, and the scatter of the rendered rays into the full image;
- the chunked path (``global_compact=False``, ``n_importance > 0``, or a
  model without ``MPSNeRF``'s human-region mask: ``human_sample`` off, or
  the numpy-era ``CorrectionF3D``/``CorrectionUvhAgg``, which evaluate
  every sample and so have neither the global path nor the box cull):
  the rays, shuffled by a fixed permutation, in chunks of
  ``chunk`` through :func:`render_rays` at ``eval_compact_fraction``; a
  chunk that dropped points renders again uncompacted.

A model with a correction field reads the sparse-conv plan of the target
and source items (and of their canonical grids, ``canonical_grid``); it is
attached to an item that has none.

The JAX runner's capacity ladder and power-of-two ray padding exist so
that XLA compiles few shapes; nothing compiles here, so capacities are the
exact counts rounded up to the tile and rays are not padded (the pixels
depend on neither).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpsnerf_torch.data import (
    attach_body_grid,
    attach_spconv_plan,
    to_device_input,
)
from mpsnerf_torch.eval.protocol import evaluate_novel_view_pose
from mpsnerf_torch.models.mps_nerf import MPSNeRF
from mpsnerf_torch.renderer.render import (
    fine_rays_compact,
    plan_rays_compact,
    render_rays,
    render_rays_compact,
)
from mpsnerf_torch.renderer.tile_graphs import TileGraphs
from mpsnerf_torch.smpl.lbs import PoseTransforms
from mpsnerf_torch.utils import spans

_RAY_KEYS = ("ray_o_all", "ray_d_all", "near_all", "far_all")

THUMAN_NOVEL_VIEWS = [1, 5, 7, 11, 13, 17, 19, 23]
THUMAN_START_POSES = [20, 24, 27, 25, 28]
THUMAN_TEST_RANGE = (25, 30)

# test_H36M's per-subject tables for S1..S11: pose counts, novel-view
# window sizes, input poses and novel-pose start frames
H36M_SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]
H36M_ROOTS = [f"./data/h36m/{s}/Posing" for s in H36M_SUBJECTS]
H36M_POSES_NUM = [49, 127, 83, 200, 87, 133, 82]
H36M_NOVEL_VIEW_POSES_NUM = [150, 250, 150, 300, 250, 260, 200]
H36M_INPUT_POSE = [250, 30, 1050, 820, 370, 20, 20]
H36M_START_POSE = [750, 1250, 750, 1500, 1250, 1300, 1000]
H36M_NOVEL_VIEW = [3]


class DatasetWindow:
    """Lazy item sequence over a dataset window: eval protocols iterate
    items once, and building hundreds of full-resolution items up front
    would need tens of GB."""

    def __init__(self, dataset, n: int):
        self.dataset = dataset
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self.n)
            if step != 1:
                raise ValueError("DatasetWindow slices take step 1")
            return _ShiftedWindow(self, start, stop)
        if not 0 <= i < self.n:
            raise IndexError(i)
        return self.dataset[i]

    def __iter__(self):
        for i in range(self.n):
            yield self[i]


class _ShiftedWindow:
    def __init__(self, base, start, stop):
        self.base, self.start, self.stop = base, start, stop

    def __len__(self):
        return self.stop - self.start

    def __iter__(self):
        for i in range(self.start, self.stop):
            yield self.base[i]


class ViewStats(NamedTuple):
    """Diagnostics of the last finished view (``ViewRenderer.last_view``)."""

    acc: np.ndarray          # (H*W,) accumulated opacity (0 where not run)
    n_dropped: int           # points the compacted renders dropped: 0 on
    #                          the global path; on the chunked path each
    #                          such chunk rendered again uncompacted
    hit_rays: int            # rays that ran (after the box cull / mask)
    n_candidates: int        # global path: body-grid candidate samples
    capacity: int            # global path: candidate buffer
    n_body: int              # global path (fine): samples within 5 cm
    fine_capacity: int       # global path (fine): body-point buffer
    n_overflow_chunks: int   # chunked path: chunks rendered again


class _PendingView:
    """Handle of :meth:`ViewRenderer.render_view_async`.  ``done``: the
    finished (H*W, 3) image (chunked path); otherwise ``out`` holds the
    global path's device outputs (rgb, acc, n_dropped), fetched in
    :meth:`ViewRenderer.finish_view`."""

    __slots__ = ("out", "sel", "n_total", "done", "fill", "stats")

    def __init__(self, out=None, sel=None, n_total=0, done=None, fill=0.0,
                 stats=None):
        self.out = out
        self.sel = sel
        self.n_total = n_total
        self.done = done
        # background value for box-culled rays: they miss the body's box,
        # so they would composite to the exact background (1.0 under
        # white_bkgd, else 0.0); rays outside an explicit mask get 0
        self.fill = fill
        self.stats = stats


def _scatter(values: np.ndarray, sel: Optional[np.ndarray], n_total: int,
             fill: float) -> np.ndarray:
    if sel is None:
        return values
    full = np.full((n_total,) + values.shape[1:], fill, np.float32)
    full[sel] = values
    return full


def view_rays(item: Dict, k: int, device, ray_mask=None):
    """View ``k``'s rays (only those of ``ray_mask`` where given) as
    tensors on ``device``: ``((rays_o, rays_d, near, far), selected pixel
    indices or None, pixel count)``."""
    rays = [np.asarray(item[key][k], np.float32).reshape(
        (-1, 3) if key in ("ray_o_all", "ray_d_all") else (-1,))
        for key in _RAY_KEYS]
    n_total = rays[0].shape[0]
    sel = None
    if ray_mask is not None:
        sel = np.flatnonzero(np.asarray(ray_mask).reshape(-1))
        rays = [x[sel] for x in rays]
    return ([torch.from_numpy(np.ascontiguousarray(x)).to(device)
             for x in rays], sel, n_total)


class ViewRenderer:
    """Renders full views of a target item conditioned on a source item
    (see the module docstring for the two paths).

    Rays are shuffled with a fixed permutation before chunking: scan order
    makes chunk validity bimodal (body chunks run up to ~40 % in-body
    samples), and shuffled chunks sit near the view's mean.  The JAX
    package sized ``eval_compact_fraction`` (0.125) for the ~6 % mean of
    full-image rays; the box cull keeps only rays that hit the body's box,
    whose share is about twice that, so at 512^2 most chunks overflow and
    render again uncompacted (exact, slower; ``n_overflow_chunks``).

    The state a render derives from an item is cached on the item under
    ``DERIVED_KEYS``: its device tensors and (the source's) latent.
    """

    DERIVED_KEYS = ("_torch_cache", "_latent_cache")

    def __init__(
        self,
        model: MPSNeRF,
        smpl_selector: Callable,  # gender int -> SMPLModel
        chunk: int = 4096,
        n_samples: int = 128,
        n_importance: int = 0,
        white_bkgd: bool = False,
        eval_compact_fraction: Optional[float] = 0.125,
        shuffle_rays: bool = True,
        global_compact: bool = True,
        tile: int = 16384,
        fine: bool = True,      # the exact-mask pre-pass of the global path
        box_cull: bool = True,  # render only the rays that hit the body box
        device="cuda",
    ):
        self.device = torch.device(device)
        model = model.to(self.device).eval()
        self.model = model
        # the global path's plan covers only the stratified z ladder, so
        # the hierarchical union takes the chunked path; the global path
        # and the box cull both rest on MPSNeRF's 5 cm mask (its -80 fill,
        # and the fine pre-pass's nearest-vertex ids), which a model
        # without the mask, or another model (the numpy-era correction
        # family evaluates every sample), does not have
        masked = isinstance(model, MPSNeRF) and model.human_sample
        self.global_compact = global_compact and n_importance == 0 and masked
        self.fine = fine
        self.box_cull = box_cull and masked
        self.smpl_selector = smpl_selector
        self.chunk = chunk
        self.n_samples = n_samples
        self.n_importance = n_importance
        self.white_bkgd = white_bkgd
        self.shuffle_rays = shuffle_rays
        self.tile = tile
        # the chunked path's model at the eval fraction, and uncompacted for
        # a chunk that overflows it (exact at any in-body density)
        self._model_c = model
        if (eval_compact_fraction is not None
                and model.compact_fraction is not None):
            self._model_c = model.with_compact_fraction(eval_compact_fraction)
        self._model_nc = (model if model.compact_fraction is None
                          else model.with_compact_fraction(None))
        self.n_overflow_chunks = 0  # across renders
        # the global path's query tail as CUDA graphs, one source's at a
        # time (renderer/tile_graphs.py)
        self._tile_graphs = TileGraphs()
        self.last_view: Optional[ViewStats] = None

    def _round_up(self, count: int) -> int:
        return max(1, -(-count // self.tile)) * self.tile

    def _device_side(self, item: Dict) -> Dict:
        """The item's device tensors, cached on the item (rebuilt when
        the item gained keys, e.g. a body grid)."""
        need = {k for k in item if not k.startswith("_")}
        cached = item.get("_torch_cache")
        if cached is None or cached[0] != self.device or not need <= cached[2]:
            cached = (self.device, to_device_input(item, self.device), need)
            item["_torch_cache"] = cached
        return cached[1]

    def _latent_for(self, sp_item: Dict, sp: Dict) -> torch.Tensor:
        """The source's latent, encoded once and cached on the item (not
        by id(): a lazy window's freed items reuse addresses)."""
        cached = sp_item.get("_latent_cache")
        if cached is None or cached.device != self.device:
            with torch.no_grad():
                cached = self.model.encode(sp["img_all"])
            sp_item["_latent_cache"] = cached
        return cached

    def _view_ray_mask(self, tp_item: Dict, k: int, ray_mask=None):
        """The rays to run: an explicit mask, else (``box_cull``) the rays
        that hit the body's box, which alone can leave the background."""
        if ray_mask is None and self.box_cull and "mask_at_box_all" in tp_item:
            return np.asarray(tp_item["mask_at_box_all"][k]).reshape(-1)
        return ray_mask

    def device_items(self, sp_item: Dict, tp_item: Dict) -> Tuple:
        """``(smpl, sp, tp, latent)`` on the device for a source and a
        target item: the body grid and (with a correction field) the
        sparse-conv plans attached to items that have none, the device
        tensors and the latent cached on the items."""
        if "body_grid" not in tp_item:
            attach_body_grid(tp_item)
        if self.model.correction_field:
            canonical = bool(getattr(self.model, "canonical_grid", False))
            for it in (tp_item, sp_item):
                if "spconv_plan" not in it or (canonical
                                               and "t_spconv_plan" not in it):
                    attach_spconv_plan(it, canonical=canonical)
        sp = self._device_side(sp_item)
        tp = self._device_side(tp_item)
        smpl = self.smpl_selector(int(sp_item["gender"])).to(self.device)
        return smpl, sp, tp, self._latent_for(sp_item, sp)

    def _prep_view(self, sp_item: Dict, tp_item: Dict, k: int, ray_mask):
        with spans.span("view.prepare"):
            smpl, sp, tp, latent = self.device_items(sp_item, tp_item)
            rays, sel, n_total = view_rays(tp_item, k, self.device, ray_mask)
        return smpl, sp, tp, latent, rays, sel, n_total

    def _prepasses(self, smpl, tp, rays, extra: int = 0) -> Tuple:
        """The plan and (``fine``) fine pre-passes over the device rays, at
        capacities ``extra`` tiles above the counts; their two
        ``n_valid`` reads are the global path's only reads of the device
        before the fetch.  The target pose's transforms are built once
        here, for the pre-passes and the render.  Returns ``(plan,
        fine_plan, fine_ids, count, capacity, n_body, fine_capacity,
        tf_t)``."""
        with spans.span("view.prepass"):
            n, ns, add = rays[0].shape[0], self.n_samples, extra * self.tile
            tf_t = PoseTransforms.create(smpl, tp["params"])
            plan = plan_rays_compact(smpl, tp, *rays, ns,
                                     cap_max=self._round_up(n * ns) + add,
                                     tf_t=tf_t)
            count = spans.host_read(plan.n_valid, "prepass.candidates")
            cap = self._round_up(count) + add
            if not self.fine:
                return plan, None, None, count, cap, 0, 0, tf_t
            fplan, fids = fine_rays_compact(smpl, tp, *rays, ns, plan, cap,
                                            tf_t=tf_t)
            n_body = spans.host_read(fplan.n_valid, "prepass.body")
        return (plan, fplan, fids, count, cap, n_body,
                self._round_up(n_body) + add, tf_t)

    def _render_global(self, smpl, sp, tp, latent, rays, pre):
        plan, fplan, fids, _, cap, _, fcap, tf_t = pre
        g = self._tile_graphs
        with spans.span("view.tail") as span:
            tiles, graph_tiles = g.tiles, g.graph_tiles
            rgb, _, acc, nd = render_rays_compact(
                self.model, smpl, sp, tp, latent, *rays, self.n_samples,
                capacity=cap, tile=self.tile, fine_capacity=fcap,
                white_bkgd=self.white_bkgd, plan=plan, fine_plan=fplan,
                fine_ids=fids, tf_t=tf_t, graphs=g)
            if span is not None:
                span.attrs.update(tiles=g.tiles - tiles,
                                  graph_tiles=g.graph_tiles - graph_tiles)
        return rgb, acc, nd

    def prewarm(self, sp_item: Dict, tp_item: Dict, k: int = 0,
                extra_buckets: int = 1) -> List[Tuple[int, int]]:
        """Run view ``k``'s pre-passes and its render before a timed loop,
        so that every lazy initialisation (the kernels' build and load, the
        cuBLAS/cuDNN handles, the allocator's pools, the cached latent)
        happens here; ``extra_buckets`` more runs at capacities one tile
        further up each warm the pools for the larger views that follow.
        Returns the ``(capacity, fine_capacity)`` pairs it ran; [] on the
        chunked path."""
        if not self.global_compact:
            return []
        smpl, sp, tp, latent, rays, _, _ = self._prep_view(
            sp_item, tp_item, k, self._view_ray_mask(tp_item, k))
        if rays[0].shape[0] == 0:
            return []
        warmed = []
        with torch.no_grad():
            for extra in range(extra_buckets + 1):
                pre = self._prepasses(smpl, tp, rays, extra)
                self._render_global(smpl, sp, tp, latent, rays, pre)
                warmed.append((pre[4], pre[6]))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed

    def render_view_async(self, sp_item: Dict, tp_item: Dict, k: int,
                          ray_mask: Optional[np.ndarray] = None):
        """Start the render of target view ``k`` and return a handle for
        :meth:`finish_view`.  On the global path the render is queued on
        the device and its image is not fetched, so a caller can start
        view k+1 before finishing view k and overlap its host work (the
        fetch, metrics, PNGs) with the device's render; the only reads
        of the device are the pre-passes' two counts.  The chunked path
        completes inside this call."""
        explicit_mask = ray_mask is not None
        ray_mask = self._view_ray_mask(tp_item, k, ray_mask)
        fill = 1.0 if (self.white_bkgd and not explicit_mask) else 0.0
        return self._start(*self._prep_view(sp_item, tp_item, k, ray_mask),
                           fill)

    def render_rays(self, sp_item: Dict, tp_item: Dict, rays_o, rays_d,
                    near, far) -> np.ndarray:
        """Render arbitrary rays (host (N, 3), (N, 3), (N,), (N,)) of
        ``tp_item``'s pose conditioned on ``sp_item``: (N, 3) f32 on the
        host, on the renderer's path (no box cull: every ray runs)."""
        rays = [torch.from_numpy(np.ascontiguousarray(x, np.float32).reshape(
            shape)).to(self.device) for x, shape in zip(
                (rays_o, rays_d, near, far), ((-1, 3), (-1, 3), (-1,), (-1,)))]
        return self.finish_view(self._start(
            *self.device_items(sp_item, tp_item), rays, None,
            rays[0].shape[0], 0.0))

    def _start(self, smpl, sp, tp, latent, rays, sel, n_total, fill
               ) -> _PendingView:
        n = rays[0].shape[0]
        if n == 0:
            self.last_view = ViewStats(np.zeros(n_total, np.float32),
                                       0, 0, 0, 0, 0, 0, 0)
            return _PendingView(done=np.full((n_total, 3), fill, np.float32))
        if self.global_compact:
            with torch.no_grad():
                pre = self._prepasses(smpl, tp, rays)
                out = self._render_global(smpl, sp, tp, latent, rays, pre)
            count, cap, n_body, fcap = pre[3:7]
            return _PendingView(out=out, sel=sel, n_total=n_total, fill=fill,
                                stats=(n, count, cap, n_body, fcap))
        return self._render_view_chunked(smpl, sp, tp, latent, rays, sel,
                                         n_total, fill)

    def finish_view(self, pending: _PendingView) -> np.ndarray:
        """The (H*W, 3) image of a :meth:`render_view_async` handle."""
        if pending.done is not None:
            return pending.done
        with spans.span("view.fetch"):
            rgb, acc, nd = pending.out
            n_dropped = spans.host_read(nd, "fetch.dropped")
            # the render consumes the pre-passes' own plans at capacities
            # that cover their counts, so nothing can drop
            assert n_dropped == 0, (n_dropped,) + pending.stats
            rgb = spans.host_read(rgb, "fetch.rgb").numpy()
            acc = spans.host_read(acc, "fetch.acc").numpy()
            self.last_view = ViewStats(
                _scatter(acc, pending.sel, pending.n_total, 0.0), n_dropped,
                *pending.stats, 0)
            return _scatter(rgb, pending.sel, pending.n_total, pending.fill)

    def render_view(self, sp_item: Dict, tp_item: Dict, k: int,
                    ray_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Render target view ``k`` of ``tp_item`` conditioned on
        ``sp_item``: an (H*W, 3) float32 host array.  ``ray_mask`` renders
        only the masked rays (H36M's masked-ray mode); pixels outside an
        explicit mask are 0, pixels skipped by the box cull the
        background.  ``last_view`` then holds the view's diagnostics."""
        return self.finish_view(
            self.render_view_async(sp_item, tp_item, k, ray_mask))

    def _chunk(self, model, smpl, sp, tp, latent, block):
        out = render_rays(
            model, smpl, sp, tp, latent, *block, self.n_samples,
            perturb=0.0, train=False, white_bkgd=self.white_bkgd,
            n_importance=self.n_importance)
        return out.rgb_map, out.acc_map, spans.host_read(
            out.raw.n_dropped, "chunk.dropped")

    def _render_view_chunked(self, smpl, sp, tp, latent, rays, sel, n_total,
                             fill) -> _PendingView:
        """The chunked path, with the overflow guard: synchronous."""
        perm = None
        if self.shuffle_rays:
            perm = np.random.default_rng(0).permutation(rays[0].shape[0])
            idx = torch.from_numpy(perm).to(self.device)
            rays = [x[idx] for x in rays]
        n = rays[0].shape[0]
        # no padding to a chunk multiple (nothing compiles per shape): the
        # JAX runner's zero rays put every sample at the origin, which can
        # overflow the last chunk's compaction on their own
        rgbs, accs = [], []
        dropped = overflows = 0
        for i in range(0, n, self.chunk):
            block = [x[i:i + self.chunk] for x in rays]
            rgb, acc, nd = self._chunk(self._model_c, smpl, sp, tp, latent,
                                       block)
            if nd > 0:
                # a compaction overflow zeroes valid samples: render the
                # chunk again uncompacted (exact)
                overflows += 1
                dropped += nd
                print(f"[eval] compaction overflow ({nd} pts) in chunk "
                      f"{i // self.chunk}; re-rendering uncompacted")
                rgb, acc, _ = self._chunk(self._model_nc, smpl, sp, tp,
                                          latent, block)
            rgbs.append(rgb)
            accs.append(acc)
        self.n_overflow_chunks += overflows
        rgb = spans.host_read(torch.cat(rgbs), "fetch.rgb").numpy()
        acc = spans.host_read(torch.cat(accs), "fetch.acc").numpy()
        if perm is not None:
            rgb[perm], acc[perm] = rgb.copy(), acc.copy()
        self.last_view = ViewStats(_scatter(acc, sel, n_total, 0.0), dropped,
                                   n, 0, 0, 0, 0, overflows)
        return _PendingView(done=_scatter(rgb, sel, n_total, fill))


def run_synthetic_eval(args, model: MPSNeRF, smpl_selector: Callable,
                       savedir: str, dataset, verbose: bool = True,
                       device="cuda") -> Dict:
    """The protocol on the synthetic dataset: novel pose and novel view
    over the cameras that are not inputs, with the protocol's depth-1
    pipeline.  ``args`` come from ``mpsnerf_torch.config.parse_args``."""
    H = W = dataset.H
    test_ds = type(dataset)(
        n_poses=max(2, dataset.n_poses), n_cameras=len(dataset.cameras),
        input_views=dataset.input_view, image_size=H,
        n_rays=64, n_verts=dataset.subjects[0]["smpl"].n_verts,
        num_instances=dataset.num_instances, split="test",
    )
    novel_views = [
        v for v in test_ds.output_view if v not in test_ds.input_view
    ] or test_ds.output_view[:1]

    renderer = ViewRenderer(
        model, smpl_selector, chunk=min(args.chunk, 8192),
        n_samples=args.N_samples,
        n_importance=args.N_importance, white_bkgd=args.white_bkgd,
        device=device,
    )
    humans = {}
    for inst in range(test_ds.num_instances):
        items = [test_ds.get_item(i, instance_idx=inst)
                 for i in range(test_ds.n_poses)]
        humans[f"synthetic_{inst}"] = {
            "novel_pose": items, "novel_view": items[:-1] or items,
        }
    return evaluate_novel_view_pose(
        renderer.render_view, humans, novel_views, H, W, savedir,
        verbose=verbose,
        render_async=(renderer.render_view_async, renderer.finish_view),
    )


def run_thuman_eval(args, model: MPSNeRF, smpl_selector: Callable,
                    savedir: str, dataset_cls=None, verbose: bool = True,
                    poses_num: int = 5, image_hw: int = 512,
                    device="cuda") -> Dict:
    """``test_THuman_ssim`` over the held-out humans: the names
    ``THUMAN_TEST_RANGE`` of ``data/THuman_1_human_list.txt`` (relative to
    the working directory), siblings of ``args.data_root``.  Per human, the
    novel-pose pass from its start pose (the source, then ``poses_num``
    targets) and the novel-view pass over poses 0.. ``poses_num`` - 1, each
    over the novel views, pipelined.  ``image_hw`` is the square frame the
    renders are read as (512 in the reference)."""
    if dataset_cls is None:
        from mpsnerf_torch.data.thuman import THumanDatasetBatch as dataset_cls

    with open("data/THuman_1_human_list.txt") as f:
        names = [x.strip() for x in
                 f.readlines()[THUMAN_TEST_RANGE[0]:THUMAN_TEST_RANGE[1]]]
    all_root = os.path.dirname(args.data_root)

    renderer = ViewRenderer(
        model, smpl_selector, chunk=args.chunk, n_samples=args.N_samples,
        n_importance=getattr(args, "N_importance", 0),
        white_bkgd=args.white_bkgd, device=device)

    humans, start_poses = {}, {}
    for name, start in zip(names, THUMAN_START_POSES):
        root = os.path.join(all_root, name)
        common = dict(split=args.test_split, view_num=args.view_num,
                      model=args.model, male=args.male,
                      mean_shape=args.mean_shape, multi_person=False)
        ds_pose = dataset_cls(root, start=start, interval=1,
                              poses_num=poses_num + 1, **common)
        ds_view = dataset_cls(root, start=0, interval=1,
                              poses_num=poses_num, **common)
        humans[name] = {
            "novel_pose": DatasetWindow(ds_pose, poses_num + 1),
            "novel_view": DatasetWindow(ds_view, poses_num),
        }
        start_poses[name] = start

    first = next(iter(humans.values()))["novel_view"][0]
    caps = renderer.prewarm(first, first, k=THUMAN_NOVEL_VIEWS[0])
    if verbose and caps:
        print(f"[eval] prewarmed (capacity, fine) pairs: {caps}")

    return evaluate_novel_view_pose(
        renderer.render_view, humans, THUMAN_NOVEL_VIEWS, image_hw,
        image_hw, savedir, start_poses=start_poses, verbose=verbose,
        render_async=(renderer.render_view_async, renderer.finish_view))


class _SourceThenWindow:
    """Novel-pose items: the source item first, then the window."""

    def __init__(self, sp_item, window):
        self.sp_item = sp_item
        self.window = window

    def __len__(self):
        return 1 + len(self.window)

    def __getitem__(self, i):
        if isinstance(i, slice):
            if i != slice(1, None):
                raise ValueError("only [1:] slices the window")
            return self.window
        return self.sp_item if i == 0 else self.window[i - 1]


def run_h36m_eval(args, model: MPSNeRF, smpl_selector: Callable,
                  savedir: str, dataset_cls=None, verbose: bool = True,
                  image_hw: int = 1000, device="cuda") -> Dict:
    """``test_H36M`` for the subject ``args.test_persons``: novel view
    camera 3 at 1000 x 1000, only the rays of ``mask_at_box`` rendered,
    the ground truth the unmasked image ``o_img_all``.  ``image_hw`` is
    the square frame the renders are read as (1000 in the reference; a
    ``dataset_cls`` that scales its images sets another)."""
    if dataset_cls is None:
        from mpsnerf_torch.data.h36m import H36MDatasetBatch as dataset_cls

    p = int(args.test_persons)
    name, root = H36M_SUBJECTS[p], H36M_ROOTS[p]
    common = dict(split=args.test_split, view_num=args.view_num,
                  mean_shape=args.mean_shape, new_mask=args.new_mask,
                  multi_person=False)
    sp_ds = dataset_cls(root, start=H36M_INPUT_POSE[p], interval=1,
                        poses_num=1, **common)
    pose_ds = dataset_cls(root, start=H36M_START_POSE[p], interval=5,
                          poses_num=H36M_POSES_NUM[p], **common)
    view_ds = dataset_cls(root, start=0, interval=5,
                          poses_num=H36M_NOVEL_VIEW_POSES_NUM[p], **common)
    humans = {name: {
        "novel_pose": _SourceThenWindow(
            sp_ds[0], DatasetWindow(pose_ds, H36M_POSES_NUM[p])),
        "novel_view": DatasetWindow(view_ds, H36M_NOVEL_VIEW_POSES_NUM[p]),
    }}

    # the masked rays are the box's, whose in-body share is train-like
    # (~20-40 %), not the full image's ~6 %: the chunked path's fraction
    # follows
    renderer = ViewRenderer(
        model, smpl_selector, chunk=args.chunk, n_samples=args.N_samples,
        n_importance=getattr(args, "N_importance", 0),
        white_bkgd=args.white_bkgd, eval_compact_fraction=0.5,
        device=device)

    def dispatch(sp, tp, k):
        mask = np.asarray(tp["mask_at_box_all"][k])
        return renderer.render_view_async(sp, tp, k, ray_mask=mask)

    def render_view(sp, tp, k):
        return renderer.finish_view(dispatch(sp, tp, k))

    first = humans[name]["novel_view"][0]
    caps = renderer.prewarm(first, first, k=H36M_NOVEL_VIEW[0])
    if verbose and caps:
        print(f"[eval] prewarmed (capacity, fine) pairs: {caps}")

    def gt_fn(item, k):
        return np.asarray(item["o_img_all"][k]).transpose(1, 2, 0)

    return evaluate_novel_view_pose(
        render_view, humans, H36M_NOVEL_VIEW, image_hw, image_hw, savedir,
        start_poses={name: H36M_START_POSE[p]}, verbose=verbose,
        gt_fn=gt_fn, render_async=(dispatch, renderer.finish_view))


def run_legacy_test(args, model, smpl_selector: Callable, savedir: str,
                    items, view_interval: int = 12, H: int = 512,
                    W: int = 512, data_interval: int = 1,
                    start_pose: int = 0, device="cuda") -> float:
    """The reference's inline ``test``: every ``view_interval``-th view of
    each item rendered with the first item as the source; per view a PNG
    of the source's input views (resized, as ``cv2.resize`` does, to the
    width of) pred | gt side by side, named ``{source:02d}_{target:02d}_
    {view:02d}.png``, and ``frame{f:04d}_view{k:04d}[_gt].png``; then
    ``psnr_<100 x mean>.npy`` and the novel-pose and novel-view sweep
    videos.  Returns the mean PSNR over ``mask_at_box``."""
    from mpsnerf_torch.data.imageio import LINEAR, resize
    from mpsnerf_torch.eval.metrics import psnr_metric
    from mpsnerf_torch.eval.protocol import encode_png, to8b
    from mpsnerf_torch.eval.video import write_sweep_videos

    def imwrite(name, img8):
        with open(os.path.join(savedir, name), "wb") as f:
            f.write(encode_png(img8))

    os.makedirs(savedir, exist_ok=True)
    renderer = ViewRenderer(
        model, smpl_selector, chunk=args.chunk, n_samples=args.N_samples,
        n_importance=getattr(args, "N_importance", 0),
        white_bkgd=args.white_bkgd, device=device)
    total_psnr, num = 0.0, 0
    sp_item = items[0]
    strip = to8b(np.concatenate(
        [np.transpose(v, (1, 2, 0)) for v in np.asarray(sp_item["img_all"])],
        axis=1))
    src = int(sp_item["pose_index"])
    # the strip at the side-by-side's width (2 W)
    top = resize(strip, (2 * W, int(strip.shape[0] * 2 * W
                                    / strip.shape[1])), LINEAR)
    for item in items:
        tgt = int(item["pose_index"])
        for k in range(0, item["rgb_all"].shape[0], view_interval):
            pred = renderer.render_view(sp_item, item, k).reshape(H, W, 3)
            gt = np.asarray(item["rgb_all"][k]).reshape(H, W, 3)
            mask = np.asarray(item["mask_at_box_all"][k]).reshape(H, W) > 0
            psnr = psnr_metric(pred[mask], gt[mask])
            total_psnr += psnr
            num += 1
            print("[Test] Source:", src, " Target:", tgt, " View:", k,
                  " PSNR: ", round(psnr, 3))
            side = np.concatenate([to8b(pred), to8b(gt)], axis=1)
            imwrite(f"{src:02d}_{tgt:02d}_{k:02d}.png",
                    np.concatenate([top, side], axis=0))
            frame = tgt * data_interval + start_pose
            imwrite(f"frame{frame:04d}_view{k:04d}.png", to8b(pred))
            imwrite(f"frame{frame:04d}_view{k:04d}_gt.png", to8b(gt))
    avg = total_psnr / max(num, 1)
    np.save(os.path.join(savedir, f"psnr_{int(avg * 100)}.npy"),
            np.array(avg))
    write_sweep_videos(savedir, novel_pose_suffix=f"_{view_interval:02d}.png",
                       novel_view_prefix="00_00_")
    return avg
