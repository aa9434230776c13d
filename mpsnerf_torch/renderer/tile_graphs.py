"""The served view's query tail as CUDA graphs between its kernel launches.

A fine-mode tile of :func:`~mpsnerf_torch.renderer.render.render_rays_compact`
(every point in-body, its nearest-vertex ids given) runs
``MPSNeRF.query``'s plain path, which is a fixed sequence for a fixed tile:

* **A**: world -> target SMPL space and the inverse LBS to canonical;
* **K1**, eager: the canonical 1-NN (``knn.nearest_vertex``);
* **B**: the forward LBS to the source pose and the projection into each
  source camera (the normalized image coords);
* **K2** forward, eager, twice: the latent and the image rgb at those
  coords;
* **C**: the features' PE, the view-fusion transformer and the NeRF MLP:
  (rgb, sigma) a point.

A, B and C are ``MPSNeRF``'s own methods, the ones ``query``'s tail runs
(``_to_canonical`` after ``world_to_smpl``, ``_to_source_views``,
``_raw_from_views``), so the replayed tile and the eager one have one
definition.  They are captured once as CUDA graphs, at the first tile of a
source (after one eager run of the whole tile on the capture stream), and
each later tile replays them around the eager K1 and K2, so a tile makes
~12 launch calls instead of ~230.  K1 and K2 stay host launches through
their launchers (``knn.nearest_vertex_cuda``,
``grid_sample.grid_sample_patch_fwd_cuda``, looked up where they are
called), so whatever counts or wraps those launchers sees every call; each
K2 call gets coords of its own (a copy of B's output, which the next tile
overwrites).  A graph reads fixed addresses, so every input that changes
is copied into a buffer of the graphs' own: the view's two
:class:`PoseTransforms` once a view, a tile's points, view directions and
ids, and K1's and K2's outputs, once a tile.  The source's latent, images
and canonical vertices are read only by the eager K1 and K2, which take
the view's own tensors, and are never copied.  The graphs are keyed on
everything else they read by address (the source's cameras, the SMPL
blend weights, the model's parameters) and on the shapes that fix their
kernels; a change of key captures them again, and one source's graphs are
kept at a time.  The replay runs the same kernels in the same order on the
same values as the eager tile, so it is bit-equal to it.  A replayed
LayerNorm makes no host call: its launches are made once, at the capture.

:func:`graphable` says which tiles qualify: the plain ``MPSNeRF`` query
(no correction or skinning field, ``query`` not overridden) on a CUDA
device with autograd recording nothing.  Every other tile, and every tile
of a caller that keeps no :class:`TileGraphs`, runs ``query`` eagerly.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch

from mpsnerf_torch.models.mps_nerf import MPSNeRF
from mpsnerf_torch.ops import knn
from mpsnerf_torch.smpl.lbs import PoseTransforms, world_to_smpl


def graphable(model, device: torch.device) -> bool:
    """Whether a fine-mode tile query of ``model`` can replay as graphs."""
    return (device.type == "cuda" and not torch.is_grad_enabled()
            and isinstance(model, MPSNeRF)
            and type(model).query is MPSNeRF.query
            and not model.correction_field and not model.skinning_field)


# ---- the graphs ------------------------------------------------------------

class _Captured:
    """One source's graphs and the buffers they read and write."""

    def __init__(self, model, smpl, sp_input, latent, transforms, tile,
                 stream):
        self.model, self.smpl, self.sp, self.latent = (model, smpl, sp_input,
                                                       latent)
        self.stream = stream  # () -> the capture stream
        dev = latent.device
        v, c = latent.shape[:2]
        # normal tensors (not inference ones): written in place by calls
        # made in and out of inference mode
        with torch.inference_mode(False):
            self.tf_s, self.tf_t = (PoseTransforms(*(t.clone() for t in tf))
                                    for tf in transforms)
            self.pts = torch.empty(tile, 3, device=dev)
            self.vd = torch.empty(tile, 3, device=dev)
            self.ids = torch.empty(tile, dtype=torch.int64, device=dev)
            self.ids_c = torch.empty(tile, dtype=torch.int64, device=dev)
            # K2's outputs as the model reads them: (V, N, C) memory
            self.feats = torch.empty(v, tile, c, device=dev)
            self.rgb_s = (torch.empty(v, tile, sp_input["img_all"].shape[1],
                                      device=dev)
                          if model.append_rgb or model.blend_rgb else None)
        self.replays = None

    def set_transforms(self, transforms) -> None:
        torch._foreach_copy_(list(self.tf_s) + list(self.tf_t),
                             list(transforms[0]) + list(transforms[1]))

    def _stretches(self):
        """A, B and C on the buffers, each setting its output."""
        m, smpl = self.model, self.smpl

        def a():
            tf = self.tf_t
            self.can = m._to_canonical(
                smpl, tf, world_to_smpl(self.pts, tf.R, tf.Th), self.ids)

        def b():
            self.coords = m._to_source_views(smpl, self.tf_s, self.sp,
                                             self.can, self.ids_c)[-1]

        def c():
            rgb, alpha = m._raw_from_views(self.can, self.vd, self.feats,
                                           self.rgb_s)
            self.raw = torch.cat([rgb, alpha[:, None]], dim=-1)

        return a, b, c

    def _tile(self, a, b, c, t_buckets) -> None:
        """The tile on the buffers: A, K1, B, K2 twice, C."""
        a()
        _, ids_c = knn.nearest_vertex(self.can, self.sp["t_vertices"],
                                      t_buckets)
        self.ids_c.copy_(ids_c)
        b()
        # coords of this tile's own: a K2 call's may be kept after it
        feats, rgb_s = self.model._sample_views(self.sp, self.latent,
                                                self.coords.clone())
        self.feats.copy_(feats)
        if rgb_s is not None:
            self.rgb_s.copy_(rgb_s)
        c()

    def _capture(self, t_buckets) -> None:
        """Run the tile eagerly once on the inputs in the buffers, on the
        capture stream (every lazy set-up happens there, as torch's graphs
        want), then capture A, B and C into one memory pool."""
        dev, stream = self.latent.device, self.stream()
        stretches = self._stretches()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.inference_mode(False), torch.no_grad():
            with torch.cuda.stream(stream):
                self._tile(*stretches, t_buckets)
            torch.cuda.current_stream(dev).wait_stream(stream)
            pool = torch.cuda.graph_pool_handle()
            graphs = [torch.cuda.CUDAGraph() for _ in stretches]
            for graph, stretch in zip(graphs, stretches):
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    stretch()
        self.replays = [g.replay for g in graphs]

    def run(self, pts, viewdirs, ids, t_buckets, out) -> None:
        """One tile into ``out`` (N, 4)."""
        self.pts.copy_(pts)
        self.vd.copy_(viewdirs)
        self.ids.copy_(ids)
        if self.replays is None:
            self._capture(t_buckets)
        self._tile(*self.replays, t_buckets)
        out.copy_(self.raw)


class TileGraphs:
    """The query tail's graphs of one source at a time, kept by a caller
    that renders views repeatedly (``ViewRenderer``); ``tiles`` and
    ``graph_tiles`` count the tiles rendered with it and those replayed."""

    def __init__(self):
        self._key: Optional[Tuple] = None
        self._captured: Optional[_Captured] = None
        # one capture stream for every source: a stream that runs a cuBLAS
        # product keeps a workspace of its own for the process's life
        self._stream: Optional[torch.cuda.Stream] = None
        self.tiles = 0
        self.graph_tiles = 0

    @staticmethod
    def _key_of(model, smpl, sp_input, latent, tile) -> Tuple:
        def at(t):
            return t.data_ptr(), tuple(t.shape), t.stride(), t.dtype

        return (tile, id(model), latent.device,
                tuple(p.data_ptr() for p in itertools.chain(
                    model.parameters(), model.buffers())),
                at(smpl.weights),
                tuple(at(sp_input[k]) for k in ("R_all", "T_all", "K_all")),
                tuple(latent.shape), latent.stride(),
                tuple(sp_input["img_all"].shape))

    def _stream_on(self, device) -> torch.cuda.Stream:
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def bind(self, model, smpl, sp_input, latent, transforms, tile):
        """The view's tile runner ``run(pts, viewdirs, ids, t_buckets,
        out)``, its transforms in place; the graphs of another source are
        dropped first (captured again at this view's first tile).  The
        eager K1 and K2 read this call's ``sp_input`` and ``latent``."""
        key = self._key_of(model, smpl, sp_input, latent, tile)
        if key != self._key:
            self._key, self._captured = None, None
            self._captured = _Captured(
                model, smpl, sp_input, latent, transforms, tile,
                lambda: self._stream_on(latent.device))
            self._key = key
        else:
            self._captured.set_transforms(transforms)
            self._captured.sp, self._captured.latent = sp_input, latent
        return self._captured.run
