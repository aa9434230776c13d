"""The sharded render of a served bundle (the counterpart of the JAX
bundle's ``_sharded_fn``, ``mpsnerf_tpu/serve/bundle.py``).

The JAX bundle exports one graph over a 1-D ``"ray"`` mesh of the local
devices.  Here the mesh is ``shard_devices`` ranks that
:class:`~mpsnerf_torch.parallel.launch.RankPool` starts on the first
sharded request and keeps until :meth:`ShardedRanks.close`; the serving
process joins no process group.  Each rank loads the bundle on its own
device (``cuda:{rank % device_count}``, or the CPU), builds a 1-D ray
:class:`~mpsnerf_torch.parallel.mesh.Mesh` and renders blocks of
``shard_rays`` rays with ``make_sharded_render`` (strided shards, one
``all_reduce``), as JAX's sharded graph does.

A request reaches rank 0 whole (the items' device arrays, only for the
content keys the ranks do not hold, and the padded rays); every other rank
gets a small header.  Rank 0 attaches the items' derived state (body grid,
sparse-conv plans), encodes the source once and broadcasts the items over
the mesh's CPU group and the latent over the default group; then, per
block, it broadcasts the block's rays and every rank renders its shard.
The ranks keep the items, their device tensors and the latent in an LRU
cache of the served item cache's bound, which the serving process mirrors,
so an item crosses once per content key.  A block whose ranks drop
compaction samples renders again on the same ranks with the model
uncompacted (the JAX graph drops them); it counts as an overflow chunk.

Only ``broadcast`` and ``all_reduce`` touch device tensors: gloo, which
ranks that share a GPU use, supports little else for CUDA tensors.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mpsnerf_torch.parallel.launch import RankFailed, RankPool

__all__ = ["SHARD_TIMEOUT_S", "ShardedRanks", "pad_rays_far", "shard_rank"]

SIDES = ("sp", "tp")
# each collective's wait on the ranks, and a request's deadline per block
SHARD_TIMEOUT_S = 300.0


def pad_rays_far(rays: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad (N, 8) rays (origin, direction, near, far) to ``n_pad`` rows with
    rays far outside the body grid (the JAX bundle's ``_pad_rays_far``):
    they have no candidate sample, so padding takes no compaction
    capacity, and their direction (1, 0, 0) keeps the view directions
    finite."""
    n = rays.shape[0]
    if n_pad < n:
        raise ValueError(f"{n} rays exceed the padded size {n_pad}")
    pad = np.zeros((n_pad - n, 8), np.float32)
    pad[:, :3] = 1e6
    pad[:, 3] = 1.0
    pad[:, 7] = 1.0
    return np.concatenate([rays.astype(np.float32), pad])


def _lru_touch(order: collections.OrderedDict, key: str, value,
               bound: int) -> None:
    order[key] = value
    order.move_to_end(key)
    while len(order) > bound:
        order.popitem(last=False)


def _broadcast_tensor(t: Optional[torch.Tensor], meta, device
                      ) -> torch.Tensor:
    """Rank 0's dense tensor ``t`` on every rank with its strides (a
    channels-last latent stays channels-last); ``meta`` = ``(shape,
    strides, dtype name)``, known to every rank.  Goes as the contiguous
    permutation of its memory order."""
    shape, strides, dtype = meta
    order = sorted(range(len(shape)), key=lambda d: -strides[d])
    inverse = [order.index(d) for d in range(len(shape))]
    if t is None:
        buf = torch.empty([shape[d] for d in order],
                          dtype=getattr(torch, dtype), device=device)
    else:
        buf = t.permute(order).contiguous()
    dist.broadcast(buf, src=0)
    return buf.permute(inverse)


class _ShardRank:
    """One rank's handler: the bundle on this rank's device, the 1-D ray
    mesh, the render with and without compaction, the item cache."""

    def __init__(self, bundle_dir: str, cache_max: int):
        from mpsnerf_torch.parallel.mesh import (
            DIST, RAY_AXIS, make_mesh, make_sharded_render,
        )
        from mpsnerf_torch.serve.bundle import ServedRenderer

        self.rank = DIST["rank"]
        self.served = s = ServedRenderer(bundle_dir, device=DIST["device"])
        self.device = s.device
        self.mesh = make_mesh(RAY_AXIS, self.device)
        self.block = int(s.manifest["shard_rays"])
        self.views = s._views[False]
        n_samples = int(s.manifest["n_samples"])
        self.render = {
            compact: make_sharded_render(
                model, self.mesh, n_samples, chunk=s.chunk,
                white_bkgd=s.white_bkgd)
            for compact, model in ((True, s.model), (False, s._model_mesh))}
        self.cache: collections.OrderedDict = collections.OrderedDict()
        self.cache_max = cache_max

    def __call__(self, msg: Dict):
        if msg["op"] == "call":
            return msg["fn"](*msg["args"])
        with torch.inference_mode():
            return self._render(msg)

    def _items(self, msg: Dict):
        """The request's items on this rank, their device tensors and the
        latent: from the cache, or rank 0's broadcast."""
        new = [side for side in SIDES if msg[side] not in self.cache]
        if new != list(msg["send"]):
            raise RuntimeError(f"the ranks' item cache lacks {new}, the "
                               f"server sent {msg['send']}")
        items = {side: self.cache.get(msg[side]) for side in SIDES}
        primary = self.rank == 0
        if primary:
            items.update({side: dict(msg["items"][side]) for side in new})
            out = self.views.device_items(items["sp"], items["tp"])
        if new:
            latent = out[3] if primary else None
            send = [None]
            if primary:
                send = [({side: {k: v for k, v in items[side].items()
                                 if not k.startswith("_")} for side in new},
                         (list(latent.shape), list(latent.stride()),
                          str(latent.dtype).replace("torch.", "")))]
            dist.broadcast_object_list(send, src=0,
                                       group=self.mesh.cpu_group)
            got, meta = send[0]
            if "sp" in new:
                latent = _broadcast_tensor(latent, meta, self.device)
            if not primary:
                items.update(got)
                if "sp" in new:
                    items["sp"]["_latent_cache"] = latent
        if not primary:
            out = self.views.device_items(items["sp"], items["tp"])
        return items, out

    def _render(self, msg: Dict):
        items, (smpl, sp, tp, latent) = self._items(msg)
        block, primary = self.block, self.rank == 0
        buf = torch.empty((block, 8), dtype=torch.float32, device=self.device)
        rgbs, dropped, overflows = [], 0, 0
        for b in range(msg["blocks"]):
            if primary:
                buf.copy_(torch.from_numpy(msg["rays"][b * block:
                                                       (b + 1) * block]))
            dist.broadcast(buf, src=0)
            rays = (buf[:, :3].contiguous(), buf[:, 3:6].contiguous(),
                    buf[:, 6].contiguous(), buf[:, 7].contiguous())
            # nd: every rank's drop (the render all-reduces it), so the
            # ranks agree on a second pass
            rgb, _, _, nd = self.render[True](smpl, sp, tp, latent, *rays)
            nd = nd.tolist()
            if sum(nd) > 0:
                # a compaction overflow zeroes valid samples: the block
                # again, uncompacted (exact)
                overflows += 1
                dropped += int(nd[self.mesh.ray_index])
                rgb = self.render[False](smpl, sp, tp, latent, *rays)[0]
            if primary:
                rgbs.append(rgb)
        for side in SIDES:
            _lru_touch(self.cache, msg[side], items[side], self.cache_max)
        # this rank's own drops
        reply = {"n_dropped": dropped, "overflow_blocks": overflows}
        if primary:
            reply["rgb"] = torch.cat(rgbs).cpu().numpy()
        return reply


def shard_rank(bundle_dir: str, cache_max: int) -> Callable:
    """The handler a rank of :class:`ShardedRanks` builds (importable by a
    spawned rank)."""
    return _ShardRank(bundle_dir, cache_max)


class ShardedRanks:
    """``n`` ranks that render a bundle's sharded requests in blocks of
    ``block`` rays (the serving process's side).  ``device``: ``"cuda"``
    or ``"cpu"``.  A rank that dies or hangs fails the request within
    :data:`SHARD_TIMEOUT_S` a block."""

    def __init__(self, bundle_dir: str, n: int, block: int,
                 device: str = "cuda", cache_max: int = 4):
        self.n, self.block, self.timeout_s = n, block, SHARD_TIMEOUT_S
        self.cache_max = cache_max
        self.pool = RankPool(shard_rank, n, (bundle_dir, cache_max),
                             device=device, timeout_s=SHARD_TIMEOUT_S)
        # the content keys the ranks hold, in their LRU order
        self.keys: collections.OrderedDict = collections.OrderedDict()

    @property
    def pids(self) -> List[int]:
        return self.pool.pids

    def alive(self) -> bool:
        return self.pool.alive()

    @property
    def closed(self) -> bool:
        return self.pool.closed

    def ready(self) -> None:
        """Wait until every rank has loaded the bundle."""
        self._guard(self.pool.ready, self.timeout_s)

    def _guard(self, fn, *args):
        try:
            return fn(*args)
        except RankFailed:
            self.keys.clear()
            raise

    def render(self, keys: Dict[str, str], items: Dict[str, Dict],
               rays: np.ndarray) -> np.ndarray:
        """The rgb (N, 3) of (N, 8) rays, N a multiple of the bundle's
        ``shard_rays``; ``keys``/``items``: the content key and the
        device arrays of each side (``sp``, ``tp``)."""
        if len(rays) % self.block:
            raise ValueError(f"{len(rays)} rays are not whole blocks of "
                             f"{self.block}")
        send = [side for side in SIDES if keys[side] not in self.keys]
        head = {"op": "render", "send": send,
                "blocks": len(rays) // self.block, **keys}
        first = dict(head, items={side: items[side] for side in send},
                     rays=rays)
        replies = self._guard(self.pool.request,
                              [first] + [head] * (self.n - 1),
                              self.timeout_s * (2 + head["blocks"]))
        for side in SIDES:
            _lru_touch(self.keys, keys[side], None, self.cache_max)
        self.last = {"blocks": head["blocks"], "sent": send,
                     "n_dropped": [r["n_dropped"] for r in replies],
                     "overflow_blocks": replies[0]["overflow_blocks"]}
        return replies[0]["rgb"]

    def call(self, fn: Callable, *args: Sequence) -> List:
        """``fn(*args)`` on every rank (``fn`` importable by the ranks);
        the results in rank order."""
        msg = {"op": "call", "fn": fn, "args": args}
        return self._guard(self.pool.request, [msg] * self.n, self.timeout_s)

    def close(self) -> None:
        self.keys.clear()
        self.pool.close()
