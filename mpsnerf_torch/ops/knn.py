"""Nearest-SMPL-vertex lookup: exact 1-NN of 3-D points against a vertex
table (port of ``mpsnerf_tpu/ops/knn.py``).

* :func:`build_vertex_buckets`: the table cut into buckets of 32
  vertices in Morton order, each with its box (built once per table and
  passed down by the callers): one CUDA kernel for a CUDA table
  (:func:`build_vertex_buckets_cuda`), its plain PyTorch version
  (:func:`build_vertex_buckets_plain`) for a CPU one;
  :func:`kernel_buckets` builds them only where the kernel reads them.
* :func:`nearest_vertex_cuda`: the hand-written CUDA kernel
  (``mpsnerf_torch/csrc/nearest_vertex.cu``), launched for CUDA tensors:
  per warp of 32 queries it visits only the buckets its exact lower bounds
  cannot rule out.
* :func:`nearest_vertex_plain`: the same function in plain PyTorch, brute
  force in the diff form, blocked over queries.  CPU tensors use it, and
  ``chip_smoke.py`` holds the kernel against it on the card.
* :func:`nearest_vertex_bucketed_plain`: the kernel's culled search
  emulated in plain PyTorch (the same buckets, groups of 32, bounds and
  skip rule), for the CPU tests of the skip rule; no path calls it.
* :func:`nearest_vertex`: dispatches on the device of the query tensor.
* :func:`nearest_vertex_packed` (with ``_plain`` and ``_cuda``): the
  packed-key 1-NN of the TPU kernels, for the variant probe
  (``mpsnerf_torch/csrc/nearest_vertex_packed.cu``).

All compute d^2 as ``(dx*dx + dy*dy) + dz*dz`` (never the
``|q|^2 - 2 q.v + |v|^2`` product form); the exact 1-NN keeps the lowest
vertex id on ties.  The ids carry no gradient.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

# launches of the CUDA kernels since the last reset (chip_smoke.py reads it)
LAUNCHES = {"nearest_vertex": 0, "vertex_buckets": 0,
            "nearest_vertex_packed": 0}

BUCKET = 32  # vertices per bucket
GROUP = 32   # queries per warp
_MORTON_BITS = 10
_SPREAD = {}  # device -> (1024,) int64: a 10-bit cell index, bits spread 3x
_BUILD_SHARED_KEYS = 16384  # above: the build kernel sorts in a scratch


def _d2(diff: torch.Tensor) -> torch.Tensor:
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]


def _lowest_argmin(d2: torch.Tensor, ids: torch.Tensor, big: int):
    """``(min over the last dim, the lowest id among the entries equal to
    it)``; ``ids`` broadcasts against ``d2``."""
    best = d2.amin(-1)
    hit = d2 == best[..., None]
    return best, torch.where(hit, ids, big).amin(-1)


def nearest_vertex_plain(query: torch.Tensor, verts: torch.Tensor,
                         block_elems: int = 1 << 22):
    """Exact 1-NN in plain PyTorch: ``(d2 (N,) f32, ids (N,) int64)``, the
    lowest id on a tie in fp32 d2.  Blocked over queries so the transient
    (block, V) matrix stays about ``block_elems`` entries."""
    n, nv = query.shape[0], verts.shape[0]
    block = max(1, block_elems // max(nv, 1))
    ids_v = torch.arange(nv, dtype=torch.int32, device=query.device)
    d2s, idss = [], []
    for s in range(0, n, block):
        qb = query[s : s + block]
        d2, ids = _lowest_argmin(_d2(qb[:, None, :] - verts[None, :, :]),
                                 ids_v, nv)
        d2s.append(d2)
        idss.append(ids.long())
    if not d2s:
        return query.new_zeros(0), torch.zeros(0, dtype=torch.int64,
                                               device=query.device)
    return torch.cat(d2s), torch.cat(idss)


# ---- the bucketed table ------------------------------------------------


class VertexBuckets(NamedTuple):
    """A vertex table in buckets of :data:`BUCKET` vertices in Morton
    order, the last one padded with copies of its last vertex."""

    table: torch.Tensor  # (nb * 32, 4) f32: x, y, z, id (int32 bits);
    #                      ids ascending within each bucket
    boxes: torch.Tensor  # (nb, 8) f32: the bucket's lo xyz, 0, hi xyz, 0
    n_verts: int


def _spread(device) -> torch.Tensor:
    lut = _SPREAD.get(device)
    if lut is None:
        x = torch.arange(1 << _MORTON_BITS, dtype=torch.int64)
        lut = torch.zeros_like(x)
        for b in range(_MORTON_BITS):
            lut |= ((x >> b) & 1) << (3 * b)
        lut = _SPREAD[device] = lut.to(device)
    return lut


def _check_table(name: str, verts: torch.Tensor):
    if verts.dim() != 2 or verts.shape[1] != 3 or verts.shape[0] == 0:
        raise ValueError(f"{name}: verts has shape {tuple(verts.shape)}, "
                         "not (V, 3) with V > 0")


def build_vertex_buckets_plain(verts: torch.Tensor) -> VertexBuckets:
    """Cut ``verts`` (V, 3) into buckets of 32 spatially close vertices:
    sort by the Morton code of a 1024^3 grid over the table's box (ties
    by id), pad to whole buckets with the last vertex, sort each bucket by
    id and take its box.  Plain PyTorch (the synthetic rig's ids are
    spatially random, so buckets by id would each span the body)."""
    _check_table("build_vertex_buckets_plain", verts)
    nv = verts.shape[0]
    v = verts.detach().float()
    lo = v.amin(0)
    ext = (v.amax(0) - lo).clamp_min(1e-30)
    scale = torch.reciprocal(ext) * float((1 << _MORTON_BITS) - 1)
    cell = ((v - lo) * scale).long().clamp_(0, (1 << _MORTON_BITS) - 1)
    lut = _spread(v.device)
    code = lut[cell[:, 0]] | (lut[cell[:, 1]] << 1) | (lut[cell[:, 2]] << 2)
    ids = torch.arange(nv, device=v.device)
    order = torch.argsort(code * nv + ids)
    nb = -(-nv // BUCKET)
    order = torch.cat([order, order[-1:].expand(nb * BUCKET - nv)])
    order = order.view(nb, BUCKET).sort(dim=1).values.reshape(-1)
    vs = v[order]
    table = torch.cat([vs, order.to(torch.int32).view(torch.float32)[:, None]],
                      dim=1).contiguous()
    vb = vs.view(nb, BUCKET, 3)
    zero = v.new_zeros(nb, 1)
    boxes = torch.cat([vb.amin(1), zero, vb.amax(1), zero], dim=1).contiguous()
    return VertexBuckets(table, boxes, nv)


def build_vertex_buckets_cuda(verts: torch.Tensor) -> VertexBuckets:
    """The bucket build as one CUDA kernel (one block; bit-equal to
    :func:`build_vertex_buckets_plain`)."""
    _check_table("build_vertex_buckets_cuda", verts)
    if not verts.is_cuda or verts.dtype != torch.float32 \
            or not verts.is_contiguous():
        raise ValueError("build_vertex_buckets_cuda: verts must be "
                         "contiguous float32 on a CUDA device, not "
                         f"{verts.dtype} on {verts.device}")
    nv = verts.shape[0]
    nb = -(-nv // BUCKET)
    pow2 = 1 << (nv - 1).bit_length()
    dev = verts.device
    table = torch.empty(nb * BUCKET, 4, device=dev)
    boxes = torch.empty(nb, 8, device=dev)
    scratch = (torch.empty(pow2, dtype=torch.int64, device=dev)
               if pow2 > _BUILD_SHARED_KEYS else None)
    _launch("mpsnerf_vertex_buckets", "vertex_buckets", dev,
            verts.data_ptr(), nv, 0 if scratch is None else scratch.data_ptr(),
            table.data_ptr(), boxes.data_ptr())
    return VertexBuckets(table, boxes, nv)


def build_vertex_buckets(verts: torch.Tensor) -> VertexBuckets:
    """The 1-NN buckets of ``verts`` (V, 3): the kernel for a CUDA table,
    the plain version for a CPU one."""
    if verts.device.type == "cpu":
        return build_vertex_buckets_plain(verts)
    return build_vertex_buckets_cuda(verts)


def kernel_buckets(verts: torch.Tensor) -> Optional[VertexBuckets]:
    """The buckets :func:`nearest_vertex` passes to the kernel, for a
    caller that queries one table several times: built for a CUDA table,
    None for a CPU one (the brute-force plain version reads none)."""
    return None if verts.device.type == "cpu" else build_vertex_buckets(verts)


def _gap(lo_q, hi_q, lo_b, hi_b):
    """The kernel's per-axis lower bound of |fl(q - v)| (see the .cu)."""
    return torch.clamp(torch.maximum(lo_b - hi_q, lo_q - hi_b), min=0.0)


def nearest_vertex_bucketed_plain(query: torch.Tensor,
                                  buckets: VertexBuckets):
    """The kernel's culled search in plain PyTorch, all groups of 32
    queries in step: the same seed, the same chunked box test against the
    group's largest best, the same per-query test and the same merge.
    Returns ``(d2 (N,) f32, ids (N,) int64, pairs)``, ``pairs`` the
    query-vertex pairs evaluated (the kernel's counter)."""
    n = query.shape[0]
    dev = query.device
    nb = buckets.boxes.shape[0]
    big = torch.iinfo(torch.int32).max
    groups = -(-n // GROUP)
    if groups == 0:
        return query.new_zeros(0), torch.zeros(0, dtype=torch.int64,
                                               device=dev), 0
    slot = torch.arange(groups * GROUP, device=dev)
    src = torch.where(slot < n, slot, slot // GROUP * GROUP)  # idle lanes
    q = query[src].view(groups, GROUP, 3)
    nvalid = (n - torch.arange(groups, device=dev) * GROUP).clamp(max=GROUP)
    lo, hi = q.amin(1), q.amax(1)  # (G, 3): the group's box
    blo, bhi = buckets.boxes[:, 0:3], buckets.boxes[:, 4:7]
    verts = buckets.table.view(nb, BUCKET, 4)
    vxyz = verts[..., :3]
    vid = verts[..., 3].contiguous().view(torch.int32)

    centre = (lo + hi) * 0.5
    score = _d2(_gap(centre[:, None], centre[:, None], blo[None], bhi[None]))
    _, seed = _lowest_argmin(score, torch.arange(nb, device=dev), nb)

    best = torch.full((groups, GROUP), float("inf"), device=dev)
    best_id = torch.full((groups, GROUP), big, dtype=torch.int32,
                         device=dev)
    visits = torch.zeros(groups, dtype=torch.int64, device=dev)

    def visit(b, on):  # b: (G,) bucket of each group, on: (G,) bool
        nonlocal best, best_id, visits
        d2 = _d2(q[:, :, None, :] - vxyz[b][:, None, :, :])  # (G, 32, 32)
        bd, bi = _lowest_argmin(d2, vid[b][:, None, :], big)
        take = on[:, None] & ((bd < best) | ((bd == best) & (bi < best_id)))
        best = torch.where(take, bd, best)
        best_id = torch.where(take, bi, best_id)
        visits = visits + on

    visit(seed, torch.ones(groups, dtype=torch.bool, device=dev))
    for b0 in range(0, nb, GROUP):  # a chunk: one bucket per lane
        worst = best.amax(1)
        chunk = torch.arange(b0, min(b0 + GROUP, nb), device=dev)
        lb = _d2(_gap(lo[:, None], hi[:, None], blo[chunk][None],
                      bhi[chunk][None]))  # (G, chunk)
        keep = (lb <= worst[:, None]) & (chunk[None] != seed[:, None])
        for j in range(chunk.shape[0]):
            if not bool(keep[:, j].any()):
                continue
            b = b0 + j
            lane_lb = _d2(_gap(q, q, blo[b], bhi[b]))  # (G, 32)
            on = keep[:, j] & (lane_lb <= best).any(1)
            visit(torch.full((groups,), b, device=dev), on)
    pairs = int((visits * BUCKET * nvalid).sum())
    return best.reshape(-1)[:n], best_id.reshape(-1)[:n].long(), pairs


# ---- the CUDA kernel ---------------------------------------------------


def _check_cuda_args(query: torch.Tensor, verts: torch.Tensor):
    for name, t in (("query", query), ("verts", verts)):
        if not t.is_cuda:
            raise ValueError(f"nearest_vertex_cuda: {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"nearest_vertex_cuda: {name} is {t.dtype}, "
                            "not float32")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"nearest_vertex_cuda: {name} has shape "
                             f"{tuple(t.shape)}, not (n, 3)")
        if not t.is_contiguous():
            raise ValueError(f"nearest_vertex_cuda: {name} is not contiguous")
    if query.device != verts.device:
        raise ValueError("nearest_vertex_cuda: query and verts are on "
                         f"{query.device} and {verts.device}")
    if verts.shape[0] == 0:
        raise ValueError("nearest_vertex_cuda: empty vertex table")


def _check_buckets(buckets: VertexBuckets, verts: torch.Tensor):
    table, boxes = buckets.table, buckets.boxes
    nb = boxes.shape[0]
    if buckets.n_verts != verts.shape[0] or tuple(table.shape) != \
            (nb * BUCKET, 4) or tuple(boxes.shape) != (nb, 8):
        raise ValueError(f"nearest_vertex_cuda: buckets of {buckets.n_verts}"
                         f" vertices ({tuple(table.shape)}, "
                         f"{tuple(boxes.shape)}) do not fit {verts.shape[0]}")
    for t in (table, boxes):
        if t.device != verts.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("nearest_vertex_cuda: buckets not contiguous "
                             f"float32 on {verts.device}")


_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = {  # after them: the stream
    "mpsnerf_nearest_vertex": [_PTR, _I64, _PTR, _PTR, _I64, _PTR, _PTR,
                               _PTR],
    "mpsnerf_vertex_buckets": [_PTR, _I64, _PTR, _PTR, _PTR],
}
_FNS = {}


def _launch(symbol: str, counter: str, dev, *args):
    """Call ``symbol`` of ``csrc/nearest_vertex.cu`` on the current stream
    of ``dev`` and count one launch of ``counter``."""
    fn = _FNS.get(symbol)
    if fn is None:
        from mpsnerf_torch.cuda_build import load_kernel_library

        fn = getattr(load_kernel_library("nearest_vertex"), symbol)
        fn.argtypes = _ARGTYPES[symbol] + [_PTR]
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch._C._cuda_getDevice():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


def nearest_vertex_cuda(query: torch.Tensor, verts: torch.Tensor,
                        buckets: Optional[VertexBuckets] = None,
                        pairs: Optional[torch.Tensor] = None):
    """The CUDA kernel: ``(d2 (N,) f32, ids (N,) int64)``, both written by
    the kernel.  ``buckets`` are built from ``verts`` when not given.
    ``pairs`` (one int64 on the device), when given, is increased by the
    query-vertex pairs the kernel evaluated."""
    _check_cuda_args(query, verts)
    if buckets is None:
        buckets = build_vertex_buckets(verts)
    _check_buckets(buckets, verts)
    if pairs is not None and (pairs.device != query.device
                              or pairs.dtype != torch.int64
                              or pairs.numel() != 1):
        raise ValueError("nearest_vertex_cuda: pairs must be one int64 on "
                         f"{query.device}")
    n = query.shape[0]
    dev = query.device
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    ids = torch.empty(n, dtype=torch.int64, device=dev)
    if n > 0:
        _launch("mpsnerf_nearest_vertex", "nearest_vertex", dev,
                query.data_ptr(), n, buckets.table.data_ptr(),
                buckets.boxes.data_ptr(), buckets.boxes.shape[0],
                d2.data_ptr(), ids.data_ptr(),
                0 if pairs is None else pairs.data_ptr())
    return d2, ids


def nearest_vertex(query: torch.Tensor, verts: torch.Tensor,
                   buckets: Optional[VertexBuckets] = None):
    """Exact 1-NN ``(d2, ids)``: the CUDA kernel for CUDA tensors (or an
    error for what it does not take), with ``buckets`` of ``verts`` built
    here when not given; the brute-force plain version for CPU tensors
    (which ignores ``buckets``)."""
    if query.device.type == "cpu" and verts.device.type == "cpu":
        return nearest_vertex_plain(query, verts)
    return nearest_vertex_cuda(query, verts, buckets)


# ---- the packed-key 1-NN (the TPU kernels' function) ---------------------
#
# The JAX package's Pallas kernels (_nn_kernel, and the probe's kernel_vT)
# pack a 13-bit vertex id into the low mantissa bits of d^2 and take one
# integer min: ties within the truncated bits go to the lowest id.  The
# port's main path keeps the exact 1-NN above; this function is the
# probe's (mpsnerf_torch/tools/knn_variant_probe.py).

ID_BITS = 13
VERT_TILE = 1152  # the JAX kernel's vertex tile; its padded count must fit
LOW_MASK = (1 << ID_BITS) - 1


def _check_id_range(nv: int):
    """Raise where ``nearest_vertex_pallas`` raises (``knn.py:128-133``):
    the vertex count padded to the 1152-vertex tile exceeds 2^13 ids."""
    padded = -(-nv // VERT_TILE) * VERT_TILE
    if padded > (1 << ID_BITS):
        raise ValueError(
            f"padded vertex count {padded} exceeds the {ID_BITS}-bit id "
            "range of the packed-key kernel; use nearest_vertex")


def nearest_vertex_packed_plain(query: torch.Tensor, verts: torch.Tensor,
                                block_elems: int = 1 << 22):
    """The packed-key 1-NN in plain PyTorch: ``(d2 (N,) f32, ids (N,)
    int64)``, d2 recomputed from the ids with the diff form."""
    nv = verts.shape[0]
    _check_id_range(nv)
    ids_v = torch.arange(nv, dtype=torch.int32, device=query.device)
    block = max(1, block_elems // max(nv, 1))
    out = []
    for s in range(0, query.shape[0], block):
        d2 = _d2(query[s:s + block, None, :] - verts[None, :, :])
        key = (d2.view(torch.int32) & ~LOW_MASK) | ids_v
        out.append((key.min(dim=1).values & LOW_MASK).long())
    ids = torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                 device=query.device)
    return _d2(query - verts[ids]), ids


def nearest_vertex_packed_cuda(query: torch.Tensor, verts: torch.Tensor,
                               qpt: int = 4, tile: int = VERT_TILE):
    """The packed-key CUDA kernel at launch variant ``(qpt, tile)``:
    ``(d2 (N,) f32, ids (N,) int64)``."""
    from mpsnerf_torch.cuda_build import load_kernel_library

    _check_cuda_args(query, verts)
    _check_id_range(verts.shape[0])
    if qpt not in (1, 2, 4) or not 1 <= tile <= 3072:
        raise ValueError(f"nearest_vertex_packed_cuda: no variant qpt={qpt}, "
                         f"tile={tile}")
    lib = load_kernel_library("nearest_vertex_packed")
    fn = lib.mpsnerf_nearest_vertex_packed
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = query.shape[0]
    ids = torch.empty(n, dtype=torch.int64, device=query.device)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = fn(query.data_ptr(), verts.data_ptr(), n, verts.shape[0],
                 ids.data_ptr(), qpt, tile, stream)
    if err != 0:
        raise RuntimeError(f"nearest_vertex_packed kernel launch failed: "
                           f"CUDA error {err}")
    if n > 0:
        LAUNCHES["nearest_vertex_packed"] += 1
    return _d2(query - verts[ids]), ids


def nearest_vertex_packed(query: torch.Tensor, verts: torch.Tensor):
    """Packed-key 1-NN ``(d2, ids)``: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if query.device.type == "cpu" and verts.device.type == "cpu":
        return nearest_vertex_packed_plain(query, verts)
    return nearest_vertex_packed_cuda(query, verts)
