"""Nearest-SMPL-vertex lookup: exact 1-NN of 3-D points against a vertex
table (port of ``mpsnerf_tpu/ops/knn.py``).

* :func:`nearest_vertex_cuda`: the hand-written CUDA kernel
  (``mpsnerf_torch/csrc/nearest_vertex.cu``), launched for CUDA tensors.
* :func:`nearest_vertex_plain`: the same function in plain PyTorch, the
  diff form blocked over queries.  CPU tensors use it, and ``chip_smoke.py``
  holds the kernel against it on the card.
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

import torch

# launches of the CUDA kernels since the last reset (chip_smoke.py reads it)
LAUNCHES = {"nearest_vertex": 0, "nearest_vertex_packed": 0}


def _d2(diff: torch.Tensor) -> torch.Tensor:
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]


def nearest_vertex_plain(query: torch.Tensor, verts: torch.Tensor,
                         block_elems: int = 1 << 22):
    """Exact 1-NN in plain PyTorch: ``(d2 (N,) f32, ids (N,) int64)``.
    Blocked over queries so the transient (block, V) matrix stays about
    ``block_elems`` entries."""
    n = query.shape[0]
    block = max(1, block_elems // max(verts.shape[0], 1))
    d2s, idss = [], []
    for s in range(0, n, block):
        qb = query[s : s + block]
        d2, ids = torch.min(_d2(qb[:, None, :] - verts[None, :, :]), dim=1)
        d2s.append(d2)
        idss.append(ids)
    return torch.cat(d2s), torch.cat(idss)


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


def nearest_vertex_cuda(query: torch.Tensor, verts: torch.Tensor):
    """The CUDA kernel: ``(d2 (N,) f32, ids (N,) int64)``.  The kernel
    returns ids only; d^2 is recomputed from them with the diff form
    (O(N), as ``knn.py:152-155`` of the JAX package does)."""
    from mpsnerf_torch.cuda_build import load_kernel_library

    _check_cuda_args(query, verts)
    lib = load_kernel_library("nearest_vertex")
    fn = lib.mpsnerf_nearest_vertex
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = query.shape[0]
    ids = torch.empty(n, dtype=torch.int64, device=query.device)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = fn(query.data_ptr(), verts.data_ptr(), n, verts.shape[0],
                 ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nearest_vertex kernel launch failed: CUDA error "
                           f"{err}")
    if n > 0:
        LAUNCHES["nearest_vertex"] += 1
    return _d2(query - verts[ids]), ids


def nearest_vertex(query: torch.Tensor, verts: torch.Tensor):
    """Exact 1-NN ``(d2, ids)``: the CUDA kernel for CUDA tensors (or an
    error for what it does not take), the plain version for CPU tensors."""
    if query.device.type == "cpu" and verts.device.type == "cpu":
        return nearest_vertex_plain(query, verts)
    return nearest_vertex_cuda(query, verts)


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
