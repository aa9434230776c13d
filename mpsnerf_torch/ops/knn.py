"""Nearest-SMPL-vertex lookup: exact 1-NN of 3-D points against a vertex
table (port of ``mpsnerf_tpu/ops/knn.py``).

* :func:`nearest_vertex_cuda`: the hand-written CUDA kernel
  (``mpsnerf_torch/csrc/nearest_vertex.cu``), launched for CUDA tensors.
* :func:`nearest_vertex_plain`: the same function in plain PyTorch, the
  diff form blocked over queries.  CPU tensors use it, and ``chip_smoke.py``
  holds the kernel against it on the card.
* :func:`nearest_vertex`: dispatches on the device of the query tensor.

Both compute d^2 as ``(dx*dx + dy*dy) + dz*dz`` (never the
``|q|^2 - 2 q.v + |v|^2`` product form) and keep the lowest vertex id on
ties.  The ids carry no gradient.
"""

from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel since the last reset (chip_smoke.py reads it)
LAUNCHES = {"nearest_vertex": 0}


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
