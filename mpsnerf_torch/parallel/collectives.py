"""Named mesh axes and the mean over them: the counterpart of JAX's axis
names bound by ``shard_map`` and of ``lax.pmean``.

A :class:`~mpsnerf_torch.parallel.mesh.Mesh` binds its axis names for the
duration of ``with mesh.bound():``; inside, :func:`axis_group` resolves a
name (``"data"``, ``"ray"`` or a tuple of both) to the process group of
this rank's peers along it.  Outside, a name is unbound and raises, as
JAX raises for an axis name outside ``shard_map``.

:func:`pmean_` averages tensors in place over a named axis with a few
``all_reduce`` calls on flattened buckets (a sum, then a division by the
group's size); :func:`pmean` is its differentiable form for one tensor
(the cross-replica BatchNorm's statistics).  Only ``all_reduce`` is used
on device tensors: gloo, which runs ranks that share a GPU, supports
little else for CUDA tensors.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisName = Union[str, Tuple[str, ...]]

BUCKET_BYTES = 32 << 20  # the most one all_reduce carries

_BOUND: List = []  # the meshes whose axis names are bound, innermost last


@contextlib.contextmanager
def bind(mesh):
    """Bind ``mesh``'s axis names for the block (``Mesh.bound``)."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def axis_group(axis_name: AxisName):
    """``(group, size)`` of this rank's peers along ``axis_name`` in the
    innermost bound mesh; raises where no mesh binds the name."""
    if not _BOUND:
        raise RuntimeError(
            f"axis name {axis_name!r} is not bound: a collective over a mesh "
            "axis runs only inside `with mesh.bound():` (as JAX's axis names "
            "exist only inside shard_map)")
    return _BOUND[-1].group(axis_name)


def _buckets(tensors: Sequence[torch.Tensor], limit: int):
    """Consecutive runs of ``tensors`` of one dtype and device, each of at
    most ``limit`` bytes (a larger tensor alone)."""
    run, size = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        if run and (size + n > limit or t.dtype != run[0].dtype
                    or t.device != run[0].device):
            yield run
            run, size = [], 0
        run.append(t)
        size += n
    if run:
        yield run


def pmean_(tensors: Sequence[torch.Tensor], axis_name: AxisName,
           bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor by its mean over the ranks along ``axis_name``:
    one ``all_reduce`` (sum) per bucket of flattened tensors, then a
    division by the group's size.  Every rank ends with the same values."""
    group, size = axis_group(axis_name)
    if size == 1:
        return
    for run in _buckets(tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(size)
        offset = 0
        for t in run:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class _GroupMean(torch.autograd.Function):
    """Mean over a group, with the mean of the gradients as its backward
    (the mean is linear and its own adjoint, so the backward is this
    function again and differentiates once more)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y.div_(size)

    @staticmethod
    def backward(ctx, g):
        return _GroupMean.apply(g.contiguous(), ctx.group, ctx.size), None, None


def pmean(x: torch.Tensor, axis_name: AxisName) -> torch.Tensor:
    """``lax.pmean(x, axis_name)``, differentiable."""
    group, size = axis_group(axis_name)
    if size == 1:
        return x
    return _GroupMean.apply(x.contiguous(), group, size)
