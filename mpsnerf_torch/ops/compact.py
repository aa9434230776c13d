"""Static-capacity masked compaction: gather valid rows into a K-slot
buffer, compute, scatter back (port of ``mpsnerf_tpu/ops/compact.py``).

A cumsum-based stable partition: valid row i goes to slot (number of valid
rows before it); valid rows beyond the capacity are dropped and counted by
``n_valid``.  JAX drops out-of-range scatter indices (``mode="drop"``);
torch raises on them, so such writes go to one scratch row past the end
of the buffer, which is sliced off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Compaction(NamedTuple):
    gather_idx: torch.Tensor  # (K,) int64 source row of each buffer slot
    slot: torch.Tensor        # (N,) int64 buffer slot of each row (clipped)
    take: torch.Tensor        # (N,) bool: row is valid AND within capacity
    n_valid: torch.Tensor     # () int64 number of valid rows (pre-drop)


def plan_compaction(mask: torch.Tensor, capacity: int) -> Compaction:
    """mask: (N,) int/bool validity; capacity: K slots."""
    n = mask.shape[0]
    maski = mask.to(torch.int64)
    slot = torch.cumsum(maski, 0) - 1
    take = (maski > 0) & (slot < capacity)
    dst = torch.where(take, slot, torch.full_like(slot, capacity))
    gather_idx = torch.zeros(capacity + 1, dtype=torch.int64,
                             device=mask.device)
    gather_idx[dst] = torch.arange(n, dtype=torch.int64, device=mask.device)
    return Compaction(
        gather_idx=gather_idx[:capacity],
        slot=torch.clamp(slot, 0, capacity - 1),
        take=take,
        n_valid=maski.sum(),
    )


def resize_plan(plan: Compaction, capacity: int) -> Compaction:
    """Shrink a plan built at a larger capacity to ``capacity`` slots; the
    partition is stable, so this equals planning at ``capacity``."""
    k = plan.gather_idx.shape[0]
    assert capacity <= k, (capacity, k)
    if capacity == k:
        return plan
    return Compaction(
        gather_idx=plan.gather_idx[:capacity],
        slot=torch.clamp(plan.slot, max=capacity - 1),
        take=plan.take & (plan.slot < capacity),
        n_valid=plan.n_valid,
    )


def compact(plan: Compaction, x: torch.Tensor) -> torch.Tensor:
    """(N, ...) -> (K, ...): gather valid rows (row 0 in unused slots)."""
    return x[plan.gather_idx]


def expand_scatter(plan: Compaction, buf: torch.Tensor, fill) -> torch.Tensor:
    """(K, ...) -> (N, ...): each used slot writes its source row of a
    ``fill``-initialised output.  Reads only ``gather_idx``, ``n_valid``
    and ``slot``'s length, so it is also right for composed plans
    (fine after coarse) whose ``slot``/``take`` describe the coarse stage."""
    k = buf.shape[0]
    n = plan.slot.shape[0]
    used = torch.arange(k, device=buf.device) < torch.clamp(plan.n_valid,
                                                            max=k)
    idx = torch.where(used, plan.gather_idx, torch.full_like(
        plan.gather_idx, n))
    out = torch.full((n + 1,) + tuple(buf.shape[1:]), fill, dtype=buf.dtype,
                     device=buf.device)
    out[idx] = buf
    return out[:n]


def expand_gather(plan: Compaction, buf: torch.Tensor, fill) -> torch.Tensor:
    """(K, ...) -> (N, ...): ``where(take, buf[slot], fill)``."""
    vals = buf[plan.slot]
    take = plan.take.reshape(plan.take.shape + (1,) * (vals.dim() - 1))
    return torch.where(take, vals, torch.full_like(vals, fill))
