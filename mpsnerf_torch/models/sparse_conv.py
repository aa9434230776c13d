"""The sparse 3D convolution encoder over the voxelized SMPL vertices (port
of ``mpsnerf_tpu/models/sparse_conv.py``).

Only the ~6890 voxels the vertices occupy are active, so each convolution
is a gather of 27 neighbours per site through host-built index tables
(:class:`SparseConvPlan`) followed by one (sites, 27 Cin) x (27 Cin, Cout)
product.  Submanifold semantics: outputs exist only at active sites and
an inactive neighbour reads a zero row (the sentinel index: the capacity
on the host, the site count on the device).  The strided conv's output sites are every coarse voxel that an
active input reaches under kernel 3 / stride 2 / padding 1 (spconv's
rulebook).  The trilinear lookup at the query points reads the coarse
sites through a dense volume of site ids.

:func:`build_plan` gives the JAX package's tables exactly (same site order,
same sentinels), computed with array operations instead of a dictionary
lookup per neighbour.

Module names and weight layout follow the reference checkpoint
(``encoder_3d.conv0.0/.3``, ``down0.0``, ``conv1.0/.3``: spconv 2.x KRSC
kernels (Cout, 3, 3, 3, Cin); BatchNorms ``.1``, ``.4``, ``down0.1``), so
``state_dict()`` is what ``convert_reference_state_dict`` reads.  The
BatchNorm is flax's: momentum 0.99 (torch's 0.01), eps 1e-3, statistics
over the real sites only (the JAX package masks its padded rows out), the
running variance moved towards the biased batch variance, one update per
forward call in train mode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

FINE_CAP = 7168
COARSE_CAP = 28672

_OFFSETS = np.array(
    [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
     for dx in (-1, 0, 1)], dtype=np.int64,
)  # (27, 3): the kernel's spatial index k is offset k - 1, row-major


class SparseConvPlan(NamedTuple):
    """Gather tables.  On the host (:func:`build_plan`): numpy arrays of
    static shapes, the JAX package's, whose sentinel index is the
    capacity.  On a device (:func:`plan_to`): tensors cut to the real
    sites, whose sentinel is the site count; the feature tables get a
    zero row at the sentinel."""

    n_fine: np.ndarray            # () actual fine sites
    n_coarse: np.ndarray          # () actual coarse sites
    fine_neighbors: np.ndarray    # (FINE_CAP, 27) into fine rows
    down_neighbors: np.ndarray    # (COARSE_CAP, 27) into fine rows
    coarse_neighbors: np.ndarray  # (COARSE_CAP, 27) into coarse rows
    coarse_index_vol: np.ndarray  # (D, H, W) site id or COARSE_CAP; the
    # coarse grid rounded up to multiples of 32
    coarse_out_sh: np.ndarray     # (3,) the true coarse grid shape
    fine_mask: np.ndarray         # (FINE_CAP,) 1 = a real site
    coarse_mask: np.ndarray       # (COARSE_CAP,)


def _keys(c: np.ndarray, base: int) -> np.ndarray:
    """Row-major keys of (..., 3) coords >= -1 (order = lexicographic)."""
    c = c + 1
    return (c[..., 0] * base + c[..., 1]) * base + c[..., 2]


def _lookup(table_keys, table_rows, query_keys, missing):
    """The row of each query key in (sorted keys, rows), else missing."""
    if len(table_keys) == 0:
        return np.full(query_keys.shape, missing, np.int32)
    pos = np.minimum(np.searchsorted(table_keys, query_keys),
                     len(table_keys) - 1)
    return np.where(table_keys[pos] == query_keys, table_rows[pos],
                    missing).astype(np.int32)


def build_plan(coord: np.ndarray, out_sh: np.ndarray) -> SparseConvPlan:
    """coord: (N, 3) int dhw voxel coords; out_sh: (3,) the fine grid."""
    coord = np.asarray(coord, np.int64).reshape(-1, 3)
    out_sh = np.asarray(out_sh, np.int64)
    n = len(coord)
    if n > FINE_CAP:
        raise ValueError(f"{n} active sites > FINE_CAP {FINE_CAP}")
    coarse_sh = (out_sh + 2 * 1 - 3) // 2 + 1
    base = int(max(coord.max(initial=0), out_sh.max(), 0)) * 2 + 8

    # fine lookup: a coordinate listed twice maps to its last row (as a
    # dictionary built in order does)
    fk = _keys(coord, base)
    rev_keys, rev_first = np.unique(fk[::-1], return_index=True)
    fine_rows = (n - 1 - rev_first).astype(np.int64)

    fine_nb = np.full((FINE_CAP, 27), FINE_CAP, np.int32)
    nb_keys = _keys(coord[:, None, :] + _OFFSETS[None], base)
    fine_nb[:n] = _lookup(rev_keys, fine_rows, nb_keys, FINE_CAP)

    # strided conv (k=3, s=2, p=1): input i reaches output o = (i - off)/2
    num = coord[:, None, :] - _OFFSETS[None]          # (N, 27, 3)
    o = num // 2
    ok = (np.all(num % 2 == 0, axis=-1) & np.all(o >= 0, axis=-1)
          & np.all(o < coarse_sh, axis=-1))
    cand = o[ok].reshape(-1, 3)
    ck = _keys(cand, base)
    coarse_keys, first = np.unique(ck, return_index=True)  # sorted
    coarse_coords = cand[first].reshape(-1, 3)
    m = len(coarse_coords)
    if m > COARSE_CAP:
        raise ValueError(f"{m} coarse sites > COARSE_CAP {COARSE_CAP}")

    down_nb = np.full((COARSE_CAP, 27), FINE_CAP, np.int32)
    coarse_nb = np.full((COARSE_CAP, 27), COARSE_CAP, np.int32)
    if m:
        down_keys = _keys(2 * coarse_coords[:, None, :] + _OFFSETS[None],
                          base)
        down_nb[:m] = _lookup(rev_keys, fine_rows, down_keys, FINE_CAP)
        c_keys = _keys(coarse_coords[:, None, :] + _OFFSETS[None], base)
        coarse_nb[:m] = _lookup(coarse_keys, np.arange(m), c_keys,
                                COARSE_CAP)

    vol_shape = tuple(((coarse_sh + 31) // 32 * 32).astype(int))
    vol = np.full(vol_shape, COARSE_CAP, np.int32)
    if m:
        vol[coarse_coords[:, 0], coarse_coords[:, 1],
            coarse_coords[:, 2]] = np.arange(m, dtype=np.int32)
    fine_mask = np.zeros(FINE_CAP, np.float32)
    fine_mask[:n] = 1
    coarse_mask = np.zeros(COARSE_CAP, np.float32)
    coarse_mask[:m] = 1
    return SparseConvPlan(
        n_fine=np.int32(n), n_coarse=np.int32(m), fine_neighbors=fine_nb,
        down_neighbors=down_nb, coarse_neighbors=coarse_nb,
        coarse_index_vol=vol, coarse_out_sh=coarse_sh.astype(np.int32),
        fine_mask=fine_mask, coarse_mask=coarse_mask)


def plan_to(plan: SparseConvPlan, device) -> SparseConvPlan:
    """The host plan on ``device``, cut to its real sites: the neighbour
    tables' rows sliced to the sites and every sentinel remapped from the
    capacity to the site count (int64 tensors), the site counts as host
    ints, no masks (the slicing takes their place)."""
    nf, nc = int(plan.n_fine), int(plan.n_coarse)

    def table(x, cap, n):
        x = np.asarray(x, np.int64)
        return torch.as_tensor(np.where(x == cap, n, x), device=device)

    return SparseConvPlan(
        n_fine=nf, n_coarse=nc,
        fine_neighbors=table(plan.fine_neighbors[:nf], FINE_CAP, nf),
        down_neighbors=table(plan.down_neighbors[:nc], FINE_CAP, nf),
        coarse_neighbors=table(plan.coarse_neighbors[:nc], COARSE_CAP, nc),
        coarse_index_vol=table(plan.coarse_index_vol, COARSE_CAP, nc),
        coarse_out_sh=torch.as_tensor(
            np.asarray(plan.coarse_out_sh, np.int64), device=device),
        fine_mask=None, coarse_mask=None)


def _padded(x: torch.Tensor) -> torch.Tensor:
    """The rows and one zero row, the sentinel's."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])])


class SparseConv(nn.Module):
    """One sparse conv: a gather of 27 neighbours, one product.  The weight
    is stored (Cout, 3, 3, 3, Cin) (spconv 2.x's KRSC)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        # flax's variance_scaling(1, fan_in, uniform) over 27 * Cin inputs
        bound = float(np.sqrt(3.0 / (27 * cin)))
        self.weight = nn.Parameter(
            torch.empty(cout, 3, 3, 3, cin).uniform_(-bound, bound))

    def forward(self, feats, neighbors):
        cout, cin = self.weight.shape[0], self.weight.shape[-1]
        # index_select, not x[idx]: its backward is an atomic index_add,
        # where indexing's sorts the indices and serialises on duplicates
        # (the sentinel row is read ~10^5 times; PERF.md)
        gathered = torch.index_select(_padded(feats), 0,
                                      neighbors.reshape(-1))
        w = self.weight.permute(1, 2, 3, 4, 0).reshape(27 * cin, cout)
        return gathered.reshape(neighbors.shape[0], 27 * cin) @ w


class BatchNorm(nn.Module):
    """flax's ``BatchNorm(momentum=0.99, epsilon=1e-3)`` over the rows of
    (sites, C) (see the module docstring)."""

    def __init__(self, ch: int, eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = torch.mean(x, dim=0)
            var = torch.clamp(torch.mean(x * x, dim=0) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def _double(cin: int, cout: int) -> nn.Sequential:
    """The reference's ``double_conv``: (conv, BN, ReLU) x 2, indices
    0/1/2 and 3/4/5."""
    return nn.Sequential(SparseConv(cin, cout), BatchNorm(cout), nn.ReLU(),
                         SparseConv(cout, cout), BatchNorm(cout), nn.ReLU())


class SparseConvNet3D(nn.Module):
    """conv0 (3 -> 16, two submanifold convs), down0 (16 -> 32, stride 2),
    conv1 (32 -> 32, two submanifold convs), the trilinear lookup at the
    query points: (Nq, 32) features."""

    def __init__(self):
        super().__init__()
        self.conv0 = _double(3, 16)
        self.down0 = nn.Sequential(SparseConv(16, 32), BatchNorm(32),
                                   nn.ReLU())
        self.conv1 = _double(32, 32)

    def forward(self, xyz_features: torch.Tensor, plan: SparseConvPlan,
                query_coords: torch.Tensor) -> torch.Tensor:
        """``xyz_features`` (N, 3) per site; ``plan`` on the device
        (:func:`plan_to`); ``query_coords`` (Nq, 3) normalized (x, y, z)
        in [-1, 1].  Only the plan's real sites are computed: the JAX
        package's padded rows read only the zero row and leave the masked
        BatchNorm statistics and the output as they are."""
        fine_nb, coarse_nb = plan.fine_neighbors, plan.coarse_neighbors
        c0, d0, c1 = self.conv0, self.down0, self.conv1

        def block(conv, bn, x, nb):
            return torch.relu(bn(conv(x, nb)))

        x = block(c0[0], c0[1], xyz_features[:plan.n_fine], fine_nb)
        x = block(c0[3], c0[4], x, fine_nb)
        x = block(d0[0], d0[1], x, plan.down_neighbors)
        x = block(c1[0], c1[1], x, coarse_nb)
        x = block(c1[3], c1[4], x, coarse_nb)
        return trilinear_lookup(x, plan, query_coords)


def trilinear_lookup(site_feats: torch.Tensor, plan: SparseConvPlan,
                     coords: torch.Tensor) -> torch.Tensor:
    """Coarse-site features at normalized (x, y, z) coords, align_corners
    over the true coarse grid, zero outside (``F.grid_sample``'s zeros
    padding on the dense volume the reference builds)."""
    vol = plan.coarse_index_vol
    sh = plan.coarse_out_sh.to(coords.dtype)  # (d, h, w)
    fpad = _padded(site_feats)
    fx = (coords[:, 0] + 1.0) * 0.5 * (sh[2] - 1)
    fy = (coords[:, 1] + 1.0) * 0.5 * (sh[1] - 1)
    fz = (coords[:, 2] + 1.0) * 0.5 * (sh[0] - 1)
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    out = coords.new_zeros(coords.shape[0], site_feats.shape[-1])
    for dz in (0.0, 1.0):
        for dy in (0.0, 1.0):
            for dx in (0.0, 1.0):
                cx, cy, cz = x0 + dx, y0 + dy, z0 + dz
                w = ((1 - torch.abs(fx - cx)) * (1 - torch.abs(fy - cy))
                     * (1 - torch.abs(fz - cz)))
                inside = ((cx >= 0) & (cx <= sh[2] - 1) & (cy >= 0)
                          & (cy <= sh[1] - 1) & (cz >= 0)
                          & (cz <= sh[0] - 1))
                xi = torch.clamp(cx, 0, vol.shape[2] - 1).long()
                yi = torch.clamp(cy, 0, vol.shape[1] - 1).long()
                zi = torch.clamp(cz, 0, vol.shape[0] - 1).long()
                vals = torch.index_select(fpad, 0, vol[zi, yi, xi])
                out = out + vals * (w * inside.to(w.dtype))[:, None]
    return out
