"""Reading the device trace and recording the kernels' launches.

:class:`Launches` wraps, from the benchmark's side, the port's launchers
of its two hand-written kernels (K1's ``nearest_vertex_cuda``, K2's
forward, backward and double backward) and keeps each launch's shapes and
coordinates, so that the bytes each launch needs can be counted after the
window.  :func:`profiled` runs a callable under ``torch.profiler`` (CUDA
activity) and reduces its events: each device operation's interval
(kernels, copies, sets), their union (the busy time), the host's launch
calls, the operations by summed time and the longest idle gaps.  The
reduction sums the events itself, as ``mpsnerf_torch/tools/
profile_step.py:device_rows`` does, since ``key_averages()`` takes tens of
seconds over a served view's events.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, NamedTuple

import torch

# the host's calls that put work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaMemcpy", "cudaMemset")
K1_KERNELS = ("nearest_vertex_kernel",)
K2_FWD_KERNELS = ("grid_sample_fwd_tile", "grid_sample_fwd_point")
K2_BWD_KERNELS = ("grid_sample_bwd_tile", "grid_sample_bwd_point")
K2_BWD2_KERNELS = ("grid_sample_bwd2_tile", "grid_sample_bwd2_point")


class Trace(NamedTuple):
    wall_s: float                 # the profiled span, host clock
    ops: List                     # (name, start_us, end_us) device ops
    busy_s: float                 # union of the ops' intervals
    launch_calls: int             # the host's launch calls


def _union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total * 1e-6


def profiled(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` under the profiler (the CPU's activity where there is no
    card, for the rehearsals of the tests)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    ops, calls = [], 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name in LAUNCH_CALLS:
            calls += 1
    return Trace(wall, ops, _union_s((s, e) for _, s, e in ops), calls)


def device_ops(trace: Trace, top: int = 10):
    """The device operations by summed time: [[name, seconds], ...]."""
    sums: Dict[str, float] = {}
    for name, s, e in trace.ops:
        sums[name] = sums.get(name, 0.0) + (e - s) * 1e-6
    return [[k[:120], v] for k, v in
            sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Trace, top: int = 10):
    """The longest gaps between device operations, each named by the
    operation that ended it: [[\"before <op>\", seconds], ...]."""
    gaps, end = [], None
    for name, s, e in sorted(trace.ops, key=lambda o: o[1]):
        if end is not None and s > end:
            gaps.append([f"before {name[:110]}", (s - end) * 1e-6])
        end = e if end is None else max(end, e)
    return sorted(gaps, key=lambda g: -g[1])[:top]


def is_kernel(op_name: str, names) -> bool:
    """Whether a device operation is a launch of one of the functions
    ``names`` (the trace names it with its namespace and arguments)."""
    return any(re.search(rf"(^|[\s:]){k}[(<]", op_name) for k in names)


def kernel_seconds(trace: Trace, names) -> List[float]:
    """Each launch's device seconds of the kernels ``names``, in launch
    order."""
    return [(e - s) * 1e-6 for n, s, e in sorted(trace.ops,
                                                  key=lambda o: o[1])
            if is_kernel(n, names)]


class Launches:
    """While entered, records every launch of K1's search and K2's three
    kernels: ``self.k1`` [(n, nv)], ``self.k2`` [(kind, image shape,
    coords, flags)]; the coordinates are kept by reference (no copy, no
    device work)."""

    def __init__(self):
        self.k1, self.k2 = [], []

    def __enter__(self):
        from mpsnerf_torch.ops import grid_sample, knn

        self._saved = [(knn, "nearest_vertex_cuda"),
                       (grid_sample, "grid_sample_patch_fwd_cuda"),
                       (grid_sample, "grid_sample_patch_bwd_cuda"),
                       (grid_sample, "grid_sample_patch_bwd2_cuda")]
        self._saved = [(m, n, getattr(m, n)) for m, n in self._saved]
        k1, fwd, bwd, bwd2 = (f for _, _, f in self._saved)

        def k1_spy(query, verts, *a, **k):
            if query.shape[0]:
                self.k1.append((int(query.shape[0]), int(verts.shape[0])))
            return k1(query, verts, *a, **k)

        def fwd_spy(image, coords):
            if coords.shape[1]:
                self.k2.append(("fwd", tuple(image.shape), coords, None))
            return fwd(image, coords)

        def bwd_spy(g, image, coords, need_image, need_coords):
            if coords.shape[1] and (need_image or need_coords):
                self.k2.append(("bwd", tuple(image.shape), coords,
                                (bool(need_image), bool(need_coords))))
            return bwd(g, image, coords, need_image, need_coords)

        def bwd2_spy(g, image, coords, gg_image, gg_coords, need):
            need_i = need[1] and gg_coords is not None
            if coords.shape[1] and (need[0] or need_i or need[2]):
                self.k2.append(("bwd2", tuple(image.shape), coords,
                                (gg_image is not None, gg_coords is not None,
                                 tuple(bool(x) for x in need))))
            return bwd2(g, image, coords, gg_image, gg_coords, need)

        for (m, n, _), spy in zip(self._saved,
                                  (k1_spy, fwd_spy, bwd_spy, bwd2_spy)):
            setattr(m, n, spy)
        return self

    def __exit__(self, *exc):
        for m, n, f in self._saved:
            setattr(m, n, f)
