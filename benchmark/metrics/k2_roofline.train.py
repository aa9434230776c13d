"""K2's forward, backward and double backward against their rooflines
over the profiled steps, pooled, %: the sum of each launch's least time
(``work.k2_*_work`` at the pixels its samples touch) over the sum of the
launches' device time."""

from benchmark.harness.trace import (
    K2_BWD2_KERNELS, K2_BWD_KERNELS, K2_FWD_KERNELS, kernel_seconds)
from benchmark.harness.work import (
    bound_s, k2_bwd2_work, k2_bwd_work, k2_fwd_work, touched_pixels)


def read(run):
    secs = kernel_seconds(run.trace, K2_FWD_KERNELS + K2_BWD_KERNELS
                          + K2_BWD2_KERNELS)
    calls = run.launches.k2
    if not secs or len(secs) != len(calls):
        return None
    bound = 0.0
    for kind, (v, c, h, w), coords, flags in calls:
        n, px = coords.shape[1], touched_pixels(coords, h, w)
        if kind == "fwd":
            work = k2_fwd_work(v, c, n, px)
        elif kind == "bwd":
            work = k2_bwd_work(v, c, n, px, flags)
        else:
            work = k2_bwd2_work(v, c, n, px, *flags)
        bound += bound_s(*work)
    return 100.0 * bound / sum(secs)
