"""K2's forward against its roofline over the profiled views, %: the sum
of each launch's least time (``work.k2_fwd_work`` at the pixels its
samples touch) over the sum of the launches' device time."""

from benchmark.harness.trace import K2_FWD_KERNELS, kernel_seconds
from benchmark.harness.work import bound_s, k2_fwd_work, touched_pixels


def read(run):
    secs = kernel_seconds(run.trace, K2_FWD_KERNELS)
    calls = [c for c in run.launches.k2 if c[0] == "fwd"]
    if not secs or len(secs) != len(calls):
        return None
    bound = 0.0
    for _, (v, c, h, w), coords, _ in calls:
        bound += bound_s(*k2_fwd_work(v, c, coords.shape[1],
                                      touched_pixels(coords, h, w)))
    return 100.0 * bound / sum(secs)
