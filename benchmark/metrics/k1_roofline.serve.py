"""K1's search against its roofline over the profiled views, %: the sum
of each launch's least time (``work.k1_work``: its queries and vertices
read once, its answers written once, one pair a query) over the sum of
the launches' device time."""

from benchmark.harness.trace import K1_KERNELS, kernel_seconds
from benchmark.harness.work import bound_s, k1_work


def read(run):
    secs = kernel_seconds(run.trace, K1_KERNELS)
    shapes = run.launches.k1
    if not secs or len(secs) != len(shapes):
        return None
    bound = sum(bound_s(*k1_work(n, nv)) for n, nv in shapes)
    return 100.0 * bound / sum(secs)
