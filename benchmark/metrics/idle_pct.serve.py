"""The device's idle share over the profiled views: 1 - (the union of the
device operations' intervals) / (the profiled span's wall time), %."""


def read(run):
    t = run.trace
    if not t.ops or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
