"""The host's calls that put work on the device (kernel and graph
launches, asynchronous copies and sets) per profiled view, counted from
the profiler's runtime events (a captured graph's replay counts once)."""


def read(run):
    if run.trace.launch_calls <= 0 or run.profiled_units <= 0:
        return None
    return run.trace.launch_calls / run.profiled_units
