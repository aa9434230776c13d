"""The query tail's host time per profiled view, ms: the program's span
``view.tail`` (``render_rays_compact``: the tile loop's dispatch through
the compositing) over its ``serve.request`` spans."""

from benchmark.harness.spans import ms_per, program_spans


def read(run):
    rec = program_spans(run)
    return rec and ms_per(rec, ("view.tail",), "serve.request")
