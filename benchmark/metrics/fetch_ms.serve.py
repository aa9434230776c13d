"""The image's fetch per profiled view, ms: the program's span
``view.fetch`` (``finish_view``: the dropped count, the colours and
opacities to the host, the scatter) over its ``serve.request`` spans."""

from benchmark.harness.spans import ms_per, program_spans


def read(run):
    rec = program_spans(run)
    return rec and ms_per(rec, ("view.fetch",), "serve.request")
