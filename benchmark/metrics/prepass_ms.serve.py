"""The pre-passes per profiled view, ms: the program's span
``view.prepass`` (the plan and fine pre-passes with their two count
reads) over its ``serve.request`` spans."""

from benchmark.harness.spans import ms_per, program_spans


def read(run):
    rec = program_spans(run)
    return rec and ms_per(rec, ("view.prepass",), "serve.request")
