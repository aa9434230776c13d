"""The host's preparation of a served view per profiled view, ms: the
program's spans ``serve.prep`` (the request's content keys, validation and
cache lookup) and ``view.prepare`` (the device items, the rays to the
card), summed over the traced stretch, over its ``serve.request``
spans."""

from benchmark.harness.spans import ms_per, program_spans


def read(run):
    rec = program_spans(run)
    return rec and ms_per(rec, ("serve.prep", "view.prepare"),
                          "serve.request")
