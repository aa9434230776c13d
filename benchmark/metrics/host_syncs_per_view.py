"""The host's reads of the device per profiled view: the program's
``sync.*`` spans (one per ``host_read``/``sync`` of the traced stretch)
over its ``serve.request`` spans."""

from benchmark.harness.spans import host_reads, named, program_spans


def read(run):
    rec = program_spans(run)
    views = rec and len(named(rec, "serve.request"))
    if not views:
        return None
    return len(host_reads(rec)) / views
