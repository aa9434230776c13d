"""The host's reads of the device per profiled optimizer step: the
program's ``sync.*`` spans (one per ``host_read``/``sync`` of the traced
stretch) over the steps the stretch ran."""

from benchmark.harness.spans import host_reads, program_spans


def read(run):
    rec = program_spans(run)
    if not rec or run.profiled_units <= 0:
        return None
    return len(host_reads(rec)) / run.profiled_units
