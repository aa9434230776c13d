"""The item's copy to the card per profiled item, ms: the program's
``item.copy`` spans (``to_device_input``: the source's and, in a pair, the
target's) over its ``train.item`` spans."""

from benchmark.harness.spans import ms_per, program_spans


def read(run):
    rec = program_spans(run)
    return rec and ms_per(rec, ("item.copy",), "train.item")
