"""The share of the query tail's tiles that replayed as CUDA graphs in the
profiled views, %: the ``graph_tiles`` over the ``tiles`` attributes of
the program's ``view.tail`` spans (``ViewRenderer._render_global``).  A
program whose tail spans carry no such counts reads nothing."""

from benchmark.harness.spans import named, program_spans


def read(run):
    rec = program_spans(run)
    tails = rec and [s.attrs for s in named(rec, "view.tail")]
    if not tails or not all("tiles" in a and "graph_tiles" in a
                            for a in tails):
        return None
    tiles = sum(a["tiles"] for a in tails)
    return 100.0 * sum(a["graph_tiles"] for a in tails) / tiles \
        if tiles else None
