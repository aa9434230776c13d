"""The card's idle time inside the query tail over its idle time inside
the served views, %: the union of the device operations' intervals, put
on the host's clock by the reads' copies (``harness/spans.py``), its
complement inside the ``serve.request`` spans, the share of it while
``view.tail`` was the innermost span open on the host."""

from benchmark.harness.spans import idle_share


def read(run):
    return idle_share(run, ("view.tail",))
