"""The card's idle time inside the items' copies over its idle time inside
the traced stretch's root spans (the copies and ``train.item``), %: the
union of the device operations' intervals, put on the host's clock by the
reads' copies (``harness/spans.py``), the share of its complement while
``item.copy`` was the innermost span open on the host."""

from benchmark.harness.spans import idle_share


def read(run):
    return idle_share(run, ("item.copy",))
