"""Spans of the port's hot paths, with the host's reads of the device.

A span is a stretch of host time at a layer boundary (``serve.request``
down to ``view.tail``; ``item.copy``, ``train.item``): its name, start and
end on ``time.time_ns()``, the id of the span it opened in, the id of its
root (the request or item it belongs to) and a few scalar attributes.
:func:`host_read` and :func:`sync` make each read of the device by the
host a span ``sync.<site>``, so a recording's reads are its ``sync.*``
spans.

Spans record only while ``torch.profiler`` profiles the calling thread
(the flag ``record_function`` reads) or inside :func:`recording`;
otherwise a span costs that one check.  A recording span also opens
``torch.profiler.record_function(name)``, so an operator's profile, e.g.::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as p:
        served.render_view(sp_item, tp_item, k)
    p.export_chrome_trace("view.json")

shows the spans above the kernels they launched.  The profiler's device
events are on the same epoch clock, up to an offset that each read's
device-to-host copy, inside its ``sync`` span, pins down.

A span that records, or a :func:`recording` block, opens a recording
where none is open; every span that records joins the open one (so two
profiles with no :func:`recorded` between them are one).  It is closed by
:func:`recorded` and by the end of the :func:`recording` block that
opened it, never by a thread that neither profiles nor records.
:func:`recorded` returns the last one from memory, at most
:data:`MAX_SPANS` spans.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import types
from typing import Dict, List, NamedTuple

import torch

__all__ = ["span", "host_read", "sync", "recording", "recorded",
           "Recording", "MAX_SPANS"]

MAX_SPANS = 1 << 16
_profiling = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_lock = threading.Lock()
_open = threading.local()   # .stack: the thread's open spans


class Recording(NamedTuple):
    spans: List["Span"]   # in the order they closed
    dropped: int          # spans that closed past MAX_SPANS


# forced: the depth of recording() blocks; live: a recording is open
_s = types.SimpleNamespace(forced=0, live=False, spans=[], dropped=0)


def _restart() -> None:
    """Opens a new recording (the lock held)."""
    _s.spans, _s.dropped, _s.live = [], 0, True


def _on() -> bool:
    if not (_s.forced or _profiling()):
        return False
    if not _s.live:
        with _lock:
            if not _s.live:
                _restart()
    return True


class Span:
    """One span; ``start_ns``/``end_ns`` on ``time.time_ns()``."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns",
                 "end_ns", "_rf")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __enter__(self) -> "Span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[-1].root if stack else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        self._rf = None
        _open.stack.pop()
        with _lock:
            if len(_s.spans) < MAX_SPANS:
                _s.spans.append(self)
            else:
                _s.dropped += 1


def span(name: str, **attrs):
    """A context manager that records the span ``name`` with scalar
    ``attrs`` while recording is on (``as`` gives the :class:`Span`), and
    does nothing otherwise (``as`` gives None)."""
    return Span(name, attrs) if _on() else _NULL


def sync(site: str):
    """:func:`span` ``sync.<site>`` around a torch call that reads the
    device inside itself (``nonzero``, boolean-mask indexing)."""
    return span("sync." + site)


def host_read(x: torch.Tensor, site: str):
    """The host's read of ``x``, as a :func:`sync` span: a 0-d tensor as
    a Python number (``x.item()``: int, float or bool by its dtype), any
    other as a CPU tensor."""
    with sync(site):
        return x.item() if x.dim() == 0 else x.cpu()


@contextlib.contextmanager
def recording():
    """Record spans in this block whether or not a profiler runs (in every
    thread); entered with no recording open, it opens one and closes it at
    its end."""
    with _lock:
        opened = not _s.live
        if opened:
            _restart()
        _s.forced += 1
    try:
        yield
    finally:
        with _lock:
            _s.forced -= 1
            if opened:
                _s.live = False


def recorded() -> Recording:
    """The spans of the last recording (a copy).  Outside a
    :func:`recording` block this closes it: the next span that records
    opens another."""
    with _lock:
        _s.live = bool(_s.forced)
        return Recording(list(_s.spans), _s.dropped)

