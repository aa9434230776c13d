"""The program's spans beside the device trace.

While ``torch.profiler`` runs, the port records its spans on
``time.time_ns()`` (``mpsnerf_torch/utils/spans.py``; ``recorded()`` gives
them after the traced stretch).  The trace's operations are in us from the
profiler's start, a base that :class:`~benchmark.harness.trace.Trace` does
not keep, so :func:`align` recovers it from the host's reads (each one a
``sync.*`` span): every ``Memcpy DtoH`` operation runs inside the host
interval of the span that issued it, so the k-th copy and the k-th sync
span (each in time order) bound the offset from both sides.  The bounds of every pair
intersect, or there is no alignment (None): no reading rather than a wrong
one.  Over a view of seconds the device's timestamps can drift from the
host's clock by a few hundred ns a ms (0.4-0.6 ms over 2.5-3.8 s on an
H100), more than a read's span leaves; there the mapping takes a clock
rate besides the offset, the one that leaves the most slack.
:func:`idle_by_span` then takes the union of the device operations'
intervals on the host's clock, its complement inside the root spans, and
puts each stretch of it down to the innermost span open on the host.

Every function returns None where there is nothing to read: a program
without the span module, a stretch without spans, one that kept fewer
spans than it recorded, or one without a device.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional

DTOH = "Memcpy DtoH"


class Alignment(NamedTuple):
    offset_ns: int   # host ns of the trace's 0
    rate: float      # host ns per trace ns, less 1 (0: one offset holds)
    slack_ns: int    # width of the offsets every pair allows at that rate
    pairs: int       # copies paired with sync spans

    def host_ns(self, us: float) -> int:
        """A trace time (us from the profiler's start) on the host."""
        return self.offset_ns + round((1.0 + self.rate) * us * 1e3)


def program_spans(run):
    """The spans of the traced stretch (``recorded()``), or None: a
    program without the span module, a stretch that recorded no span or
    dropped some, a run that traced no device operation (the CPU)."""
    if not run.trace.ops:
        return None
    try:
        from mpsnerf_torch.utils import spans
    except ImportError:
        return None
    rec = spans.recorded()
    return rec if rec.spans and not rec.dropped else None


def named(rec, name: str) -> List:
    return [s for s in rec.spans if s.name == name]


def host_reads(rec) -> List:
    """The host's reads of the device: the ``sync.*`` spans."""
    return [s for s in rec.spans if s.name.startswith("sync.")]


def ms_per(rec, names, root: str) -> Optional[float]:
    """The summed ms of the spans called one of ``names`` per ``root``
    span (a view's request, an item)."""
    n = len(named(rec, root))
    if not n:
        return None
    return sum(s.end_ns - s.start_ns for s in rec.spans
               if s.name in names) * 1e-6 / n


MAX_RATE = 1e-2   # the largest clock rate error the alignment considers


def align(rec, trace) -> Optional[Alignment]:
    """The mapping of trace times to the host's clock that puts the k-th
    ``Memcpy DtoH`` operation inside the k-th ``sync.*`` span for every
    k: one offset where one holds, else an offset and a clock rate error
    (the largest slack), or None (no copies, counts that differ, no rate
    within :data:`MAX_RATE` at which the bounds meet)."""
    syncs = sorted(host_reads(rec), key=lambda s: s.start_ns)
    copies = sorted((o for o in trace.ops if o[0].startswith(DTOH)),
                    key=lambda o: o[1])
    if not copies or len(copies) != len(syncs):
        return None
    base = syncs[0].start_ns
    pairs = [(s.start_ns - base, s.end_ns - base, c[1] * 1e3, c[2] * 1e3)
             for s, c in zip(syncs, copies)]

    def bounds(rate):
        k = 1.0 + rate
        return (max(s - k * cs for s, _, cs, _ in pairs),
                min(e - k * ce for _, e, _, ce in pairs))

    def slack(rate):
        lo, hi = bounds(rate)
        return hi - lo

    rate = 0.0
    if slack(rate) < 0:
        # the slack is concave in the rate: its largest value by thirds
        a, b = -MAX_RATE, MAX_RATE
        for _ in range(200):
            m1, m2 = a + (b - a) / 3, b - (b - a) / 3
            if slack(m1) < slack(m2):
                a = m1
            else:
                b = m2
        rate = (a + b) / 2
    lo, hi = bounds(rate)
    if lo > hi:
        return None
    return Alignment(base + round((lo + hi) / 2), rate, round(hi - lo),
                     len(pairs))


class _Busy:
    """The union of the device operations' intervals (host ns), with a
    prefix sum for the busy time inside any interval."""

    def __init__(self, trace, alignment: Alignment):
        self.starts, self.ends, self.before = [], [], [0]
        for _, s, e in sorted(trace.ops, key=lambda o: o[1]):
            s, e = alignment.host_ns(s), alignment.host_ns(e)
            if self.ends and s <= self.ends[-1]:
                if e > self.ends[-1]:
                    self.before[-1] += e - self.ends[-1]
                    self.ends[-1] = e
                continue
            self.starts.append(s)
            self.ends.append(e)
            self.before.append(self.before[-1] + e - s)

    def _upto(self, t: int) -> int:
        """Busy ns before ``t``."""
        i = bisect.bisect_right(self.starts, t)
        if not i:
            return 0
        return self.before[i - 1] + min(t, self.ends[i - 1]) \
            - self.starts[i - 1]

    def idle(self, a: int, b: int) -> int:
        return (b - a) - (self._upto(b) - self._upto(a))


def idle_by_span(rec, trace, alignment: Alignment) -> Dict[str, int]:
    """The device's idle ns inside the root spans, each stretch put down to
    the innermost span open on the host, summed by span name; ``""`` holds
    the total."""
    busy = _Busy(trace, alignment)
    inside: Dict[int, int] = {}
    for s in rec.spans:
        inside[s.id] = busy.idle(s.start_ns, s.end_ns)
    own = dict(inside)
    for s in rec.spans:
        if s.parent in own:
            own[s.parent] -= inside[s.id]
    out: Dict[str, int] = {"": 0}
    for s in rec.spans:
        out[s.name] = out.get(s.name, 0) + own[s.id]
        if s.parent is None:
            out[""] += inside[s.id]
    return out


def idle_share(run, names) -> Optional[float]:
    """The device's idle time put down to the spans called one of
    ``names`` (:func:`idle_by_span`) over its idle time inside every root
    span of the traced stretch, %."""
    rec = program_spans(run)
    alignment = rec and align(rec, run.trace)
    if not alignment:
        return None
    idle = idle_by_span(rec, run.trace, alignment)
    if not idle[""]:
        return None
    return 100.0 * sum(idle.get(n, 0) for n in names) / idle[""]
