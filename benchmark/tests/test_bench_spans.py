"""The alignment of the program's spans with the device trace
(``benchmark/harness/spans.py``) on a synthetic trace whose base is known:
the offset recovered from the reads' copies, the idle time put down to the
innermost open span, a clock rate where the device's timestamps drift,
and no reading where a copy falls outside every offset the others allow,
the counts differ or the stretch dropped spans."""

import pathlib
import types

import pytest

from benchmark.harness import spans as hs
from benchmark.harness.main import metric_reader
from benchmark.harness.trace import Trace

BASE = 1_792_306_808_288_332_433   # host ns of the trace's 0
US = 1000


def span(sid, name, start_us, end_us, parent=None):
    return types.SimpleNamespace(id=sid, name=name, parent=parent,
                                 start_ns=BASE + start_us * US,
                                 end_ns=BASE + end_us * US)


def recording():
    return types.SimpleNamespace(spans=[
        span(3, "sync.a", 300, 380, 2), span(2, "A", 100, 400, 1),
        span(5, "sync.b", 850, 890, 4), span(4, "B", 500, 900, 1),
        span(1, "root", 0, 1000)], dropped=0)


def trace(second_copy=(860, 880)):
    ops = [("kernel_1", 50.0, 250.0),
           ("Memcpy DtoH (Device -> Pinned)", 360.0, 370.0),
           ("kernel_2", 600.0, 700.0),
           ("Memcpy DtoH (Device -> Pageable)", *map(float, second_copy)),
           ("kernel_3", 1200.0, 1300.0)]   # after the root: not counted
    return Trace(1e-3, ops, 0.0, 0)


def test_the_offset_is_recovered():
    a = hs.align(recording(), trace())
    # pair 1 allows [-60, +10] us, pair 2 [-10, +10] us around the base
    assert a == hs.Alignment(BASE, 0.0, 20 * US, 2)


def test_a_drifting_device_clock_takes_a_rate():
    # the device's timestamps run 0.2 % slow: no one offset holds over
    # half a second, an offset and a rate do
    rate = 2e-3
    rec = types.SimpleNamespace(spans=[
        span(1, "sync.a", 1000, 1040), span(2, "sync.b", 500000, 500040)],
        dropped=0)
    late = 500020 / (1 + rate)
    tr = Trace(1.0, [("Memcpy DtoH (Device -> Pinned)", 1010.0, 1012.0),
                     ("Memcpy DtoH (Device -> Pinned)", late, late + 2)],
               0.0, 0)
    a = hs.align(rec, tr)
    assert a.rate == pytest.approx(rate, abs=1e-4) and a.slack_ns >= 0
    for s, (_, cs, ce) in zip(rec.spans, tr.ops):
        assert s.start_ns <= a.host_ns(cs) <= a.host_ns(ce) <= s.end_ns
    # beyond the largest rate considered: nothing
    far = 500020 / (1 + 3 * hs.MAX_RATE)
    tr = tr._replace(ops=[tr.ops[0], (tr.ops[1][0], far, far + 2)])
    assert hs.align(rec, tr) is None


def test_idle_time_goes_to_the_innermost_open_span():
    rec, tr = recording(), trace()
    idle = hs.idle_by_span(rec, tr, hs.align(rec, tr))
    # busy inside the root: 200 + 10 + 100 + 20 us of its 1000
    assert idle == {"": 670 * US, "root": 250 * US, "A": 70 * US,
                    "sync.a": 70 * US, "B": 260 * US, "sync.b": 20 * US}


def test_the_readers_take_the_program_spans(monkeypatch):
    from mpsnerf_torch.utils import spans

    monkeypatch.setattr(spans, "recorded", recording)
    run = types.SimpleNamespace(trace=trace(), profiled_units=1)
    assert hs.idle_share(run, ("B",)) == pytest.approx(100 * 260 / 670)
    assert hs.ms_per(hs.program_spans(run), ("A", "B"), "root") == \
        pytest.approx(0.7)
    # the reads are the sync spans: two in the one step, and in the one
    # view once the root is a request
    root = pathlib.Path(__file__).resolve().parents[2]
    per_step = metric_reader(root, "host_syncs_per_step")
    per_view = metric_reader(root, "host_syncs_per_view")
    assert per_step(run) == 2.0 and per_view(run) is None
    view = recording()
    view.spans[-1].name = "serve.request"
    monkeypatch.setattr(spans, "recorded", lambda: view)
    assert per_view(run) == 2.0
    # no device operation (a CPU run): nothing to read
    cpu = types.SimpleNamespace(trace=Trace(1e-3, [], 0.0, 0),
                                profiled_units=1)
    assert hs.program_spans(cpu) is None and hs.idle_share(cpu, ("B",)) \
        is None
    # a stretch that kept fewer spans than it recorded: nothing
    monkeypatch.setattr(spans, "recorded", lambda: types.SimpleNamespace(
        spans=recording().spans, dropped=1))
    assert hs.program_spans(run) is None and hs.idle_share(run, ("B",)) \
        is None


@pytest.mark.parametrize("second_copy", [(950, 980), (300, 310)])
def test_a_copy_outside_every_offset_reads_nothing(second_copy):
    # (950, 980): inside sync.b only at offsets -100..-90 us, which pair 1
    # does not allow; (300, 310) also pairs in the other order
    assert hs.align(recording(), trace(second_copy)) is None


def test_counts_that_differ_read_nothing():
    rec = recording()
    rec.spans.append(span(6, "sync.c", 950, 960, 1))
    assert hs.align(rec, trace()) is None
