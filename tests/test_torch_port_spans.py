"""The port's spans and host reads (``mpsnerf_torch/utils/spans.py``) on
the CPU: nesting with parent and root ids; nothing recorded and no
``record_function`` opened while neither a profiler nor ``recording()``
is on; under a CPU-activity ``torch.profiler``, each span's
``record_function`` event in the spans' order and no longer than its
span; a thread that is not profiled leaves the profiled thread's
recording alone; a served view through the serve tests' 32^2 bundle
(``serve.request`` over ``serve.prep``, ``view.prepare``,
``view.prepass``, ``view.tail``, ``view.fetch``, five host reads); a
train item (``item.copy``, then ``train.item`` with its log reads and
each step's backward)."""

import copy
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpsnerf_torch.data import to_device_input
from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
from mpsnerf_torch.train.trainer import TrainConfig, Trainer
from mpsnerf_torch.utils import spans
from tests.test_torch_port_serve import VIEW, setup  # noqa: F401 (fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

VIEW_SPANS = ("serve.prep", "view.prepare", "view.prepass", "view.tail",
              "view.fetch")


@pytest.fixture(autouse=True)
def closed():
    """Each test starts with no recording open."""
    spans.recorded()


def syncs(rec):
    return sum(s.name.startswith("sync.") for s in rec.spans)


def by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_parent_and_root_ids():
    with spans.recording():
        with spans.span("a", k=1) as a:
            with spans.span("b") as b:
                with spans.span("c") as c:
                    pass
            with spans.sync("site"):
                pass
        with spans.span("d") as d:
            x = spans.host_read(torch.tensor(3), "read")
    rec = spans.recorded()
    assert x == 3 and isinstance(x, int)
    assert [s.name for s in rec.spans] == ["c", "b", "sync.site", "a",
                                           "sync.read", "d"]
    assert (a.parent, a.root, a.attrs) == (None, a.id, {"k": 1})
    assert (b.parent, b.root) == (a.id, a.id)
    assert (c.parent, c.root) == (b.id, a.id)
    assert (d.parent, d.root) == (None, d.id)
    sync_a, sync_d = by_name(rec)["sync.site"][0], by_name(rec)["sync.read"][0]
    assert (sync_a.parent, sync_a.root) == (a.id, a.id)
    assert (sync_d.parent, sync_d.root) == (d.id, d.id)
    assert syncs(rec) == 2 and rec.dropped == 0
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= a.end_ns <= d.start_ns <= d.end_ns
    # a later block starts a new recording
    with spans.recording():
        with spans.span("e"):
            pass
    assert [s.name for s in spans.recorded().spans] == ["e"]


def test_a_recording_keeps_at_most_max_spans(monkeypatch):
    monkeypatch.setattr(spans, "MAX_SPANS", 3)
    with spans.recording():
        for i in range(5):
            with spans.span("x", i=i):
                pass
    rec = spans.recorded()
    assert [s.attrs["i"] for s in rec.spans] == [0, 1, 2]
    assert rec.dropped == 2


def test_nothing_recorded_with_the_profiler_off(monkeypatch):
    with spans.recording():
        with spans.span("kept"):
            pass
    opened = []
    real = torch.profiler.record_function

    def spy(*a, **k):
        opened.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    assert not torch.autograd._profiler_enabled()
    with spans.span("off", k=2) as s:
        with spans.sync("off") as t:
            v = spans.host_read(torch.tensor([1.0, 2.0]), "off")
    assert s is None and t is None and torch.equal(v, torch.tensor([1., 2.]))
    assert opened == []
    rec = spans.recorded()
    assert [x.name for x in rec.spans] == ["kept"] and rec.dropped == 0
    # recording() turns them on, record_function included
    with spans.recording():
        with spans.span("on"):
            pass
    assert opened == [("on",)]


def test_record_function_events_lie_within_the_span_stamps():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            for i in range(3):
                with spans.span("inner", i=i):
                    torch.ones(64).sum()
            spans.host_read(torch.ones(()), "probe")
    rec = spans.recorded()
    assert [s.name for s in rec.spans] == ["inner"] * 3 + ["sync.probe",
                                                           "outer"]
    # each span's event, in the spans' order (on the profiler's own
    # clock) and no longer than the span it is opened in
    events = sorted((e for e in prof.events()
                     if e.name in ("outer", "inner", "sync.probe")),
                    key=lambda e: e.time_range.start)
    mine = sorted(rec.spans, key=lambda x: x.start_ns)
    assert [e.name for e in events] == [x.name for x in mine]
    for e, x in zip(events, mine):
        assert 1e3 * (e.time_range.end - e.time_range.start) <= \
            x.end_ns - x.start_ns
    outer = events[0].time_range
    assert all(outer.start <= e.time_range.start <= e.time_range.end
               <= outer.end for e in events[1:])
    # once read, it ends: the next profile records its own
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("again"):
            pass
    assert [s.name for s in spans.recorded().spans] == ["again"]


def test_an_unprofiled_thread_leaves_the_recording_alone():
    seen = []

    def other():
        seen.append(torch.autograd._profiler_enabled())
        with spans.span("other") as o:
            seen.append(o)

    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("a"):
            pass
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with spans.span("b"):
            pass
    assert seen == [False, None]
    assert [s.name for s in spans.recorded().spans] == ["a", "b"]


def test_a_served_view_records_its_layers_and_five_reads(setup):  # noqa: F811
    s = setup
    item = s["items"][0]
    s["served"].render_view(item, item, VIEW)  # caches warm
    with spans.recording():
        img = s["served"].render_view(item, item, VIEW)
    assert img.shape == (32 * 32, 3)
    rec = spans.recorded()
    named = by_name(rec)
    (req,) = named["serve.request"]
    assert (req.parent, req.root) == (None, req.id)
    for name in VIEW_SPANS:
        (x,) = named[name]
        assert (x.parent, x.root) == (req.id, req.id), name
        assert req.start_ns <= x.start_ns <= x.end_ns <= req.end_ns
    starts = [named[n][0].start_ns for n in VIEW_SPANS]
    assert starts == sorted(starts)
    reads = [x for x in rec.spans if x.name.startswith("sync.")]
    assert len(reads) == 5 and rec.dropped == 0
    parents = {x.id: x.name for x in rec.spans}
    assert sorted((parents[x.parent], x.name) for x in reads) == [
        ("view.fetch", "sync.fetch.acc"), ("view.fetch", "sync.fetch.dropped"),
        ("view.fetch", "sync.fetch.rgb"),
        ("view.prepass", "sync.prepass.body"),
        ("view.prepass", "sync.prepass.candidates")]


def test_a_train_item_records_its_copy_and_reads(setup):  # noqa: F811
    s = setup
    ds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=32,
                               n_rays=32, n_verts=500, split="train")
    trainer = Trainer(copy.deepcopy(s["model"]),
                      TrainConfig(n_samples=8), device="cpu")
    item = ds.get_item(0, instance_idx=0)
    with spans.recording():
        inp = to_device_input(item, "cpu", rays=True)
        logs = trainer.train_item(s["smpl"], inp, inp)
    rec = spans.recorded()
    named = by_name(rec)
    (cp,) = named["item.copy"]
    (it,) = named["train.item"]
    assert (cp.parent, cp.root) == (None, cp.id)
    assert (it.parent, it.root) == (None, it.id)
    assert cp.end_ns <= it.start_ns
    n_views = int(inp["rgb_all"].shape[0])
    # six means over the views and each view's n_dropped; each step's
    # backward (the cumprod's zero test)
    reads = named["sync.item.logs"]
    backward = named["sync.step.backward"]
    assert len(reads) == 7 * n_views and len(backward) == n_views
    assert syncs(rec) == 8 * n_views
    assert all((x.parent, x.root) == (it.id, it.id)
               for x in reads + backward)
    assert logs["n_dropped"] == 0.0 and logs["loss"] > 0.0
