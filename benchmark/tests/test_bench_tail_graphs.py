"""The query tail's two readers on synthetic runs: ``graph_tiles_pct.serve``
(the replayed share of the tiles the ``view.tail`` spans count: full,
partial, none, and nothing where the spans carry no counts or there are
no spans) and ``layernorm_ms.serve`` (LayerNorm's kernels picked out of
the trace by name, torch's and the port's, per profiled view)."""

import pathlib
import types

import pytest

from benchmark.harness.main import metric_reader
from benchmark.harness.trace import Trace

ROOT = pathlib.Path(__file__).resolve().parents[2]
OPS = [("Memcpy DtoH (Device -> Pinned)", 0.0, 1.0)]


def run_of(ops=OPS, units=1):
    return types.SimpleNamespace(trace=Trace(1e-3, ops, 0.0, len(ops)),
                                 profiled_units=units)


def tails(*counts):
    """A recording of one ``serve.request`` with a ``view.tail`` span of
    each (tiles, graph_tiles) count, or of no counts for None."""
    spans = [types.SimpleNamespace(id=1, name="serve.request", parent=None,
                                   attrs={}, start_ns=0, end_ns=10)]
    for i, c in enumerate(counts):
        attrs = {} if c is None else {"tiles": c[0], "graph_tiles": c[1]}
        spans.append(types.SimpleNamespace(id=2 + i, name="view.tail",
                                           parent=1, attrs=attrs,
                                           start_ns=1, end_ns=9))
    return types.SimpleNamespace(spans=spans, dropped=0)


@pytest.mark.parametrize("counts, share", [
    ([(146, 146)], 100.0),
    ([(146, 146), (150, 150)], 100.0),
    ([(146, 73)], 50.0),
    ([(100, 100), (100, 0)], 50.0),
    ([(146, 0)], 0.0),
])
def test_the_replayed_share_of_the_tiles(monkeypatch, counts, share):
    from mpsnerf_torch.utils import spans

    monkeypatch.setattr(spans, "recorded", lambda: tails(*counts))
    read = metric_reader(ROOT, "graph_tiles_pct.serve")
    assert read(run_of()) == pytest.approx(share)


@pytest.mark.parametrize("counts", [[], [None], [(146, 146), None],
                                    [(0, 0)]])
def test_no_counts_read_nothing(monkeypatch, counts):
    """No tail span, a tail span without the counts (a program before
    them), or no tile at all: nothing to read."""
    from mpsnerf_torch.utils import spans

    monkeypatch.setattr(spans, "recorded", lambda: tails(*counts))
    read = metric_reader(ROOT, "graph_tiles_pct.serve")
    assert read(run_of()) is None


def test_no_spans_or_no_trace_read_nothing(monkeypatch):
    from mpsnerf_torch.utils import spans

    read = metric_reader(ROOT, "graph_tiles_pct.serve")
    monkeypatch.setattr(spans, "recorded", lambda: types.SimpleNamespace(
        spans=[], dropped=0))
    assert read(run_of()) is None
    monkeypatch.setattr(spans, "recorded", lambda: tails((146, 146)))
    assert read(run_of([])) is None      # no device operation (the CPU)


LN_OPS = [
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel"
     "<float, float>(long, float, float const*, float*, float*)", 0.0, 700.0),
    ("void at::native::(anonymous namespace)::LayerNormForwardCUDAKernel"
     "<float, float>(long, float const*, float const*, float const*, "
     "float const*, float const*, float*)", 700.0, 900.0),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<float, float>(int, float, float const*, float const*, float const*, "
     "float*, float*, float*)", 900.0, 950.0),
    ("void (anonymous namespace)::layer_norm_rows<5>(float const*, float "
     "const*, float const*, float*, long, int, float)", 1000.0, 1010.0),
    ("void (anonymous namespace)::layer_norm_wide(float const*, float "
     "const*, float const*, float*, long, int, float)", 1010.0, 1015.0),
    # not LayerNorm: a GEMM, an elementwise kernel, a copy
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_warpsize"
     "2x2x1_ffma_aligna4_alignc4_execute_kernel_trt", 2000.0, 3000.0),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul>)", 3000.0, 3500.0),
    ("Memcpy DtoH (Device -> Pinned)", 4000.0, 4100.0),
]


@pytest.mark.parametrize("units", [1, 2])
def test_layer_norm_kernels_are_picked_out_by_name(units):
    read = metric_reader(ROOT, "layernorm_ms.serve")
    # 700 + 200 + 50 us of torch's, 10 + 5 us of the port's
    assert read(run_of(LN_OPS, units)) == pytest.approx(0.965 / units)
    # the port's alone (the change), torch's alone (the parent)
    assert read(run_of(LN_OPS[3:], units)) == pytest.approx(0.015 / units)
    assert read(run_of(LN_OPS[:3] + LN_OPS[5:], units)) == \
        pytest.approx(0.95 / units)


def test_no_layer_norm_or_nothing_profiled_reads_nothing():
    read = metric_reader(ROOT, "layernorm_ms.serve")
    assert read(run_of(LN_OPS[5:])) is None
    assert read(run_of([])) is None
    assert read(run_of(LN_OPS, 0)) is None
