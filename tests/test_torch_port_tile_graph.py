"""The query tail's tiles replayed as CUDA graphs between their K1 and K2
launches (``renderer/tile_graphs.py``), on a 64² synthetic view (600
vertices, 16 samples a ray).

On the CPU: which tiles qualify (``graphable``), the tile's three
stretches (``MPSNeRF``'s methods that ``query``'s tail runs) run eagerly
through ``TileGraphs`` in place of their graphs, equal to ``query`` bit for
bit, with the eager K1 and K2 on each view's own latent, and the counts the
``view.tail`` span carries.
On the card: a replayed view equal to the eager one at 1, 2 and 4 tiles,
for another target pose of the source and after a change of source (a new
capture); the replays under ``set_sync_debug_mode("error")``; one K1 and
two K2-forward launches a tile, each K2 call with coords that still hold
their values after the view, and the LayerNorm launched at the capture
only."""

import numpy as np
import pytest
import torch

from mpsnerf_torch.data import attach_body_grid, to_device_input
from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
from mpsnerf_torch.eval.runner import ViewRenderer, view_rays
from mpsnerf_torch.models import transformer
from mpsnerf_torch.models.correction_f3d import CorrectionF3D
from mpsnerf_torch.models.mps_nerf import MPSNeRF
from mpsnerf_torch.ops import grid_sample, knn
from mpsnerf_torch.renderer import render, tile_graphs
from mpsnerf_torch.renderer.tile_graphs import TileGraphs, graphable
from mpsnerf_torch.utils import spans
# by the test directory's own path: a machine with the card may have an
# installed package named ``tests`` that hides this one
from kernel_launches import launches  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_SAMPLES = 16
VIEW = 1


def _scene(device, source=0):
    """Items of three poses (``source`` the source's), the model (seeded),
    the latent, on ``device``."""
    ds = SyntheticHumanDataset(n_poses=3, n_cameras=4, image_size=64,
                               n_verts=600, split="test")
    items = [ds.get_item(i, instance_idx=0) for i in range(3)]
    for it in items:
        attach_body_grid(it)
    torch.manual_seed(0)
    model = MPSNeRF(num_instances=1).eval().to(device)
    s = dict(ds=ds, items=items, model=model,
             smpl=ds.smpl_for(0, device), device=device)
    _set_source(s, source)
    return s


def _set_source(s, i):
    s["sp_item"] = s["items"][i]
    s["sp"] = to_device_input(s["sp_item"], s["device"])
    with torch.no_grad():
        s["latent"] = s["model"].encode(s["sp"]["img_all"])


def _round_up(n, m):
    return max(1, -(-n // m)) * m


def _view(s, target):
    """View ``VIEW`` of item ``target``: (tp, rays, body count)."""
    it = s["items"][target]
    tp = to_device_input(it, s["device"])
    rays, _, _ = view_rays(it, VIEW, s["device"], it["mask_at_box_all"][VIEW])
    plan = render.plan_rays_compact(s["smpl"], tp, *rays, N_SAMPLES)
    fplan, _ = render.fine_rays_compact(s["smpl"], tp, *rays, N_SAMPLES,
                                        plan, int(plan.n_valid))
    return tp, rays, int(fplan.n_valid)


def _tile_for(n_body, tiles):
    tile = _round_up(-(-n_body // tiles), 8)
    assert _round_up(n_body, tile) // tile == tiles
    return tile


def _render(s, view, tile, graphs=None, fine=True):
    """The pre-passes and the render of ``view`` at tiles of ``tile``
    (grid-only without ``fine``)."""
    tp, rays, n_body = view
    plan = render.plan_rays_compact(s["smpl"], tp, *rays, N_SAMPLES)
    cap = _round_up(int(plan.n_valid), tile)
    if not fine:
        return render.render_rays_compact(
            s["model"], s["smpl"], s["sp"], tp, s["latent"], *rays,
            N_SAMPLES, capacity=cap, tile=tile, plan=plan, graphs=graphs)
    fplan, fids = render.fine_rays_compact(s["smpl"], tp, *rays, N_SAMPLES,
                                           plan, cap)
    return render.render_rays_compact(
        s["model"], s["smpl"], s["sp"], tp, s["latent"], *rays, N_SAMPLES,
        capacity=cap, tile=tile, fine_capacity=_round_up(n_body, tile),
        plan=plan, fine_plan=fplan, fine_ids=fids, graphs=graphs)


def _assert_equal(a, b):
    assert int(a[3]) == int(b[3]) == 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def scene():
    s = _scene("cpu")
    s["view"] = _view(s, 1)
    assert s["view"][-1] > 1000
    return s


# ---- which tiles qualify ----------------------------------------------------

class _Overridden(MPSNeRF):
    def query(self, *a, **k):
        return super().query(*a, **k)


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    return {
        "plain": MPSNeRF(num_instances=1),
        "correction": MPSNeRF(num_instances=1, correction_field=True,
                              correction_style="instance"),
        "skinning": MPSNeRF(num_instances=1, skinning_field=True),
        "overridden": _Overridden(num_instances=1),
        "correction_f3d": CorrectionF3D(),
    }


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("name, device, grad, expected", [
    ("plain", CUDA, False, True),
    ("plain", CUDA, True, False),        # autograd records the tile
    ("plain", CPU, False, False),        # the CPU
    ("correction", CUDA, False, False),  # the instance correction field
    ("skinning", CUDA, False, False),    # the skinning field
    ("overridden", CUDA, False, False),  # another query
    ("correction_f3d", CUDA, False, False),  # a numpy-era correction model
])
def test_which_tiles_replay(models, name, device, grad, expected):
    """The tail's query is always ``mode="full"`` without normals (the
    loop passes neither), with the fine ids given (grid-only tiles take
    none: the next test)."""
    with torch.set_grad_enabled(grad):
        assert graphable(models[name], device) is expected


def _eager_capture(self, t_buckets):
    """``_Captured._capture`` without graphs: every tile runs the three
    stretches eagerly where it would replay them."""
    self.replays = self._stretches()


@pytest.mark.parametrize("tiles", [1, 2, 4])
def test_the_stretches_equal_the_query(scene, tiles, monkeypatch):
    """The tile's three stretches with K1 and K2 between them, run on the
    graphs' buffers, are ``query``'s tail bit for bit."""
    s, tile = scene, _tile_for(scene["view"][-1], tiles)
    eager = _render(s, s["view"], tile)
    monkeypatch.setattr(render, "graphable", lambda model, device: True)
    monkeypatch.setattr(tile_graphs._Captured, "_capture", _eager_capture)
    graphs = TileGraphs()
    _assert_equal(_render(s, s["view"], tile, graphs), eager)
    assert graphs.tiles == graphs.graph_tiles == tiles
    assert eager[2].max() > 0.01  # the body is visible


def test_grid_only_and_cpu_tiles_run_eagerly(scene, monkeypatch):
    s, tile = scene, _tile_for(scene["view"][-1], 2)
    graphs = TileGraphs()
    _render(s, s["view"], tile, graphs)  # the CPU
    assert graphs.tiles == 2 and graphs.graph_tiles == 0
    # grid-only (no fine ids): eager even where the model qualifies
    monkeypatch.setattr(render, "graphable", lambda model, device: True)
    monkeypatch.setattr(tile_graphs._Captured, "_capture", _eager_capture)
    _render(s, s["view"], tile, graphs, fine=False)
    assert graphs.tiles > 2 and graphs.graph_tiles == 0


def test_a_new_latent_of_the_same_source_reaches_k2(scene, monkeypatch):
    """The graphs are kept while their key holds (the cameras, the shapes),
    but the eager K1 and K2 read each view's own latent and item."""
    s, tile = scene, _tile_for(scene["view"][-1], 2)
    monkeypatch.setattr(render, "graphable", lambda model, device: True)
    monkeypatch.setattr(tile_graphs._Captured, "_capture", _eager_capture)
    graphs = TileGraphs()
    first = _render(s, s["view"], tile, graphs)
    captured, latent = graphs._captured, s["latent"]
    s["latent"] = torch.flip(latent, dims=[-1]).contiguous(
        memory_format=torch.channels_last)
    try:
        assert graphs._key_of(s["model"], s["smpl"], s["sp"], s["latent"],
                              tile) == graphs._key
        replayed = _render(s, s["view"], tile, graphs)
        assert graphs._captured is captured
        assert not torch.equal(replayed[0], first[0])
        monkeypatch.undo()
        _assert_equal(replayed, _render(s, s["view"], tile))
    finally:
        s["latent"] = latent


@pytest.mark.parametrize("replayed", [False, True])
def test_the_tail_span_counts_the_tiles(scene, replayed, monkeypatch):
    s = scene
    if replayed:
        monkeypatch.setattr(render, "graphable", lambda model, device: True)
        monkeypatch.setattr(tile_graphs._Captured, "_capture",
                            _eager_capture)
    vr = ViewRenderer(s["model"], lambda gender: s["smpl"],
                      n_samples=N_SAMPLES,
                      tile=_tile_for(s["view"][-1], 3), device="cpu")
    with spans.recording():
        for _ in range(2):
            vr.render_view(s["sp_item"], s["items"][1], VIEW)
    tails = [x for x in spans.recorded().spans if x.name == "view.tail"]
    assert len(tails) == 2
    for t in tails:
        assert t.attrs == {"tiles": 3, "graph_tiles": 3 if replayed else 0}
    # outside a recording the renderer's counts run on
    vr.render_view(s["sp_item"], s["items"][1], VIEW)
    assert vr._tile_graphs.tiles == 9


# ---- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def card_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graphs run only there)")
    s = _scene(torch.device("cuda"))
    s["views"] = {t: _view(s, t) for t in (1, 2)}
    assert min(v[-1] for v in s["views"].values()) > 1000
    return s


@pytest.mark.card
@pytest.mark.parametrize("tiles", [1, 2, 4])
def test_a_replayed_view_equals_the_eager_one(card_scene, tiles):
    s = card_scene
    view = s["views"][1]
    tile = _tile_for(view[-1], tiles)
    eager = _render(s, view, tile)
    graphs = TileGraphs()
    for _ in range(2):  # the capture's view, then replays only
        _assert_equal(_render(s, view, tile, graphs), eager)
    assert graphs.tiles == graphs.graph_tiles == 2 * tiles


@pytest.mark.card
def test_another_pose_replays_and_another_source_captures_again(card_scene):
    s = card_scene
    tile = _tile_for(s["views"][1][-1], 2)
    graphs = TileGraphs()
    _assert_equal(_render(s, s["views"][1], tile, graphs),
                  _render(s, s["views"][1], tile))
    captured = graphs._captured
    # another target pose of the same source: the same graphs
    _assert_equal(_render(s, s["views"][2], tile, graphs),
                  _render(s, s["views"][2], tile))
    assert graphs._captured is captured and captured.replays is not None
    # another source: captured again, and still equal
    _set_source(s, 2)
    try:
        _assert_equal(_render(s, s["views"][1], tile, graphs),
                      _render(s, s["views"][1], tile))
        assert graphs._captured is not captured
        assert graphs.graph_tiles == graphs.tiles
    finally:
        _set_source(s, 0)


@pytest.mark.card
def test_replays_do_not_synchronise(card_scene, monkeypatch):
    s = card_scene
    view = s["views"][1]
    tile = _tile_for(view[-1], 4)
    graphs = TileGraphs()
    _render(s, view, tile, graphs)  # the capture
    torch.cuda.synchronize()
    run, seen = tile_graphs._Captured.run, []

    def checked(self, *a):
        seen.append(self.replays is not None)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(tile_graphs._Captured, "run", checked)
    _assert_equal(_render(s, view, tile, graphs), _render(s, view, tile))
    assert len(seen) == 4 and all(seen)


@pytest.mark.card
def test_each_tile_launches_k1_once_and_k2_twice(card_scene, monkeypatch,
                                                 launches):
    """A spy on the launchers, as the benchmark's: one K1 and two K2
    forward calls a replayed tile, each K2 call's coords its own and
    unchanged after the view; the LayerNorms (the transformer's 2 layers
    x 2 norms a tile) launched by the host at the capture, after the
    tile's one eager run, and never at a replay; every tile replayed."""
    s = card_scene
    view = s["views"][1]
    tile = _tile_for(view[-1], 4)
    graphs = TileGraphs()
    capturing, norm = [], transformer.layer_norm_cuda

    def recorded(*a, **k):
        capturing.append(torch.cuda.is_current_stream_capturing())
        return norm(*a, **k)

    monkeypatch.setattr(transformer, "layer_norm_cuda", recorded)
    _render(s, view, tile, graphs)  # an eager tile, the capture, replays
    torch.cuda.synchronize()
    assert launches["mpsnerf_layer_norm"] == len(capturing) == 8
    assert capturing == [False] * 4 + [True] * 4
    assert graphs.graph_tiles == graphs.tiles == 4
    launches.clear()
    k1, fwd = knn.nearest_vertex_cuda, grid_sample.grid_sample_patch_fwd_cuda
    seen = {"k1": [], "fwd": []}

    def k1_spy(query, verts, *a, **k):
        seen["k1"].append(int(query.shape[0]))
        return k1(query, verts, *a, **k)

    def fwd_spy(image, coords):
        seen["fwd"].append((coords, coords.clone()))
        return fwd(image, coords)

    monkeypatch.setattr(knn, "nearest_vertex_cuda", k1_spy)
    monkeypatch.setattr(grid_sample, "grid_sample_patch_fwd_cuda", fwd_spy)
    out = _render(s, view, tile, graphs)
    torch.cuda.synchronize()
    assert launches["mpsnerf_layer_norm"] == 0
    assert graphs.graph_tiles == graphs.tiles == 8
    # the fine pre-pass's 1-NN over the candidates, then one a tile
    assert len(seen["k1"]) == 5 and seen["k1"][1:] == [tile] * 4
    assert len(seen["fwd"]) == 8
    refs = [c for c, _ in seen["fwd"]]
    assert len({c.data_ptr() for c in refs[::2]}) == 4  # a tile's own
    for coords, then in seen["fwd"]:
        assert torch.equal(coords, then)
    monkeypatch.undo()
    _assert_equal(out, _render(s, view, tile))
    assert np.isfinite(out[0].cpu().numpy()).all()
