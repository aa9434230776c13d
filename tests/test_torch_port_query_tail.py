"""The global-compaction render's query tail with the view's pose
transforms built once (``render_rays_compact``), and the constants that
the query's ops make once a device (``utils/constants.py``), on a 64²
synthetic view (600 vertices, 16 samples a ray).  No JAX: the reference
is the port's own per-tile build.  The card-only test shows that a
fine-mode tile (its graphs' replay, or its query) does not
synchronise."""

import numpy as np
import pytest
import torch

from mpsnerf_torch.data import attach_body_grid, to_device_input
from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
from mpsnerf_torch.eval.runner import ViewRenderer, view_rays
from mpsnerf_torch.models.mps_nerf import MPSNeRF
from mpsnerf_torch.ops.composite import linspace01
from mpsnerf_torch.ops.grid_sample import (
    grid_sample_2d_patch,
    index_features_patch,
)
from mpsnerf_torch.ops.positional import positional_encoding
from mpsnerf_torch.renderer import render, tile_graphs
from mpsnerf_torch.smpl.lbs import PoseTransforms
from mpsnerf_torch.utils import constants
# by the test directory's own path: a machine with the card may have an
# installed package named ``tests`` that hides this one
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_SAMPLES = 16
VIEW = 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the stream's sync checks run there)")
    return torch.device("cuda")


def _scene(device):
    """A source and a target item of two poses, the model (seeded), the
    latent and the view's box-hit rays, on ``device``."""
    ds = SyntheticHumanDataset(n_poses=2, n_cameras=4, image_size=64,
                               n_verts=600, split="test")
    sp_item, tp_item = ds.get_item(0, instance_idx=0), \
        ds.get_item(1, instance_idx=0)
    attach_body_grid(tp_item)
    torch.manual_seed(0)
    model = MPSNeRF(num_instances=1).eval().to(device)
    sp, tp = to_device_input(sp_item, device), to_device_input(tp_item,
                                                               device)
    with torch.no_grad():
        latent = model.encode(sp["img_all"])
    rays, _, _ = view_rays(tp_item, VIEW, device,
                           tp_item["mask_at_box_all"][VIEW])
    return dict(ds=ds, sp_item=sp_item, tp_item=tp_item, model=model,
                smpl=ds.smpl_for(0, device), sp=sp, tp=tp, latent=latent,
                rays=rays)


@pytest.fixture(scope="module")
def scene():
    s = _scene("cpu")
    plan = render.plan_rays_compact(s["smpl"], s["tp"], *s["rays"],
                                    N_SAMPLES)
    s["count"] = int(plan.n_valid)
    fplan, _ = render.fine_rays_compact(s["smpl"], s["tp"], *s["rays"],
                                        N_SAMPLES, plan, s["count"])
    s["n_body"] = int(fplan.n_valid)
    assert s["n_body"] > 1000
    return s


def _round_up(n, m):
    return max(1, -(-n // m)) * m


def _tile_for(n_body, tiles):
    """A tile that splits ``n_body`` body points into ``tiles`` tiles."""
    tile = _round_up(-(-n_body // tiles), 8)
    assert _round_up(n_body, tile) // tile == tiles
    return tile


def _count_creates(monkeypatch):
    calls = []
    create = PoseTransforms.create

    def counted(smpl, params):
        calls.append(1)
        return create(smpl, params)

    monkeypatch.setattr(PoseTransforms, "create", staticmethod(counted))
    return calls


def _render(s, tile, tf_t=None):
    plan = render.plan_rays_compact(s["smpl"], s["tp"], *s["rays"],
                                    N_SAMPLES, tf_t=tf_t)
    cap = _round_up(s["count"], tile)
    fplan, fids = render.fine_rays_compact(s["smpl"], s["tp"], *s["rays"],
                                           N_SAMPLES, plan, cap, tf_t=tf_t)
    return render.render_rays_compact(
        s["model"], s["smpl"], s["sp"], s["tp"], s["latent"], *s["rays"],
        N_SAMPLES, capacity=cap, tile=tile,
        fine_capacity=_round_up(s["n_body"], tile), plan=plan,
        fine_plan=fplan, fine_ids=fids, tf_t=tf_t)


@pytest.mark.parametrize("tiles", [1, 2, 4])
def test_hoisted_transforms_equal_the_per_tile_build(scene, tiles,
                                                     monkeypatch):
    """The render with the view's transforms built once is equal, bit for
    bit, to the render whose every tile's query builds its own."""
    s, tile = scene, _tile_for(scene["n_body"], tiles)
    tf_t = PoseTransforms.create(s["smpl"], s["tp"]["params"])
    hoisted = _render(s, tile, tf_t)

    query = MPSNeRF.query

    def per_tile(self, *a, transforms=None, **k):
        return query(self, *a, **k)

    monkeypatch.setattr(MPSNeRF, "query", per_tile)
    calls = _count_creates(monkeypatch)
    built = _render(s, tile)
    # the plan, the fine pre-pass, the render's target and source, and two
    # a tile
    assert len(calls) == 4 + 2 * tiles
    assert int(hoisted[3]) == int(built[3]) == 0
    for a, b in zip(hoisted, built):
        assert torch.equal(a, b)
    assert hoisted[2].max() > 0.01  # the body is visible


@pytest.mark.parametrize("tiles", [1, 2, 4])
def test_a_served_view_builds_each_pose_once(scene, tiles, monkeypatch):
    """``ViewRenderer``'s global path builds the target's transforms once
    for the pre-passes and the render, and the source's once, whatever
    the number of tiles."""
    s = scene
    vr = ViewRenderer(s["model"], lambda gender: s["smpl"],
                      n_samples=N_SAMPLES, tile=_tile_for(s["n_body"], tiles),
                      device="cpu")
    calls = _count_creates(monkeypatch)
    vr.render_view(s["sp_item"], s["tp_item"], VIEW)
    assert vr.last_view.n_body == s["n_body"]
    assert vr.last_view.fine_capacity // vr.tile == tiles
    assert len(calls) == 2


def test_a_constant_made_in_inference_mode_serves_a_backward(monkeypatch):
    """The serving bundle runs in inference mode; a constant cached there
    is later saved for a train step's backward."""
    monkeypatch.setattr(constants, "_CACHE", {})
    g = torch.Generator().manual_seed(0)
    x = torch.rand(32, 3, generator=g)
    latent = torch.rand(2, 4, 8, 8, generator=g)
    uv = 64.0 * torch.rand(2, 32, 2, generator=g)
    with torch.inference_mode():
        positional_encoding(x, 4)
        index_features_patch(latent, uv, (64.0, 64.0))
    cached = dict(constants._CACHE)
    assert len(cached) == 2
    assert not any(t.is_inference() for t in cached.values())

    x.requires_grad_(True)
    uv.requires_grad_(True)
    loss = positional_encoding(x, 4).square().sum() + \
        index_features_patch(latent, uv, (64.0, 64.0)).square().sum()
    loss.backward()
    # the same tensors, no new build
    assert constants._CACHE.keys() == cached.keys()
    assert all(constants._CACHE[k] is t for k, t in cached.items())
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    assert torch.isfinite(uv.grad).all() and uv.grad.abs().sum() > 0


def test_constants_are_keyed_per_values_dtype_and_device(monkeypatch):
    monkeypatch.setattr(constants, "_CACHE", {})
    dc = constants.device_constant
    a = dc([1.0, 2.0], torch.float32, "cpu")
    assert dc((1.0, 2.0), torch.float32, torch.device("cpu")) is a
    assert dc([1.0, 3.0], torch.float32, "cpu") is not a
    f64 = dc([1.0, 2.0], torch.float64, "cpu")
    assert f64 is not a and f64.dtype == torch.float64
    meta = dc([1.0, 2.0], torch.float32, "meta")
    assert meta is not a and meta.device.type == "meta"
    idx = dc(np.arange(3), device="cpu")
    assert idx.dtype == torch.int64 and idx is not dc(np.arange(3.0))
    assert len(constants._CACHE) == 6
    # "cuda" and the current card's index name one device
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert constants.device_key("cuda") == constants.device_key("cuda:0") \
        == torch.device("cuda", 0)
    assert constants.device_key("cuda:1") == torch.device("cuda", 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cached_constants_keep_the_old_formulas_bits(dtype, monkeypatch):
    monkeypatch.setattr(constants, "_CACHE", {})
    g = torch.Generator().manual_seed(1)
    x = (10.0 * torch.rand(257, 3, generator=g) - 5.0).to(dtype)
    freqs = torch.as_tensor(np.pi * (2.0 ** np.arange(6)), dtype=dtype)
    xb = x[..., None, :] * freqs[:, None]
    old = torch.cat([x, torch.stack([torch.sin(xb), torch.cos(xb)],
                                    dim=-2).reshape(257, 36)], dim=-1)
    for _ in range(2):  # the build and the cached read
        assert torch.equal(positional_encoding(x, 6), old)

    latent = torch.rand(3, 5, 16, 16, generator=g).to(dtype)
    uv = (512.0 * torch.rand(3, 100, 2, generator=g) - 20.0).to(dtype)
    size = (512.0, 384.0)
    old = grid_sample_2d_patch(
        latent, 2.0 * uv / torch.as_tensor(size, dtype=dtype) - 1.0)
    for _ in range(2):
        assert torch.equal(index_features_patch(latent, uv, size), old)

    old = torch.cat([torch.arange(15, dtype=dtype)
                     * torch.tensor(1.0 / 15, dtype=dtype),
                     torch.ones(1, dtype=dtype)])
    for _ in range(2):
        assert torch.equal(linspace01(16, dtype), old)


@pytest.mark.card
def test_a_tile_query_does_not_synchronise(card, monkeypatch):
    """After a warm-up, every fine-mode tile with the view's transforms
    (the replay of its CUDA graphs, or an eager query) runs with the
    stream's sync checks raising: nothing in a tile waits on the card."""
    s = _scene(card)
    vr = ViewRenderer(s["model"], lambda gender: s["smpl"],
                      n_samples=N_SAMPLES, tile=512, device=card)
    vr.render_view(s["sp_item"], s["tp_item"], VIEW)  # warm-up, capture
    torch.cuda.synchronize()

    seen = []

    def checked(fn, hoisted):
        def call(self, *a, **k):
            seen.append(hoisted(self, k))
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(self, *a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    monkeypatch.setattr(MPSNeRF, "query", checked(
        MPSNeRF.query, lambda self, k: k.get("transforms") is not None))
    monkeypatch.setattr(tile_graphs._Captured, "run", checked(
        tile_graphs._Captured.run, lambda self, k: self.replays is not None))
    vr.render_view(s["sp_item"], s["tp_item"], VIEW)
    assert vr.last_view.fine_capacity // vr.tile == len(seen) >= 2
    assert all(seen)
