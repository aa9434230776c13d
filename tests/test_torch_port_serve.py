"""The port's serving bundle and HTTP server on the CPU (``--device
cpu``): the export -> load round trip; ``render_view`` and
``render_rays`` (with a ray mask) against the port's ``ViewRenderer`` and
``render_rays``; ``render_camera`` at a view's camera against that view;
``extract_mesh`` and ``animate`` against the direct geometry calls; every
HTTP route on port 0 (the actor roster, the 400s on a bad schema and on
``sharded=1``, the spiral as an AVI, the item cache's hits); the wire
format both ways against the JAX package's encoder and decoder; and the
checkpoint -> bundle CLI.

The scene: the synthetic subject at 32^2 (4 ring cameras, 500 vertices),
8 samples per ray, 512-ray chunks; the model ``factory.return_model`` of
``configs/synthetic_smoke.txt`` (flagship widths) with seeded weights
(density bias +4, so the body renders opaque).  Tolerances: pixels 1e-5
(one model, rebuilt from the bundle's weights; the same ops in the same
order), meshes and animation 1e-6.
"""

import io
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mpsnerf_tpu.serve import server as j_server

from mpsnerf_torch.config import parse_args
from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
from mpsnerf_torch.eval.runner import ViewRenderer, view_rays
from mpsnerf_torch.eval.video import read_avi_index
from mpsnerf_torch.factory import return_model
from mpsnerf_torch.geometry import (
    GridSpec, MeshAnimationRenderer, extract_density_mesh,
)
from mpsnerf_torch.renderer.render import render_rays
from mpsnerf_torch.serve import export as t_export
from mpsnerf_torch.serve import (
    ServedRenderer, export_serving_bundle, load_serving_bundle,
)
from mpsnerf_torch.serve import server as t_server
from mpsnerf_torch.train.checkpoint import save_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "synthetic_smoke.txt")
CHUNK, N_SAMPLES, TILE, MESH_CHUNK = 512, 8, 4096, 4096
VIEW = 1


def _seeded_model(args):
    torch.manual_seed(0)
    model = return_model(args)
    with torch.no_grad():
        model.alpha_linear.bias.fill_(4.0)
    return model.eval()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    args = parse_args(["--config", CONFIG])
    ds = SyntheticHumanDataset(n_poses=2, n_cameras=4, image_size=32,
                               n_rays=32, n_verts=500, split="test")
    items = [ds.get_item(i, instance_idx=0) for i in range(2)]
    smpl = ds.smpl_for(0, device="cpu")
    model = _seeded_model(args)
    out = str(tmp_path_factory.mktemp("bundle"))
    export_serving_bundle(out, args, model, {int(items[0]["gender"]): smpl},
                          dict(items[0]), dict(items[0]), chunk=CHUNK,
                          n_samples=N_SAMPLES, tile=TILE,
                          mesh_chunk=MESH_CHUNK)
    return dict(args=args, ds=ds, items=items, smpl=smpl, model=model,
                dir=out, served=load_serving_bundle(out, device="cpu"))


def _fresh(item):
    return {k: v for k, v in item.items()
            if not k.startswith("_") and k != "body_grid"}


def _live(s, **kw):
    return ViewRenderer(s["model"], lambda g: s["smpl"], chunk=CHUNK,
                        n_samples=N_SAMPLES, tile=TILE, device="cpu",
                        eval_compact_fraction=None, shuffle_rays=False, **kw)


def test_bundle_round_trip(setup, tmp_path):
    """The files, the manifest's factory config and flags, the weights and
    the rig as exported; a config that builds another model is refused."""
    s = setup
    assert sorted(os.listdir(s["dir"])) == [
        "manifest.json", "smpl.npz", "warmup.npz", "weights.npz"]
    m = s["served"].manifest
    assert m["factory_args"]["model"] == "skinning_batch"
    assert (m["has_global"], m["has_mesh"], m["has_anim"]) == (True,) * 3
    assert m["image_shape"] == [3, 3, 32, 32]
    assert m["attachments"] == {"tp": ["body_grid"], "sp": []}
    assert "vertices" in m["tp_schema"] and "ray_o_all" not in m["tp_schema"]
    got = s["served"].model.state_dict()
    for k, v in s["model"].state_dict().items():
        assert torch.equal(got[k], v), k
    rig = s["served"]._smpl[int(s["items"][0]["gender"])]
    for f in ("v_template", "weights", "faces", "posedirs"):
        assert torch.equal(getattr(rig, f), getattr(s["smpl"], f)), f
    assert rig.parents == s["smpl"].parents
    args = parse_args(["--config", CONFIG, "--use_trans", "0"])
    with pytest.raises(RuntimeError):
        export_serving_bundle(str(tmp_path / "bad"), args, s["model"],
                              {2: s["smpl"]}, s["items"][0], s["items"][0])
    with open(os.path.join(s["dir"], "manifest.json")) as f:
        manifest = json.load(f)
    manifest["format"] = "jax"
    bad = tmp_path / "jax_bundle"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="not a bundle of the port"):
        ServedRenderer(str(bad), device="cpu")


@pytest.mark.parametrize("use_global", [True, False])
def test_render_view_matches_view_renderer(setup, use_global):
    """A novel pose (source item 0, target item 1): ``render_view`` on
    each path equals ``ViewRenderer.render_view`` on it."""
    s = setup
    a = s["served"].render_view(_fresh(s["items"][0]), _fresh(s["items"][1]),
                                VIEW, use_global=use_global)
    b = _live(s, global_compact=use_global).render_view(
        _fresh(s["items"][0]), _fresh(s["items"][1]), VIEW)
    assert a.shape == (32 * 32, 3) and (a > 0.05).any()
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_render_rays_and_ray_mask(setup):
    """An explicit ray mask renders its rays and fills the rest with 0, as
    ``ViewRenderer``; ``render_rays`` on the chunked path equals the
    port's ``render_rays`` of the same rays (uncompacted, exact)."""
    s = setup
    it = s["items"][0]
    mask = np.asarray(it["mask_at_box_all"][VIEW]).reshape(-1)
    a = s["served"].render_view(_fresh(it), _fresh(it), VIEW, ray_mask=mask)
    b = _live(s).render_view(_fresh(it), _fresh(it), VIEW, ray_mask=mask)
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert (a[~mask] == 0).all()

    rays, _, _ = view_rays(it, VIEW, "cpu", mask)
    got = s["served"].render_rays(_fresh(it), _fresh(it),
                                  *[x.numpy() for x in rays],
                                  use_global=False)
    live = _live(s, global_compact=False)
    smpl, sp, tp, latent = live.device_items(_fresh(it), _fresh(it))
    with torch.no_grad():
        want = render_rays(s["model"].with_compact_fraction(None), smpl, sp,
                           tp, latent, *rays, N_SAMPLES, perturb=0.0,
                           train=False).rgb_map.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, a[mask], atol=1e-5)


def test_render_camera_equals_view(setup):
    """The camera K, R, T of a view (the data set's, in float64, from
    which it made the view's rays) through ``render_camera`` gives that
    view."""
    s = setup
    it = s["items"][0]
    cam = s["served"].render_camera(_fresh(it), _fresh(it),
                                    *s["ds"].cameras[VIEW], 32, 32)
    view = s["served"].render_view(_fresh(it), _fresh(it), VIEW)
    np.testing.assert_allclose(cam, view, atol=1e-5)


def test_extract_mesh_and_animate_match_direct(setup):
    """``extract_mesh`` (target and canonical) equals
    ``extract_density_mesh`` with the uncompacted model; ``animate`` (fast
    and full) equals ``MeshAnimationRenderer`` on that canonical mesh."""
    s = setup
    it = s["items"][0]
    model = s["model"].with_compact_fraction(None)
    live = _live(s)
    smpl, sp, tp, latent = live.device_items(_fresh(it), _fresh(it))
    meshes = {}
    for canonical in (False, True):
        verts = np.asarray(it["t_vertices" if canonical else "vertices"])
        mode = "extract_mesh" if canonical else "full"
        with torch.no_grad():
            want = extract_density_mesh(
                lambda p: model.query(smpl, sp, tp, latent, p,
                                      torch.zeros_like(p), mode=mode).sigma,
                GridSpec.from_vertices(verts, n=16), verts, smpl.faces,
                chunk=MESH_CHUNK, device="cpu")
        got = s["served"].extract_mesh(_fresh(it), _fresh(it), n=16,
                                       canonical=canonical)
        assert len(got[0]) > 50 and got[0].dtype == np.float32
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
        meshes[canonical] = got
    can_verts, tris = meshes[True]
    direct = MeshAnimationRenderer(s["model"], smpl, can_verts, tris,
                                   chunk=MESH_CHUNK, device="cpu")
    direct.bake(_fresh(it))
    for fast in (True, False):
        got = s["served"].animate(_fresh(it), _fresh(s["items"][1]), VIEW,
                                  32, 32, can_verts=can_verts, tris=tris,
                                  fast=fast)
        want = direct.render_pose(_fresh(s["items"][1]), VIEW, 32, 32,
                                  fast=fast)
        assert (got.sum(-1) > 0).sum() > 20 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_item_cache_is_bounded(setup, monkeypatch):
    """``MPSNERF_SERVE_ITEM_CACHE`` entries, least recently used out: with
    2, a third item evicts the oldest, whose next request misses; the
    pixels do not depend on hits.  An entry keeps the renderer's derived
    state (the source's device tensors and latent)."""
    monkeypatch.setenv("MPSNERF_SERVE_ITEM_CACHE", "2")
    served = load_serving_bundle(setup["dir"], device="cpu")
    it0, it1 = setup["items"]
    first = served.render_view(_fresh(it0), _fresh(it0), VIEW)
    assert served.n_cache_hits == 0 and len(served._cache) == 2
    sp_entry = next(iter(served._cache.values()))
    assert set(ViewRenderer.DERIVED_KEYS) <= set(sp_entry)
    served.render_view(_fresh(it0), _fresh(it1), VIEW)  # sp hits, tp new
    assert served.n_cache_hits == 1 and len(served._cache) == 2
    again = served.render_view(_fresh(it0), _fresh(it0), VIEW)
    assert served.n_cache_hits == 2  # sp hit; tp of item 0 was evicted
    np.testing.assert_array_equal(first, again)


def test_wire_format_both_ways(setup):
    """JAX's encoder read by the port's decoder, and the reverse: the same
    items, ray mask, camera and mesh."""
    it = setup["items"][0]
    mask = np.asarray(it["mask_at_box_all"][0]).reshape(-1)
    cam = {"K": it["K_all"][0], "R": it["R_all"][0], "T": it["T_all"][0]}
    mesh = {"verts": np.ones((4, 3), np.float32),
            "tris": np.zeros((2, 3), np.int32)}
    for enc, dec in ((j_server.items_to_npz_bytes,
                      t_server.npz_bytes_to_items),
                     (t_server.items_to_npz_bytes,
                      j_server.npz_bytes_to_items)):
        sp, tp, m, c, me = dec(enc(it, setup["items"][1], mask, cam, mesh))
        for got, want in ((sp, it), (tp, setup["items"][1])):
            assert sorted(got) == sorted(k for k in want
                                         if not k.startswith("_"))
            np.testing.assert_array_equal(got["img_all"], want["img_all"])
            for k, v in want["params"].items():
                np.testing.assert_array_equal(got["params"][k], v)
        np.testing.assert_array_equal(m, mask)
        assert sorted(c) == ["K", "R", "T"] and sorted(me) == ["tris",
                                                                "verts"]
        np.testing.assert_array_equal(c["R"], cam["R"])
    with pytest.raises(ValueError, match="bad request key"):
        buf = io.BytesIO()
        np.savez(buf, nope=np.zeros(1))
        t_server.npz_bytes_to_items(buf.getvalue())


def _post(url, body):
    with urllib.request.urlopen(urllib.request.Request(url, data=body)) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _get(url):
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def _status(fn, *a):
    try:
        fn(*a)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    return 200, None


def test_http_routes(setup, tmp_path):
    """Every route of a warmed single-bundle server and of a two-actor
    roster, on port 0; the refusals; the item cache's hits."""
    s = setup
    it0, it1 = s["items"]
    srv = t_server.BundleServer(s["dir"], port=0, warmup=True,
                                device="cpu").start()
    roster = t_server.BundleServer({"a": s["served"], "b": s["dir"]}, port=0,
                                   device="cpu").start()
    try:
        url = "http://%s:%d" % srv.address
        health = _get(url + "/healthz")
        assert health["status"] == "ok" and health["backend"] == "cpu"
        assert health["model_class"] == "MPSNeRF" and health["has_global"]
        assert _get(url + "/manifest")["format"] == "mpsnerf_torch"
        assert _get(url + "/actors") == {"default": "MPSNeRF"}
        body = t_server.items_to_npz_bytes(it0, it1)
        want = s["served"].render_view(_fresh(it0), _fresh(it1), VIEW)
        for q in ("", "&global=0"):
            code, ctype, data = _post(f"{url}/render?view={VIEW}{q}", body)
            assert code == 200 and ctype == "application/octet-stream"
            np.testing.assert_allclose(np.load(io.BytesIO(data)), want,
                                       atol=1e-5)
        hits = _get(url + "/healthz")["item_cache_hits"]
        _post(f"{url}/render?view={VIEW}", body)
        assert _get(url + "/healthz")["item_cache_hits"] == hits + 2

        cam_body = t_server.items_to_npz_bytes(
            it0, it1, camera=dict(zip("KRT", s["ds"].cameras[VIEW])))
        _, _, data = _post(url + "/camera?h=32&w=32", cam_body)
        np.testing.assert_allclose(np.load(io.BytesIO(data)), want,
                                   atol=1e-5)

        _, _, data = _post(url + "/spiral?frames=2&h=16&w=16", body)
        frames = np.load(io.BytesIO(data))
        assert frames.shape == (2, 16, 16, 3) and np.isfinite(frames).all()
        _, ctype, data = _post(
            url + "/spiral?frames=3&h=16&w=24&format=video&fps=2", body)
        assert ctype == "video/x-msvideo"
        (tmp_path / "s.avi").write_bytes(data)
        _, w, h, total, sizes = read_avi_index(str(tmp_path / "s.avi"))
        assert (w, h, total, len(sizes)) == (24, 16, 3, 3)

        _, _, data = _post(url + "/mesh?n=16", body)
        with np.load(io.BytesIO(data)) as z:
            verts, tris = z["verts"], z["tris"]
        want_v, want_t = s["served"].extract_mesh(_fresh(it0), _fresh(it1),
                                                  n=16)
        np.testing.assert_allclose(verts, want_v, atol=1e-6)
        np.testing.assert_array_equal(tris, want_t)
        can = s["served"].extract_mesh(_fresh(it0), _fresh(it1), n=16,
                                       canonical=True)
        mesh_body = t_server.items_to_npz_bytes(
            it0, it1, mesh={"verts": can[0], "tris": can[1]})
        for q, b in (("&fast=1", mesh_body), ("&n=16", body)):
            _, _, data = _post(f"{url}/animate?view={VIEW}&h=32&w=32{q}", b)
            img = np.load(io.BytesIO(data))
            assert img.shape == (32, 32, 3) and (img.sum(-1) > 0).any()

        bad = {k: v for k, v in it1.items() if k != "vertices"}
        code, err = _status(_post, f"{url}/render?view=1",
                            t_server.items_to_npz_bytes(it0, bad))
        assert code == 400 and "missing keys" in err and "vertices" in err
        code, err = _status(_post, f"{url}/render?view=1&sharded=1", body)
        assert code == 400 and "shard_devices" in err
        assert _status(_post, url + "/nope", b"")[0] == 404
        assert _status(_get, url + "/nope")[0] == 404

        rurl = "http://%s:%d" % roster.address
        assert _get(rurl + "/actors") == {"a": "MPSNeRF", "b": "MPSNeRF"}
        assert sorted(_get(rurl + "/healthz")["actors"]) == ["a", "b"]
        assert _get(rurl + "/actors/b/manifest")["chunk"] == CHUNK
        _, _, data = _post(f"{rurl}/actors/a/render?view={VIEW}", body)
        np.testing.assert_allclose(np.load(io.BytesIO(data)), want,
                                   atol=1e-5)
        code, err = _status(_post, f"{rurl}/render?view=1", body)
        assert code == 404 and "multi-actor" in err
        assert _status(_get, rurl + "/actors/c/manifest")[0] == 404
    finally:
        srv.stop()
        roster.stop()


def test_export_cli_from_a_checkpoint(setup, tmp_path):
    """``python -m mpsnerf_torch.serve.export`` on a port checkpoint: the
    bundle holds the checkpoint's weights; ``--shard_devices 2`` exports a
    sharded bundle (blocks of 2 x 4096 rays); ``--export_platforms`` and a
    missing checkpoint are refused."""
    s = setup
    base = str(tmp_path / "logs")
    argv = ["--config", CONFIG, "--basedir", base, "--image_scaling",
            "0.0625", "--serve_chunk", str(CHUNK), "--serve_mesh_chunk",
            str(MESH_CHUNK)]
    with pytest.raises(SystemExit, match="no checkpoint"):
        t_export.main(argv)
    save_checkpoint(base, "synthetic_smoke", 7,
                    {"step": 7, "model": s["model"].state_dict(),
                     "optimizer": {}})
    out = t_export.main(argv + ["--bundle_dir", str(tmp_path / "b")])
    served = load_serving_bundle(out, device="cpu")
    for k, v in s["model"].state_dict().items():
        assert torch.equal(served.model.state_dict()[k], v), k
    m = served.manifest
    assert (m["chunk"], m["n_samples"], m["mesh_chunk"]) == (
        CHUNK, s["args"].N_samples, MESH_CHUNK)
    assert m["image_shape"] == [3, 3, 32, 32]
    assert (m["shard_devices"], m["shard_rays"]) == (0, 0)
    out = t_export.main(argv + ["--bundle_dir", str(tmp_path / "sharded"),
                                "--shard_devices", "2"])
    m = load_serving_bundle(out, device="cpu").manifest
    assert (m["shard_devices"], m["shard_rays"], m["ray_axis"]) == (
        2, 8192, "ray")
    with pytest.raises(SystemExit, match="--export_platforms"):
        t_export.main(argv + ["--export_platforms", "tpu"])
