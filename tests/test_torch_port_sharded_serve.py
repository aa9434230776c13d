"""The sharded render of a port bundle (``mpsnerf_torch/serve/sharded.py``)
on 2 CPU gloo ranks: a bundle exported with ``shard_devices`` 2 renders
``sharded=True`` views equal to the JAX package's sharded bundle of the
same weights (its ray-sharded graph on 2 of the 8 virtual CPU devices),
and views (with and without a ray mask), cameras and rays equal to its
own unsharded render; the manifest's shard fields as JAX's exporter
writes them; ``sharded=1`` over ``BundleServer``; a block forced to
overflow its compaction renders again (equal pixels, a raised
``n_overflow_chunks``: JAX drops those samples, so this one is held to
the unsharded render); a killed rank fails its request with a 500 and
the next request starts fresh ranks; stopping the server, or ``close()``,
leaves no rank alive.

The scene is ``tests/test_torch_port_serve.py``'s (the synthetic subject
at 32^2, 500 vertices, 8 samples, the flagship widths of
``configs/synthetic_smoke.txt``: a bundle is built by the factory), with
blocks of 2 x 256 rays, so a view takes several blocks.  The weights are
seeded random arrays in the JAX tree's shapes
(``tests/test_torch_port_variants.py:random_variables``, the density
bias +4), crossed over through ``from_jax``.  The ranks start on a thread
(one torch thread each, through ``OMP_NUM_THREADS``) while the JAX
bundle and the unsharded references render.  Tolerance: 1e-5.
"""

import io
import json
import os
import signal
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu import factory as j_factory
from mpsnerf_tpu.config import parse_args as j_parse_args
from mpsnerf_tpu.data.synthetic import SyntheticHumanDataset as JDataset
from mpsnerf_tpu.serve import export_serving_bundle as j_export
from mpsnerf_tpu.serve import load_serving_bundle as j_load
from mpsnerf_tpu.serve import server as j_server
from mpsnerf_tpu.train.trainer import to_device_input as j_device_input

from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.config import parse_args
from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
from mpsnerf_torch.eval.runner import view_rays
from mpsnerf_torch.factory import return_model
from mpsnerf_torch.serve import export_serving_bundle, load_serving_bundle
from mpsnerf_torch.serve import server as t_server
from tests.test_torch_port_variants import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "synthetic_smoke.txt")
CHUNK, N_SAMPLES, TILE, PER_DEVICE, RANKS = 512, 8, 4096, 256, 2
VIEW = 1


def _model(args):
    torch.manual_seed(0)
    model = return_model(args)
    with torch.no_grad():
        model.alpha_linear.bias.fill_(4.0)
    return model.eval()


def _jax_model(args, items):
    """The JAX factory's model of ``args`` and seeded variables in its
    tree's shapes (the density bias +4, so the body renders opaque)."""
    model = j_factory.return_model(j_parse_args(["--config", CONFIG]))
    smpl = items["smpl"]
    inp = j_device_input(items["items"][0])
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, smpl, inp, inp, jnp.zeros((8, 3)), jnp.ones((8, 3)),
        train=False), jax.random.PRNGKey(0))

    def bias(path, x):
        names = [getattr(p, "key", "") for p in path]
        return np.full_like(x, 4.0) if names[-2:] == [
            "alpha_linear", "bias"] else x

    return model, jax.tree_util.tree_map_with_path(
        bias, random_variables(shapes))


def _export(out, args, ds, items, model=None, **kw):
    kw.setdefault("shard_rays_per_device", PER_DEVICE)
    kw.setdefault("n_samples", N_SAMPLES)
    export_serving_bundle(
        out, args, model or _model(args), {int(items[0]["gender"]):
                                           ds.smpl_for(0, device="cpu")},
        dict(items[0]), dict(items[0]), chunk=CHUNK, tile=TILE,
        mesh_chunk=0, **kw)
    return load_serving_bundle(out, device="cpu")


def _fresh(item):
    return {k: v for k, v in item.items()
            if not k.startswith("_") and k != "body_grid"}


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    args = parse_args(["--config", CONFIG])
    scene = dict(n_poses=2, n_cameras=4, image_size=32, n_rays=32,
                 n_verts=500, split="test")
    ds = SyntheticHumanDataset(**scene)
    items = [ds.get_item(i, instance_idx=0) for i in range(2)]
    j_ds = JDataset(num_instances=1, **scene)
    j_items = [j_ds.get_item(i, instance_idx=0) for i in range(2)]
    j_smpl = j_ds.smpl_for(0)
    j_model, variables = _jax_model(args, dict(items=j_items, smpl=j_smpl))
    model = _model(args)
    model.load_state_dict(from_jax(variables), strict=True)
    out = tmp_path_factory.mktemp("sharded")
    served = _export(str(out / "port"), args, ds, items, model=model,
                     shard_devices=RANKS)
    # the ranks start (and load the bundle) while the references render
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        starting = threading.Thread(target=served.on_ranks,
                                    args=(os.getpid,))
        starting.start()
    # JAX's sharded bundle of the same weights (its graph over 2 devices)
    j_export(str(out / "jax"), j_model, variables,
             {int(j_items[0]["gender"]): j_smpl}, dict(j_items[0]),
             dict(j_items[0]), chunk=CHUNK, n_samples=N_SAMPLES,
             shard_devices=RANKS, shard_rays_per_device=PER_DEVICE,
             global_compact=False, mesh_chunk=0)
    j_view = np.asarray(j_load(str(out / "jax")).render_view(
        dict(j_items[0]), dict(j_items[1]), VIEW, sharded=True))
    it0, it1 = items
    mask = np.asarray(it1["mask_at_box_all"][VIEW]).reshape(-1).copy()
    mask[::3] = False
    rays, _, _ = view_rays(it1, VIEW, "cpu")
    refs = {
        "jax_sharded": j_view,
        "view": served.render_view(_fresh(it0), _fresh(it1), VIEW),
        "masked": served.render_view(_fresh(it0), _fresh(it1), VIEW, mask),
        "camera": served.render_camera(_fresh(it0), _fresh(it1),
                                       *ds.cameras[VIEW], 32, 32),
        "rays": served.render_rays(_fresh(it0), _fresh(it1),
                                   *[x.numpy() for x in rays],
                                   use_global=False),
    }
    starting.join()
    yield dict(args=args, ds=ds, items=items, served=served, refs=refs,
               mask=mask, rays=rays)
    served.close()


def test_manifest_records_the_shards(setup, tmp_path):
    """JAX's manifest fields: ``shard_devices``, ``shard_rays`` (the
    block: devices x rays a device) and ``ray_axis``; a bundle exported
    without shards records 0 and refuses a sharded request; a rank's shard
    must be at most one chunk or whole chunks."""
    m = setup["served"].manifest
    assert (m["shard_devices"], m["shard_rays"], m["ray_axis"]) == (
        RANKS, RANKS * PER_DEVICE, "ray")
    s = setup
    plain = _export(str(tmp_path / "plain"), s["args"], s["ds"], s["items"])
    assert (plain.manifest["shard_devices"], plain.manifest["shard_rays"]) \
        == (0, 0)
    it = _fresh(s["items"][0])
    with pytest.raises(ValueError, match="exported without shard_devices"):
        plain.render_view(it, dict(it), VIEW, sharded=True)
    with pytest.raises(ValueError, match="whole chunks"):
        _export(str(tmp_path / "bad"), s["args"], s["ds"], s["items"],
                shard_devices=2, shard_rays_per_device=CHUNK + 1)


def test_sharded_view_matches_jax_sharded_bundle(setup):
    """The port's ``render_view(sharded=True)`` equals JAX's sharded
    bundle of the same weights on the same view (no block overflows, so
    the two must agree: JAX drops an overflow's samples)."""
    s = setup
    it0, it1 = s["items"]
    got = s["served"].render_view(_fresh(it0), _fresh(it1), VIEW,
                                  sharded=True)
    assert s["served"].shard_ranks.last["n_dropped"] == [0] * RANKS
    want = s["refs"]["jax_sharded"]
    assert want.shape == got.shape == (32 * 32, 3) and (want > 0.05).any()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_sharded_view_matches_unsharded(setup, masked):
    """``render_view(sharded=True)`` (the body box's rays, or an explicit
    mask's, the rest 0) equals the bundle's unsharded render; the view
    takes several blocks, the last padded with far rays."""
    s = setup
    it0, it1 = s["items"]
    mask = s["mask"] if masked else None
    got = s["served"].render_view(_fresh(it0), _fresh(it1), VIEW, mask,
                                  sharded=True)
    want = s["refs"]["masked" if masked else "view"]
    assert got.shape == (32 * 32, 3) and (got > 0.05).any()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if masked:
        assert (got[~s["mask"]] == 0).all()
    last = s["served"].shard_ranks.last
    assert last["blocks"] >= 1 and last["n_dropped"] == [0] * RANKS


def test_sharded_camera_and_rays_match_unsharded(setup):
    """``render_camera`` and ``render_rays`` (every ray of the view: 2
    blocks) on the ranks equal their unsharded renders."""
    s = setup
    it0, it1 = s["items"]
    cam = s["served"].render_camera(_fresh(it0), _fresh(it1),
                                    *s["ds"].cameras[VIEW], 32, 32,
                                    sharded=True)
    np.testing.assert_allclose(cam, s["refs"]["camera"], atol=1e-5)
    got = s["served"].render_rays(_fresh(it0), _fresh(it1),
                                  *[x.numpy() for x in s["rays"]],
                                  sharded=True)
    assert s["served"].shard_ranks.last["blocks"] == 2
    np.testing.assert_allclose(got, s["refs"]["rays"], atol=1e-5)


def test_items_cross_once_per_content_key(setup):
    """The ranks keep an item's arrays and the source's latent per content
    key: a repeated pair sends nothing, a new target only the target."""
    s = setup
    it0, it1 = s["items"]
    served = s["served"]
    served.render_view(_fresh(it0), _fresh(it1), VIEW, sharded=True)
    assert served.shard_ranks.last["sent"] == []
    served.render_view(_fresh(it0), _fresh(it0), VIEW, sharded=True)
    assert served.shard_ranks.last["sent"] == ["tp"]


def test_shared_device_blocks_run_under_the_device_lock(setup):
    """Ranks that share the serving device (CPU ranks share this host)
    render their blocks under the device lock that single-flights the
    unsharded work, so the two never fill one device together."""
    s = setup
    it0, it1 = s["items"]
    served = s["served"]
    assert served._ranks_share_device()
    ranks, held = served.shard_ranks, []
    render = ranks.render
    ranks.render = lambda *a: (held.append(served._lock.locked()),
                               render(*a))[1]
    try:
        served.render_view(_fresh(it0), _fresh(it1), VIEW, sharded=True)
    finally:
        del ranks.render
    assert held == [True] and not served._lock.locked()


def _post(url, body):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                    timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_sharded_over_http_and_a_killed_rank(setup):
    """``sharded=1`` on /render and /camera over ``BundleServer`` (the JAX
    package's encoder writes the body) equals the unsharded render;
    /healthz and /manifest show ``shard_devices``.  A killed rank fails
    the next sharded request with a 500, never an image; the request
    after it starts fresh ranks.  ``stop()`` leaves no rank alive."""
    s = setup
    it0, it1 = s["items"]
    served = s["served"]
    srv = t_server.BundleServer(served, port=0, device="cpu").start()
    try:
        url = "http://%s:%d" % srv.address
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["shard_devices"] == RANKS
        assert health["shard_ranks_alive"]
        with urllib.request.urlopen(url + "/manifest", timeout=30) as r:
            assert json.loads(r.read())["shard_rays"] == RANKS * PER_DEVICE
        body = j_server.items_to_npz_bytes(it0, it1)
        code, data = _post(f"{url}/render?view={VIEW}&sharded=1", body)
        assert code == 200
        np.testing.assert_allclose(np.load(io.BytesIO(data)),
                                   s["refs"]["view"], atol=1e-5)
        cam = j_server.items_to_npz_bytes(
            it0, it1, camera=dict(zip("KRT", s["ds"].cameras[VIEW])))
        code, data = _post(f"{url}/camera?h=32&w=32&sharded=1", cam)
        assert code == 200
        np.testing.assert_allclose(np.load(io.BytesIO(data)),
                                   s["refs"]["camera"], atol=1e-5)

        old = served.shard_ranks.pids
        os.kill(old[1], signal.SIGKILL)
        code, data = _post(f"{url}/render?view={VIEW}&sharded=1", body)
        assert code == 500 and b"rank 1" in data
        assert all(_gone(p) for p in old)
        code, data = _post(f"{url}/render?view={VIEW}&sharded=1", body)
        assert code == 200
        np.testing.assert_allclose(np.load(io.BytesIO(data)),
                                   s["refs"]["view"], atol=1e-5)
        pids = served.shard_ranks.pids
        assert set(pids).isdisjoint(old)
    finally:
        srv.stop()
    assert served.shard_ranks is None and all(_gone(p) for p in pids)


def test_overflow_block_renders_again(setup, tmp_path):
    """A model whose compaction keeps its floor of 1024 of a shard's
    16,384 samples (64 a ray): a block drops samples, renders again
    uncompacted on the same ranks and counts as an overflow chunk; the
    pixels equal the unsharded render's.  ``close()`` leaves no rank
    alive."""
    s = setup
    args = parse_args(["--config", CONFIG, "--compact_fraction", "0.01"])
    served = _export(str(tmp_path / "tiny"), args, s["ds"], s["items"],
                     shard_devices=RANKS, n_samples=64)
    it0, it1 = s["items"]
    want = served.render_view(_fresh(it0), _fresh(it1), VIEW)
    before = served.n_overflow_chunks
    try:
        got = served.render_view(_fresh(it0), _fresh(it1), VIEW,
                                 sharded=True)
        last = served.shard_ranks.last
        pids = served.shard_ranks.pids
    finally:
        served.close()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert last["blocks"] >= last["overflow_blocks"] >= 1
    assert sum(last["n_dropped"]) > 0
    assert served.n_overflow_chunks >= before + last["blocks"]
    assert all(_gone(p) for p in pids)
