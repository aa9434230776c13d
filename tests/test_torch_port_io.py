"""Parity of the PyTorch port's host data path with OpenCV and with the JAX
package, on the CPU: ``mpsnerf_torch/data/imageio.py`` against ``cv2``,
the THuman and H36M loaders' items against the JAX loaders' from one seed,
and the factory, ``MetricWriter``, ``PrefetchLoader`` and
``load_smpl_models`` against their JAX counterparts.

Tolerances, measured with OpenCV 5.0.0 and Pillow 12.1.0:
``undistort`` equals ``cv2.undistort`` bit for bit (the map's 1/32-pixel
fixed point and the remap's weight table are transcribed), on float32,
float64 and uint8 images; ``INTER_AREA`` downscales are within 1.2e-7 of
OpenCV's float32 (the sums run in float64, then round), upscales and
``INTER_NEAREST`` exact; erode, dilate and PNG decoding exact; JPEG through
PIL equal to ``cv2.imread`` on the fixtures' files (0 levels apart);
Rodrigues to 1e-6.  Items: images, masks and the sampled colours within
``ITEM_ATOL`` = 1e-6 (the area downscale's rounding), every other key
exact.
"""

import json
import os
import shutil
import sys
import warnings
import zlib

import cv2
import numpy as np
import pytest

from mpsnerf_tpu import factory as j_factory
from mpsnerf_tpu.data import h36m as j_h36m
from mpsnerf_tpu.data import thuman as j_thuman
from mpsnerf_tpu.data.prefetch import PrefetchLoader as JPrefetchLoader
from mpsnerf_tpu.smpl.assets import load_smpl_models as j_load_smpl_models
from mpsnerf_tpu.train.metrics import MetricWriter as JMetricWriter

from mpsnerf_torch import config as t_config
from mpsnerf_torch import factory as t_factory
from mpsnerf_torch.data import h36m as t_h36m
from mpsnerf_torch.data import imageio
from mpsnerf_torch.data import thuman as t_thuman
from mpsnerf_torch.data.prefetch import PrefetchLoader as TPrefetchLoader
from mpsnerf_torch.smpl.assets import load_smpl_models as t_load_smpl_models
from mpsnerf_torch.train.metrics import MetricWriter as TMetricWriter

from tests.test_h36m_loader import h36m_root  # noqa: F401 (fixture)
from tests.thuman_fixture import build_thuman_subject
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ITEM_ATOL = 1e-6
TOLERANCED = {"img_all", "o_img_all", "msk_all", "rgb_all"}
# distortion at THuman/H36M magnitudes (k1, k2, p1, p2, k3)
D_CAMS = [np.array([-0.21, 0.11, 0.0012, -0.0009, -0.02]),
          np.array([0.08, -0.15, -0.0015, 0.0011, 0.05])]
H = 64


def _distort(root, scale=1.0):
    """Give the fixture's cameras a non-zero distortion (its copy of
    ``annots.npy`` in the test's directory)."""
    path = os.path.join(root, "annots.npy")
    annots = np.load(path, allow_pickle=True).item()
    annots["cams"]["D"] = [D_CAMS[i % 2] * scale
                           for i in range(len(annots["cams"]["D"]))]
    np.save(path, annots)
    return root


# ---- imageio against cv2 --------------------------------------------------

def _png_rows(img, kinds):
    """PNG bytes of ``img`` with row ``y`` filtered by ``kinds[y % 5]``
    (each of the five filters), through the reference formulas."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        cur, kind = rows[y], kinds[y % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prev
        elif kind == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            f = cur - np.where((pa <= pb) & (pa <= pc), left,
                               np.where(pb <= pc, prev, ul))
        out.append(np.concatenate([[kind], f % 256]))
        prev = cur
    raw = np.stack(out).astype(np.uint8).tobytes()
    color = {1: 0, 3: 2, 4: 6}[bpp]

    def chunk(kind, data):
        return (len(data).to_bytes(4, "big") + kind + data
                + (zlib.crc32(kind + data) & 0xFFFFFFFF).to_bytes(4, "big"))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", w.to_bytes(4, "big") + h.to_bytes(4, "big")
                    + bytes([8, color, 0, 0, 0]))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (37, 53, 4)])
def test_imread_png_equals_cv2(shape, tmp_path):
    """Grey, RGB and RGBA: bit-equal to ``cv2.imread(IMREAD_UNCHANGED)``
    then the loaders' ``[..., ::-1]``, on cv2's own files and on files
    whose rows cycle through all five PNG filters."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[:shape[0], :shape[1]]
    smooth = (np.sin(x / 5.0) * 60 + y * 2 + 40).astype(np.uint8)
    planes = [smooth, smooth[::-1], smooth // 2,
              rng.integers(0, 256, shape[:2]).astype(np.uint8)]
    img = planes[0] if len(shape) == 2 else np.stack(planes[:shape[2]], -1)
    for name, write in (("cv2", lambda p: cv2.imwrite(p, img)),
                        ("filters", None)):
        path = str(tmp_path / f"{name}.png")
        if write is not None:
            write(path)
        else:
            # the file's channels are RGB(A); cv2 reads them as BGR(A)
            order = [2, 1, 0, 3][:shape[2]] if len(shape) == 3 else None
            data = img if order is None else img[..., order]
            with open(path, "wb") as f:
                f.write(_png_rows(data, [0, 1, 2, 3, 4]))
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if want.ndim == 3:
            want = want[..., ::-1]
        got = imageio.imread(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_imread_jpeg_equals_cv2_on_the_fixtures(tmp_path):
    """JPEG through PIL: the fixtures' JPEGs (written by cv2) decode to
    the pixels ``cv2.imread`` gives (0 levels apart, measured)."""
    root = build_thuman_subject(tmp_path / "s", n_poses=1, n_views=2, hw=H,
                                n_verts=50, seed=0)
    for v in range(2):
        path = os.path.join(root, f"{v:02d}", "0.jpg")
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
        np.testing.assert_array_equal(imageio.imread(path), want)
    with pytest.raises(FileNotFoundError):
        imageio.imread(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("dtype", ["float32", "float64", "uint8"])
def test_undistort_equals_cv2(dtype):
    """Non-zero (k1, k2, p1, p2, k3), bit-equal, edges included (zeros
    outside: ``BORDER_CONSTANT``); an image wider than the 4096-pixel
    stripe rule's one-row case and a non-square one."""
    rng = np.random.default_rng(1)
    K = np.array([[500.0, 0, 250.3], [0, 505.0, 260.7], [0, 0, 1]])
    # the last: pincushion strong enough to pull the corners from outside
    pincushion = np.array([0.3, 0.1, 0.002, -0.001, 0.0])
    for D in D_CAMS + [D_CAMS[0] * 2.5, pincushion]:
        for shape in ((512, 512), (300, 200), (64, 5000)):
            full = shape + ((3,) if dtype == "float32" else ())
            if dtype == "uint8":
                img = rng.choice(np.array([0, 1, 100, 200], np.uint8), full)
            else:
                img = rng.random(full).astype(dtype)
            got = imageio.undistort(img, K, D)
            want = cv2.undistort(img, K, D)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert (want[0, 0] == 0).all()  # the last image's corner: the border


def test_undistort_map_equals_cv2():
    """The fixed-point map itself equals ``initUndistortRectifyMap``'s
    CV_16SC2 map (integer part and 1/32 fraction)."""
    K = np.array([[512.0, 0, 255.5], [0, 511.0, 256.2], [0, 0, 1]])
    mx, my = imageio.undistort_map(K, D_CAMS[1], 256, 320)
    m1, m2 = cv2.initUndistortRectifyMap(K, D_CAMS[1], np.eye(3), K,
                                         (320, 256), cv2.CV_16SC2)
    np.testing.assert_array_equal(mx >> 5, m1[..., 0])
    np.testing.assert_array_equal(my >> 5, m1[..., 1])
    np.testing.assert_array_equal((my & 31) * 32 + (mx & 31), m2)


@pytest.mark.parametrize("src,dst", [
    ((512, 512), (256, 256)),     # integer downscale: box mean
    ((1002, 1002), (1000, 1000)),  # H36M's non-integer downscale
    ((512, 512), (189, 189)),     # image_scaling 0.37
    ((200, 200), (1000, 1000)),   # upscale (the H36M fixture)
    ((210, 200), (611, 703)),     # non-integer upscale
])
def test_resize_area_and_nearest_equal_cv2(src, dst):
    rng = np.random.default_rng(2)
    dsize = (dst[1], dst[0])
    for img in (rng.random(src + (3,)).astype(np.float32),
                rng.random(src)):
        got = imageio.resize(img, dsize, imageio.AREA)
        want = cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    for img in (rng.integers(0, 256, src).astype(np.uint8), rng.random(src)):
        np.testing.assert_array_equal(
            imageio.resize(img, dsize, imageio.NEAREST),
            cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("k", [1, 2, 4, 5, 8])
def test_erode_dilate_equal_cv2(k):
    """Odd and even square kernels at OpenCV's default anchor; the edge
    neither erodes nor dilates."""
    m = (np.random.default_rng(k).random((60, 70)) > 0.6).astype(np.uint8)
    m[0, :] = 1
    kernel = np.ones((k, k), np.uint8)
    np.testing.assert_array_equal(imageio.erode(m, k), cv2.erode(m, kernel))
    np.testing.assert_array_equal(imageio.dilate(m, k),
                                  cv2.dilate(m, kernel))


def test_rodrigues_equals_cv2():
    rng = np.random.default_rng(3)
    for r in [np.array([0.0, 0.0, 0.3], np.float32), np.zeros(3)] + \
            [rng.normal(size=3) * s for s in (1e-3, 1.0, 3.0)]:
        got, want = imageio.rodrigues(r), cv2.Rodrigues(r)[0]
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---- the loaders' items against JAX's --------------------------------------

def _assert_items_equal(t, j, path=""):
    assert set(t) == set(j), path
    for k in j:
        a, b = t[k], j[k]
        if isinstance(b, dict):
            _assert_items_equal(a, b, path + k + ".")
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path + k
        if k in TOLERANCED:
            np.testing.assert_allclose(a, b, rtol=0, atol=ITEM_ATOL,
                                       err_msg=path + k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path + k)


@pytest.fixture(scope="module")
def thuman_tree(tmp_path_factory):
    """Two subjects (the second male, ``..._M``) with distortion, and the
    ``data/`` human list the multi-person loader reads."""
    base = tmp_path_factory.mktemp("thuman_io")
    roots = [_distort(build_thuman_subject(base / "all" / name, n_poses=2,
                                           hw=H, n_verts=120, seed=i))
             for i, name in enumerate(["subject_F", "subject_M"])]
    (base / "data").mkdir()
    (base / "data" / "THuman_1_human_list.txt").write_text(
        "subject_F\nsubject_M\n")
    return base, roots


@pytest.mark.parametrize("split,ratio,multi,view_num", [
    ("train", 1.0, False, 3),
    ("test", 0.5, False, 4),
    ("train", 0.5, True, 3),
])
def test_thuman_item_matches_jax(thuman_tree, monkeypatch, split, ratio,
                                 multi, view_num):
    base, roots = thuman_tree
    monkeypatch.chdir(base)
    kw = dict(split=split, view_num=view_num, N_rand=48, poses_num=2,
              image_scaling=ratio, multi_person=multi, num_instance=2,
              seed=5)
    j = j_thuman.THumanDatasetBatch(roots[0], **kw)
    t = t_thuman.THumanDatasetBatch(roots[0], **kw)
    for idx in range(2 if multi else 1):
        _assert_items_equal(t[idx], j[idx])


def test_thuman_pair_item_matches_jax(thuman_tree):
    _, roots = thuman_tree
    kw = dict(split="train", view_num=3, N_rand=32, poses_num=2, border=1,
              seed=7)
    j = j_thuman.THumanDatasetPair(roots[1], **kw)
    t = t_thuman.THumanDatasetPair(roots[1], **kw)
    for idx in range(2):
        a, b = t[idx], j[idx]
        for side in ("sp_input", "tp_input"):
            _assert_items_equal(a[side], b[side], side + ".")


@pytest.fixture(scope="module")
def h36m_distorted(h36m_root, tmp_path_factory):  # noqa: F811
    """A copy of the H36M fixture with distorted cameras."""
    root = tmp_path_factory.mktemp("h36m_io") / "S9" / "Posing"
    shutil.copytree(h36m_root, root)
    return _distort(str(root), scale=0.5)


@pytest.mark.parametrize("split,ratio", [("train", 1.0), ("test", 0.5)])
def test_h36m_item_matches_jax(h36m_distorted, split, ratio):
    """The 200 -> 1000 upscale, the tri-level mask (border 4: an even
    kernel), the undistortion of the float image and the uint8 mask,
    Rodrigues and T / 1000."""
    kw = dict(split=split, view_num=3, N_rand=64, start=1, interval=2,
              poses_num=2, image_scaling=ratio, mean_shape=0, border=4,
              seed=11)
    j = j_h36m.H36MDatasetBatch(h36m_distorted, **kw)
    t = t_h36m.H36MDatasetBatch(h36m_distorted, **kw)
    _assert_items_equal(t[1], j[1])


def test_h36m_pair_item_matches_jax(h36m_distorted):
    kw = dict(split="train", view_num=3, N_rand=32, interval=1, poses_num=3,
              image_scaling=0.2, mean_shape=0, border=2, seed=13)
    j = j_h36m.H36MDatasetPair(h36m_distorted, **kw)
    t = t_h36m.H36MDatasetPair(h36m_distorted, **kw)
    a, b = t[1], j[1]
    for side in ("sp_input", "tp_input"):
        _assert_items_equal(a[side], b[side], side + ".")


# ---- factory, MetricWriter, PrefetchLoader, SMPL assets --------------------

def _args(config, **over):
    argv = ["--config", f"configs/{config}.txt"]
    for k, v in over.items():
        argv += [f"--{k}", str(v)]
    return t_config.parse_args(argv)


def _same_attrs(t, j):
    assert type(t).__name__ == type(j).__name__
    keys = set(vars(j)) - {"rng", "subjects"}
    assert keys <= set(vars(t)), keys - set(vars(t))
    for k in keys:
        a, b = vars(t)[k], vars(j)[k]
        if isinstance(b, (np.ndarray, list, tuple)) or k == "cams":
            np.testing.assert_equal(a, b, err_msg=k)
        else:
            assert a == b, k


@pytest.mark.parametrize("dst", ["Synthetic", "THuman_B", "THuman",
                                 "THuman_B_R", "THuman_P", "H36M_B", "H36M",
                                 "H36M_B_All", "H36M_P"])
def test_return_dataset_matches_jax(dst, thuman_tree, h36m_distorted):
    """The same class with the same arguments for each ported data set."""
    root = (thuman_tree[1][0] if dst.startswith("THuman") else
            h36m_distorted)
    args = _args("canonical_transformer", data_set_type=dst, data_root=root,
                 multi_person=0, poses_num=2, interval=1, image_scaling=0.125,
                 num_instance=1)
    _same_attrs(t_factory.return_dataset(args),
                j_factory.return_dataset(args))


@pytest.mark.parametrize("dst", ["multi_pair", "ZJU_B"])
def test_return_dataset_raises_for_the_rest(dst):
    args = _args("canonical_transformer", data_set_type=dst)
    with pytest.raises(NotImplementedError):
        j_factory.return_dataset(args)
    with pytest.raises(NotImplementedError, match="not available"):
        t_factory.return_dataset(args)


def test_return_model_widths_and_state_dict_names():
    """The flagship config's model: ``convert_reference_state_dict`` takes
    its ``state_dict()`` whole, into the tree of shapes JAX's
    ``return_model`` initialises (less the per-instance codes, which the
    flagship never reads), at JAX's compaction fraction."""
    import jax
    import jax.numpy as jnp

    from mpsnerf_tpu.compat.torch_import import convert_reference_state_dict
    from mpsnerf_tpu.data.synthetic import SyntheticHumanDataset
    from mpsnerf_tpu.train.trainer import to_device_input

    args = _args("canonical_transformer")
    t_model = t_factory.return_model(args)
    j_model = j_factory.return_model(args)
    assert t_model.compact_fraction == j_model.compact_fraction == 0.5
    sd = {k: v.numpy() for k, v in t_model.state_dict().items()}
    params, stats, report = convert_reference_state_dict(sd)
    assert report["skipped"] == []

    ds = SyntheticHumanDataset(n_poses=1, n_cameras=3, image_size=32,
                               n_rays=8, n_verts=100, split="test")
    inp = to_device_input(ds.get_item(0, instance_idx=0))
    shapes = jax.eval_shape(lambda key: j_model.init(
        {"params": key}, ds.smpl_for(0), inp, inp, jnp.zeros((8, 3)),
        jnp.zeros((8, 3)), train=False), jax.random.PRNGKey(0))
    want = dict(shapes["params"])
    def shape_tree(tree):
        return jax.tree.map(lambda x: tuple(np.shape(x)), tree)
    assert shape_tree(params) == shape_tree(want)
    assert shape_tree(stats) == shape_tree(dict(shapes["batch_stats"]))


@pytest.mark.parametrize("over", [
    dict(model="coarse_batch"),
    dict(correction_field=1),
    dict(with_viewdirs=1),
    dict(compute_dtype="bfloat16"),
    dict(data_set_type="THuman_P"),
])
def test_return_model_builds_what_jax_builds(over):
    """The model options that used to raise build, with JAX's
    ``return_model``'s field values, and ``convert_reference_state_dict``
    takes the state dict whole (less ``num_batches_tracked``, which it
    marks used)."""
    from mpsnerf_tpu.compat.torch_import import convert_reference_state_dict

    args = _args("canonical_transformer", **over)
    t_model = t_factory.return_model(args)
    j_model = j_factory.return_model(args)
    for f in ("use_transformer", "append_rgb", "with_viewdirs",
              "human_sample", "mean_shape", "correction_field",
              "skinning_field", "correction_style", "pe_condition",
              "compute_dtype", "pair_mode", "blend_rgb", "compact_fraction"):
        assert getattr(t_model, f) == getattr(j_model, f), f
    sd = {k: v.numpy() for k, v in t_model.state_dict().items()}
    _, _, report = convert_reference_state_dict(sd)
    assert report["skipped"] == []
    assert t_model.views_linear.in_features == 256 + 155 + (
        27 if over.get("with_viewdirs") else 0)


def test_metric_writer_records_match_jax(tmp_path, monkeypatch):
    """The same JSONL records.  TensorBoard's import (which loads
    TensorFlow where it is installed, ~8 s) is blocked: both writers then skip its events,
    and the JSONL sink is what is compared."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    scalars = {"loss": 0.5, "psnr": 12.0, "n_dropped": 0.0}
    lines = {}
    for name, cls in (("j", JMetricWriter), ("t", TMetricWriter)):
        w = cls(str(tmp_path / name), "exp")
        w.add_scalars(24, scalars)
        w.add_scalars(48, scalars)
        w.close()
        path = tmp_path / name / "summaries" / "exp" / "scalars.jsonl"
        lines[name] = [json.loads(x) for x in path.read_text().splitlines()]
    assert [sorted(r) for r in lines["t"]] == [sorted(r) for r in lines["j"]]
    assert [r["step"] for r in lines["t"]] == [24, 48]
    assert lines["t"][0]["loss"] == 0.5


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("workers", [0, 2])
def test_prefetch_index_stream_matches_jax(workers):
    """One seed, the same index sequence in order (three epochs of 7),
    also per process of three."""
    for pi, pc in ((0, 1), (1, 3)):
        streams = []
        for cls in (JPrefetchLoader, TPrefetchLoader):
            loader = cls(_Indices(7), seed=3, num_workers=workers,
                         process_index=pi, process_count=pc)
            streams.append([next(loader) for _ in range(21)])
            loader.close()
        assert streams[0] == streams[1]
    loader = TPrefetchLoader(_Indices(7), seed=3, num_workers=0)
    assert (loader.process_index, loader.process_count) == (0, 1)


def test_load_smpl_models_synthetic_rigs_match_jax(tmp_path):
    """No pickles: each gender's synthetic rig, equal to JAX's, with the
    same warning."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = t_load_smpl_models(str(tmp_path), device="cpu")
    assert len([w for w in caught if "not found" in str(w.message)]) == 3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = j_load_smpl_models(str(tmp_path))
    assert sorted(t) == sorted(j) == [0, 1, 2]
    for g in j:
        for field in ("v_template", "shapedirs", "posedirs", "J_regressor",
                      "weights", "faces"):
            np.testing.assert_array_equal(
                getattr(t[g], field).numpy(), np.asarray(getattr(j[g], field)),
                err_msg=f"{g}.{field}")
        assert tuple(t[g].parents) == tuple(j[g].parents)
