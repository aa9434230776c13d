"""The port's legacy eval on the CPU: ``run_legacy_test`` against the JAX
runner's on the same items and weights, the 8-bit ``INTER_LINEAR`` resize
its strip uses against ``cv2.resize``, the AVI writer against
``cv2.VideoCapture``, ``sample_rays_ohem`` against the JAX sampler, and
the CLI's routing of ``THuman_B_R`` to the legacy test and its training
of a ``correction_by_*`` model.

``run_legacy_test`` renders a ``CorrectionF3D`` cut to
``tests/test_torch_port_legacy.py``'s widths on 2 synthetic test items
(24 cameras at 32^2, 3 input views), so views 0 and 12 of each: the same
file names, PSNR at 1e-4, the ground truth and the input-view strip
decoded equal (the PNG encoders compress differently: pixels are
compared, not bytes), predictions within 1/255 (``to8b`` truncates), and
each sweep video decoded by OpenCV: its frame count and size (the JAX
runner's too), and the port's frames within JPEG error of the PNGs they
were made from."""

import os
import sys

import cv2
import numpy as np
import pytest

from mpsnerf_tpu.data import attach_spconv_plan as j_attach_spconv_plan
from mpsnerf_tpu.data.synthetic import SyntheticHumanDataset as JDataset
from mpsnerf_tpu.eval import runner as j_runner
from mpsnerf_tpu.rays import rays as j_rays
from mpsnerf_tpu.train.trainer import to_device_input as j_to_device_input

from mpsnerf_torch.data import imageio
from mpsnerf_torch.eval import runner as t_runner
from mpsnerf_torch.eval import video
from mpsnerf_torch.rays import rays as t_rays
from mpsnerf_torch.smpl.model import synthetic_smpl

import run_nerf_batch_torch as cli

from tests.test_torch_port_cli import _write_smpl_assets
from tests.test_torch_port_legacy import CASES, _pair
from tests.test_torch_port_variants import N_VERTS
from tests.thuman_fixture import build_thuman_subject
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

HW = 32


def _legacy_items():
    ds = JDataset(n_poses=2, n_cameras=24, input_views=[0, 8, 16],
                  image_size=HW, n_rays=16, n_verts=N_VERTS,
                  num_instances=1, split="test")
    return ds.smpl_for(0), [ds.get_item(p, instance_idx=0) for p in (0, 1)]


def _args(chunk=256, n_samples=8):
    import types

    return types.SimpleNamespace(chunk=chunk, N_samples=n_samples,
                                 N_importance=0, white_bkgd=False)


def _files(d):
    return sorted(os.listdir(d))


def _jpeg_close(a, b):
    """Within JPEG error: mean |diff| under 2 and PSNR over 35 dB."""
    err = a.astype(np.float64) - b
    return (np.abs(err).mean() < 2
            and 10 * np.log10(255.0 ** 2 / np.mean(err ** 2)) > 35)


def _frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame[..., ::-1])
    cap.release()
    return out


def test_run_legacy_test_matches_jax(tmp_path):
    j_smpl, items = _legacy_items()
    inp = j_to_device_input(j_attach_spconv_plan(dict(items[1]),
                                                 canonical=True))
    scene = dict(j_smpl=j_smpl, models={}, j_inp=[inp, inp])
    model, variables, t_model = _pair(scene, *CASES["correction_by_f3d"])
    t_smpl = synthetic_smpl(n_verts=N_VERTS, seed=0, device="cpu")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_psnr = j_runner.run_legacy_test(
        _args(), model, variables, lambda g: j_smpl, jdir,
        [dict(it) for it in items], H=HW, W=HW, data_interval=1,
        start_pose=13)
    t_psnr = t_runner.run_legacy_test(
        _args(), t_model, lambda g: t_smpl, tdir,
        [dict(it) for it in items], H=HW, W=HW, data_interval=1,
        start_pose=13, device="cpu")
    assert abs(j_psnr - t_psnr) <= 1e-4 * abs(j_psnr)
    assert _files(jdir) == _files(tdir)
    names = _files(tdir)
    assert {"00_00_00.png", "00_01_12.png", "frame0014_view0012.png",
            "frame0013_view0000_gt.png", "novel_pose.avi",
            "novel_view.avi"} <= set(names)
    npy = [f for f in names if f.startswith("psnr_")]
    assert len(npy) == 1
    np.testing.assert_allclose(np.load(os.path.join(tdir, npy[0])), j_psnr,
                               rtol=1e-4)
    strip_rows = int(HW * 2 * HW / (3 * HW))  # 3 input views at 2 W wide
    for name in (f for f in names if f.endswith(".png")):
        j = cv2.imread(os.path.join(jdir, name)).astype(int)
        t = cv2.imread(os.path.join(tdir, name)).astype(int)
        assert j.shape == t.shape, name
        if name.endswith("_gt.png"):
            np.testing.assert_array_equal(t, j, err_msg=name)
        elif name.startswith("frame"):
            assert np.abs(t - j).max() <= 1, name
        else:
            # the strip over pred | gt
            np.testing.assert_array_equal(t[:strip_rows], j[:strip_rows])
            np.testing.assert_array_equal(t[strip_rows:, HW:],
                                          j[strip_rows:, HW:])
            assert np.abs(t[strip_rows:, :HW] - j[strip_rows:, :HW]).max() \
                <= 1, name
    for avi, suffix in (("novel_pose.avi", "_12.png"),
                        ("novel_view.avi", None)):
        srcs = [f for f in names if f.endswith(".png") and (
            f.endswith(suffix) if suffix else f.startswith("00_00_"))]
        want = [cv2.imread(os.path.join(tdir, f))[..., ::-1] for f in srcs]
        for d in (jdir, tdir):
            got = _frames(os.path.join(d, avi))
            assert len(got) == len(want) >= 1, (d, avi)
            for g, w in zip(got, want):
                if d == jdir:
                    # OpenCV's MJPG writer drops an odd last row; its
                    # frames' pixels are not the port's to hold
                    assert g.shape == w[:g.shape[0] // 2 * 2].shape
                    continue
                assert g.shape == w.shape, avi
                assert _jpeg_close(g, w), avi


@pytest.mark.parametrize("kind", ["downscale", "upscale", "mixed"])
def test_resize_linear_is_cv2(kind):
    """``imageio.resize(..., LINEAR)`` byte-equal to ``cv2.resize`` at its
    default ``INTER_LINEAR`` on uint8 images of 1, 3 and 4 channels,
    including the legacy strip's 2/3 and an exact halving."""
    rng = np.random.default_rng({"downscale": 0, "upscale": 1,
                                 "mixed": 2}[kind])
    shapes = {"downscale": [((96, 288), (64, 192)), ((64, 64), (32, 32))],
              "upscale": [((13, 7), (41, 30))],
              "mixed": [((40, 9), (17, 33))]}[kind]
    for _ in range(40):
        sh, sw = rng.integers(2, 80, 2)
        f = {"downscale": (0.2, 1.0), "upscale": (1.0, 4.0),
             "mixed": (0.3, 3.0)}[kind]
        dh, dw = (max(1, int(x * rng.uniform(*f))) for x in (sh, sw))
        shapes.append(((sh, sw), (dh, dw)))
    for i, ((sh, sw), (dh, dw)) in enumerate(shapes):
        c = (1, 3, 4)[i % 3]
        img = rng.integers(0, 256, (sh, sw, c) if c > 1 else (sh, sw),
                           dtype=np.uint8)
        np.testing.assert_array_equal(
            imageio.resize(img, (dw, dh), imageio.LINEAR),
            cv2.resize(img, (int(dw), int(dh))),
            err_msg=f"{(sh, sw, c)} -> {(dh, dw)}")


def _smooth_frames(n, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.stack([xx * 4 + 9 * i, yy * 6, (xx + yy) * 2 + 20 * i],
                     -1).astype(np.uint8) for i in range(n)]  # < 256


@pytest.mark.parametrize("codec", [video.DIB, video.MJPG])
def test_avi_decodes_with_cv2(tmp_path, codec):
    """The writer's AVI through ``cv2.VideoCapture``: frame count, size,
    fps, the container's own header and index; frames exact for ``DIB ``
    (an odd width: rows padded to 4 bytes), within JPEG error for
    ``MJPG``; a frame of another size resized as ``INTER_LINEAR`` does."""
    frames = _smooth_frames(3, 37, 53)
    names = []
    for i, f in enumerate(frames + [cv2.resize(frames[0], (40, 30))]):
        names.append(f"f{i}.png")
        cv2.imwrite(str(tmp_path / names[-1]), f[..., ::-1])
    path = video.images_to_video(str(tmp_path), "clip", names, fps=3,
                                 codec=codec)
    assert video.read_avi_index(path)[:4] == (codec, 53, 37, 4)
    cap = cv2.VideoCapture(path)
    assert (cap.get(cv2.CAP_PROP_FRAME_COUNT),
            cap.get(cv2.CAP_PROP_FRAME_WIDTH),
            cap.get(cv2.CAP_PROP_FRAME_HEIGHT), cap.get(cv2.CAP_PROP_FPS)) \
        == (4, 53, 37, 3)
    cap.release()
    want = frames + [imageio.resize(cv2.resize(frames[0], (40, 30)),
                                    (53, 37), imageio.LINEAR)]
    got = _frames(path)
    assert len(got) == 4
    for g, w in zip(got, want):
        err = np.abs(g.astype(int) - w)
        assert err.max() == 0 if codec == video.DIB else _jpeg_close(g, w)
    data = video.frames_to_video_bytes(
        np.stack(frames).astype(np.float32) / 255.0)
    (tmp_path / "b.avi").write_bytes(data)
    assert len(_frames(str(tmp_path / "b.avi"))) == 3


@pytest.mark.parametrize("split,zero_loss", [("train", False),
                                             ("train", True),
                                             ("test", False)])
def test_sample_rays_ohem_matches_jax(split, zero_loss):
    """The same rays from one seed as the JAX sampler: the hard draws in
    proportion to the loss image (uniform when it is all zero), the
    uniform draws, the resampling of rays that miss the box; the test
    split's every pixel."""
    ds = JDataset(n_poses=1, n_cameras=4, image_size=64, n_rays=8,
                  n_verts=N_VERTS, split="test")
    item = ds.get_item(0, instance_idx=0)
    K, R, T = ds.cameras[1]
    img = np.transpose(item["img_all"][1], (1, 2, 0)).copy()
    msk = (item["msk_all"][1] > 0).astype(np.uint8)
    rng = np.random.default_rng(4)
    loss = rng.uniform(0, 1, img.shape[:2]) * (rng.uniform(
        size=img.shape[:2]) < 0.3)
    if zero_loss:
        loss[:] = 0
    bounds = item["world_bounds"] if "world_bounds" in item else np.stack(
        [item["vertices"].min(0) - 0.05, item["vertices"].max(0) + 0.05])
    j = j_rays.sample_rays_ohem(img, loss, msk, K, R, T, bounds, 300, split,
                                rng=np.random.default_rng(7))
    t = t_rays.sample_rays_ohem(img, loss, msk, K, R, T, bounds, 300, split,
                                rng=np.random.default_rng(7))
    for f in j._fields:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    assert len(t.rgb) == (300 if split == "train" else 64 * 64)


@pytest.fixture(scope="module")
def thuman_512(tmp_path_factory):
    """A THuman subject at 512^2 (the legacy test reads its frames at
    ``512 * image_scaling``) with 15 poses (the legacy window is poses 13
    and 14), and the rigs of its vertex count in ``assets/``."""
    base = tmp_path_factory.mktemp("thuman_legacy")
    root = build_thuman_subject(base / "subject_F", n_poses=15, hw=512,
                                n_verts=120, seed=3)
    _write_smpl_assets(str(base / "assets"), n_verts=120)
    return base, root


def test_cli_routes_thuman_b_r_to_the_legacy_test(thuman_512, tmp_path,
                                                   monkeypatch):
    """``--data_set_type THuman_B_R --save_weights 0`` with a
    ``correction_by_f3d`` model: the CLI evaluates through
    ``run_legacy_test`` (poses 13 and 14 of the test split at 32^2, views
    0 and 12), writing the PSNR, the side-by-side and per-frame PNGs and
    both videos."""
    base, root = thuman_512
    monkeypatch.chdir(base)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    seen = {}
    orig = t_runner.run_legacy_test

    def spy(*a, **k):
        seen.update(k, n_items=len(a[4]))
        return orig(*a, **k)

    monkeypatch.setattr(t_runner, "run_legacy_test", spy)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cli.main([
        "--config", os.path.join(repo, "configs", "canonical_transformer.txt"),
        "--basedir", str(tmp_path / "logs"), "--device", "cpu",
        "--data_root", root, "--data_set_type", "THuman_B_R",
        "--model", "correction_by_f3d", "--save_weights", "0",
        "--image_scaling", "0.0625", "--multi_person", "0",
        "--num_instance", "1", "--N_samples", "4", "--chunk", "1024",
        "--batch_size", "1", "--no_reload"])
    assert seen["n_items"] == 2 and seen["H"] == seen["W"] == 32
    assert seen["start_pose"] == 13
    out = tmp_path / "logs" / "THuman_3_view"
    [testset] = [d for d in os.listdir(out) if d.startswith("testset_")]
    names = _files(out / testset)
    # the window's items are its poses 0 and 1, frames 13 and 14
    assert {"00_00_00.png", "00_01_12.png", "frame0013_view0000.png",
            "frame0014_view0012_gt.png"} <= set(names), names
    assert len([f for f in names if f.startswith("psnr_")]) == 1
    for avi in ("novel_pose.avi", "novel_view.avi"):
        # 3 input views at 2 x 32 wide: a 21-row strip over pred | gt
        _, w, h, n, sizes = video.read_avi_index(str(out / testset / avi))
        assert (w, h, n, len(sizes)) == (64, 32 + 21, 2, 2), avi


def test_cli_trains_a_legacy_model(tmp_path, monkeypatch):
    """``--model correction_by_uvh_agg_fagg`` trains through the CLI on the
    synthetic config: one item's view-steps, finite losses, the
    correction fields moved from their zero init."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    run = cli.main([
        "--config", os.path.abspath("configs/synthetic_smoke.txt"),
        "--basedir", str(tmp_path / "logs"), "--device", "cpu",
        "--model", "correction_by_uvh_agg_fagg", "--use_f2d", "1",
        "--N_samples", "4", "--N_rand", "32", "--N_iteration", "5",
        "--i_print", "6", "--i_weights", "100", "--num_worker", "0"])
    assert run.trainer.global_step == 6
    assert type(run.trainer.model).__name__ == "CorrectionUvhAgg"
    assert all(np.isfinite(float(t.total)) for t, _ in run.trainer.last_logs)
    for field in ("forward_deform", "backward_deform"):
        out = getattr(run.trainer.model, field).output_linear.weight.detach()
        assert float(out.abs().max()) > 0, field
