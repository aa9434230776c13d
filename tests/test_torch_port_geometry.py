"""Parity of the port's geometry with the JAX package on the CPU: the host
mesh library (marching cubes and tetrahedra, the rasteriser, OBJ),
``knn_points``, the inverse LBS with explicit weights, ``MPSNeRF.query``'s
geometry-only modes, ``extract_density_mesh`` (target and canonical),
``render_normal_map``, ``MeshAnimationRenderer``, the spiral path and the
camera info; then the two mesh CLIs on a tiny synthetic fixture.

The scene: the JAX synthetic rig at 500 vertices, 32^2, 2 input views
(``tests/test_torch_port_variants.py``'s items and ``SMALL`` widths),
seeded weights carried over by ``from_jax``.  Each JAX query runs through
one jitted function per mode whose points are padded to 8192 rows, so XLA
compiles it once per mode for every test of the module.  Tolerances:
the mesh library, normal maps, spiral and camera info exact (the same
host code on the same inputs); ``knn_points`` d2 at 1e-5 and the K=5 id
sets equal wherever the 5th and 6th distances are more than 1e-5 apart
(``torch.topk`` orders ties arbitrarily, ``lax.top_k`` by index); the
warp 1e-6; the query 1e-5 of each output's max; the occupancy grid 1e-4
of its max where both packages' carve masks agree, the masks equal away
from their thresholds, the meshes within 1e-4 of the grid's extent by
symmetric nearest-vertex distance; the baked arrays 1e-5; the animation's
pixels 1e-4 where both rasterisations hit the same face (the LBS of the
two packages differs by ~1e-7, so a pixel on a triangle edge can pick the
neighbouring face), with at most 2 % of the hit pixels on another face.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu import native as j_native
from mpsnerf_tpu.data import attach_body_grid as j_attach_body_grid
from mpsnerf_tpu.data import attach_spconv_plan as j_attach_spconv_plan
from mpsnerf_tpu.geometry import animation as j_animation
from mpsnerf_tpu.geometry import extract as j_extract
from mpsnerf_tpu.geometry import normal_render as j_normal
from mpsnerf_tpu.geometry import spiral as j_spiral
from mpsnerf_tpu.models.mps_nerf import MPSNeRF as JMPSNeRF
from mpsnerf_tpu.ops import knn as j_knn
from mpsnerf_tpu.smpl import lbs as j_lbs
from mpsnerf_tpu.smpl.mesh import vertex_normals as j_vertex_normals
from mpsnerf_tpu.train.trainer import to_device_input as j_to_device_input
from mpsnerf_tpu.utils import cameras as j_cameras

from mpsnerf_torch import native as t_native
from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.data import (
    attach_body_grid, attach_spconv_plan, to_device_input,
)
from mpsnerf_torch.data.imageio import decode_png
from mpsnerf_torch.geometry import animation as t_animation
from mpsnerf_torch.geometry import extract as t_extract
from mpsnerf_torch.geometry import normal_render as t_normal
from mpsnerf_torch.geometry import spiral as t_spiral
from mpsnerf_torch.models.mps_nerf import MPSNeRF as TMPSNeRF
from mpsnerf_torch.ops import knn as t_knn
from mpsnerf_torch.smpl import lbs as t_lbs
from mpsnerf_torch.smpl.model import synthetic_smpl
from mpsnerf_torch.utils import cameras as t_cameras
from tests.test_torch_port_variants import SMALL, _items, random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_VERTS = 500
PAD = 8192  # the JAX queries' row count (one compile per mode)
GRID_N = 32
CASES = {"flagship": {},
         "instance_skinning": dict(correction_field=True,
                                   correction_style="instance",
                                   skinning_field=True)}


@pytest.fixture(scope="module")
def scene():
    j_smpl, items = _items(n_poses=2)
    item = items[1]
    j_attach_body_grid(item)
    j_inp = j_to_device_input({k: v for k, v in item.items()
                               if k != "msk_all"})
    t_item = {k: v for k, v in item.items() if k != "body_grid"}
    attach_body_grid(t_item)
    t_inp = to_device_input(t_item, "cpu")
    return dict(j_smpl=j_smpl, item=item, j_inp=j_inp, t_inp=t_inp,
                j_inp_plan=j_to_device_input(j_attach_spconv_plan(
                    {k: v for k, v in item.items() if k != "msk_all"})),
                t_inp_plan=to_device_input(attach_spconv_plan(dict(t_item)),
                                           "cpu"),
                t_smpl=synthetic_smpl(n_verts=N_VERTS, seed=0, device="cpu"),
                models={}, refs={})


def _models(s, case):
    """(JAX model, variables, port model, JAX query, JAX latent, port
    latent, port items) of a case, built once."""
    if case not in s["models"]:
        kw = dict(SMALL, **CASES[case])
        model = JMPSNeRF(**kw)
        inp = s["j_inp_plan"]
        shapes = jax.eval_shape(lambda k: model.init(
            {"params": k}, s["j_smpl"], inp, inp, jnp.zeros((8, 3)),
            jnp.ones((8, 3)), train=False), jax.random.PRNGKey(0))
        variables = random_variables(shapes, seed=1)
        t_model = TMPSNeRF(**kw).eval()
        t_model.load_state_dict(from_jax(variables), strict=True)
        j_inp = inp if kw.get("correction_field") else s["j_inp"]

        @jax.jit
        def encode(v, images):
            return model.apply(v, images, method="encode")

        @jax.jit
        def query(v, latent, pts, mode_id):
            mode = ("full", "extract_mesh", "mesh_animation")
            return jax.lax.switch(mode_id, [
                lambda p, m=m: model.apply(
                    v, s["j_smpl"], j_inp, j_inp, latent, p,
                    jnp.zeros_like(p), train=False, mode=m, method="query")
                for m in mode], pts)

        j_lat = encode(variables, j_inp["img_all"])
        with torch.no_grad():
            t_inp = s["t_inp_plan"] if kw.get("correction_field") \
                else s["t_inp"]
            t_lat = t_model.encode(t_inp["img_all"])
        s["models"][case] = (model, variables, t_model, query, j_lat, t_lat,
                             t_inp)
    return s["models"][case]


def j_query(s, case, pts, mode):
    """JAX's query at ``pts`` (numpy) in blocks of PAD rows, the last
    padded with far points (no body candidates: they take no compaction
    capacity): a dict of numpy outputs."""
    _, variables, _, query, j_lat, _, _ = _models(s, case)
    mode_id = ("full", "extract_mesh", "mesh_animation").index(mode)
    outs = []
    for i in range(0, len(pts), PAD):
        p = np.full((PAD, 3), 1e6, np.float32)
        blk = pts[i:i + PAD]
        p[:len(blk)] = blk
        raw = query(variables, j_lat, jnp.asarray(p), mode_id)
        outs.append({f: np.asarray(getattr(raw, f))[:len(blk)]
                     for f in ("rgb", "sigma", "bweights", "world_src_pts",
                               "pts_mask", "smpl_query_pts")})
    return {f: np.concatenate([o[f] for o in outs]) for f in outs[0]}


def t_query(s, case, pts, mode):
    _, _, t_model, _, _, t_lat, t_inp = _models(s, case)
    with torch.no_grad():
        return t_model.query(s["t_smpl"], t_inp, t_inp, t_lat, pts,
                             torch.zeros_like(pts), mode=mode)


# ---- the host mesh library ------------------------------------------------


def _sphere_grid(n, r):
    c = (n - 1) / 2.0
    x, y, z = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    return (r - np.sqrt((x - c) ** 2 + (y - c) ** 2
                        + (z - c) ** 2)).astype(np.float32)


@pytest.mark.parametrize("method", ["mc", "tet"])
def test_isosurface_matches_jax(method, tmp_path):
    """Both iso methods on a sphere and on a noise grid: the same vertices
    and triangles; the OBJ files byte-equal and read back."""
    rng = np.random.default_rng(0)
    for grid in (_sphere_grid(24, 8.0),
                 rng.normal(size=(10, 11, 12)).astype(np.float32)):
        jv, jt = j_native.extract_isosurface(grid, 0.0, method=method)
        tv, tt = t_native.extract_isosurface(grid, 0.0, method=method)
        assert len(tv) > 100
        np.testing.assert_array_equal(jv, tv)
        np.testing.assert_array_equal(jt, tt)
    # float32 (the grid's) and float64 (the world's) vertices
    for v in (tv, tv.astype(np.float64) * 0.37 + 0.1):
        j_native.export_obj(str(tmp_path / "j.obj"), v, jt)
        t_native.export_obj(str(tmp_path / "t.obj"), v, tt)
        assert (tmp_path / "j.obj").read_bytes() == \
            (tmp_path / "t.obj").read_bytes()
        back, t = t_native.load_obj(str(tmp_path / "t.obj"))
        np.testing.assert_array_equal(back, v.astype(np.float32))
        np.testing.assert_array_equal(t, tt)
    (tmp_path / "odd.obj").write_text(
        "v 1 2 3 0.5\nv 4 5 6 1\nv 7 8 9 1\nvt 0 0\nf 1/1/1 2/2/2 3/3/3\n"
        "f 3 2 1 4\n")
    back, t = t_native.load_obj(str(tmp_path / "odd.obj"))
    np.testing.assert_array_equal(back, np.arange(1, 10).reshape(3, 3))
    np.testing.assert_array_equal(t, [[0, 1, 2], [2, 1, 0]])
    with pytest.raises(ValueError):
        t_native.extract_isosurface(grid, 0.0, method="nope")


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterizer_matches_jax(seed):
    """Random triangles in front of the camera: pix_to_face, the
    barycentrics and the z-buffer equal to JAX's."""
    rng = np.random.default_rng(seed)
    n = 60
    verts = np.stack([rng.uniform(-5, 45, n), rng.uniform(-5, 37, n),
                      rng.uniform(0.5, 3.0, n)], 1).astype(np.float32)
    tris = rng.integers(0, n, (90, 3)).astype(np.int32)
    j = j_native.rasterize_mesh(verts, tris, 32, 40)
    t = t_native.rasterize_mesh(verts, tris, 32, 40)
    assert (t[0] >= 0).mean() > 0.3
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        t_native.rasterize_mesh(verts, tris + n, 32, 40)


# ---- knn_points and the inverse LBS with weights --------------------------


def test_knn_points_matches_jax(scene):
    """K=5 over 500 posed vertices at 3000 points near and far from them,
    the port in blocks of 700: d2 to 1e-5, the sorted id sets equal away
    from a 5th/6th tie."""
    rng = np.random.default_rng(3)
    v = scene["item"]["vertices"]
    q = np.concatenate([
        v[rng.integers(0, len(v), 2000)] + rng.normal(size=(2000, 3)) * 0.03,
        rng.uniform(v.min(0) - 0.3, v.max(0) + 0.3, (1000, 3)),
    ]).astype(np.float32)
    jd, ji = j_knn.knn_points(jnp.asarray(q), jnp.asarray(v), k=5)
    td, ti = t_knn.knn_points(torch.from_numpy(q), torch.from_numpy(v), k=5,
                              block=700)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    d64 = ((q[:, None].astype(np.float64) - v[None]) ** 2).sum(-1)
    part = np.sort(d64, axis=1)[:, 4:6]
    clear = part[:, 1] - part[:, 0] > 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1)[clear],
                                  np.sort(np.asarray(ji), 1)[clear])
    assert ti.dtype == torch.int64 and (np.diff(td.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("mean_shape", [False, True])
def test_deform_with_weights_matches_jax(scene, mean_shape):
    """Inverse LBS with explicit blend weights at the target pose, to
    1e-6; with ``mean_shape`` the offsets of each point's nearest template
    vertex."""
    rng = np.random.default_rng(4)
    s = scene
    w = rng.uniform(0, 1, (700, 24)).astype(np.float32) ** 4
    w /= w.sum(1, keepdims=True)
    base = np.asarray(s["t_smpl"].v_template)
    pts = (base[rng.integers(0, N_VERTS, 700)]
           + rng.normal(size=(700, 3)) * 0.02).astype(np.float32)
    j_tf = j_lbs.PoseTransforms.create(s["j_smpl"], s["j_inp"]["params"])
    j = j_lbs.deform_target_to_canonical_with_weights(
        s["j_smpl"], j_tf, jnp.asarray(pts), jnp.asarray(w), mean_shape)
    t_tf = t_lbs.PoseTransforms.create(s["t_smpl"], s["t_inp"]["params"])
    t = t_lbs.deform_target_to_canonical_with_weights(
        s["t_smpl"], t_tf, torch.from_numpy(pts), torch.from_numpy(w),
        mean_shape)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


# ---- the geometry-only query ----------------------------------------------


@pytest.mark.parametrize("case,mode", [
    ("flagship", "extract_mesh"), ("flagship", "mesh_animation"),
    ("instance_skinning", "mesh_animation")])
def test_geometry_only_query_matches_jax(scene, case, mode):
    """Canonical points near the template and far from it: every point
    runs the tail (mask all ones, no correction), rgb, sigma, the blend
    weights and the source points within 1e-5 of each output's max."""
    rng = np.random.default_rng(5)
    tv = scene["item"]["t_vertices"]
    pts = np.concatenate([
        tv[rng.integers(0, len(tv), 600)] + rng.normal(size=(600, 3)) * 0.03,
        rng.uniform(tv.min(0) - 0.2, tv.max(0) + 0.2, (200, 3)),
    ]).astype(np.float32)
    j = j_query(scene, case, pts, mode)
    t = t_query(scene, case, torch.from_numpy(pts), mode)
    assert (t.pts_mask.numpy() == 1).all() and (j["pts_mask"] == 1).all()
    np.testing.assert_array_equal(t.smpl_query_pts.numpy(), pts)
    assert float(t.correction.abs().max()) == 0.0
    for f in ("rgb", "sigma", "bweights", "world_src_pts"):
        a, b = j[f], getattr(t, f).numpy()
        scale = float(np.abs(a).max())
        assert np.abs(a - b).max() <= 1e-5 * scale, (f, np.abs(a - b).max())


# ---- extraction -----------------------------------------------------------


def _j_masks(pts, verts, faces):
    """The JAX package's carve quantities (``geometry/extract.py``'s
    steps): d2 to the nearest vertex and the sidedness dot."""
    jt, jp = jnp.asarray(verts, jnp.float32), jnp.asarray(pts)
    d2, _ = j_knn.nearest_vertex(jp, jt)
    normals = j_vertex_normals(jt, jnp.asarray(faces, jnp.int32))
    _, ids5 = j_knn.knn_points(jp, jt, k=5)
    pts_dir = jp - jnp.mean(jt[ids5], axis=1)
    pts_dir = pts_dir / (jnp.linalg.norm(pts_dir, axis=-1, keepdims=True)
                         + 1e-12)
    return np.asarray(d2), np.asarray(
        jnp.sum(pts_dir * jnp.mean(normals[ids5], axis=1), axis=-1))


def _extract_both(s, canonical, monkeypatch):
    key = ("extract", canonical)
    if key not in s["refs"]:
        item = s["item"]
        verts = np.asarray(item["t_vertices" if canonical else "vertices"])
        faces = np.asarray(s["j_smpl"].faces)
        grid = j_extract.GridSpec.from_vertices(verts, n=GRID_N)
        mode = "extract_mesh" if canonical else "full"
        occ_j = {}
        real = j_extract.extract_isosurface

        def spy(occ, thr):
            occ_j["occ"] = np.array(occ)
            return real(occ, thr)

        monkeypatch.setattr(j_extract, "extract_isosurface", spy)
        jv, jt = j_extract.extract_density_mesh(
            lambda p: j_query(s, "flagship", p, mode)["sigma"], grid, verts,
            faces)
        t_grid = t_extract.GridSpec.from_vertices(verts, n=GRID_N)
        np.testing.assert_array_equal(t_grid.points_on("cpu").numpy(),
                                      grid.points())

        def density(p):
            return t_query(s, "flagship", p, mode).sigma

        # the port's chunks are JAX's blocks (the same compaction sets)
        occ_t = t_extract.occupancy_grid(density, t_grid, verts, faces,
                                         chunk=PAD, device="cpu").numpy()
        stats = {}
        tv, tt = t_extract.extract_density_mesh(
            density, t_grid, verts, faces, chunk=PAD, device="cpu",
            stats=stats)
        pts = torch.from_numpy(grid.points())
        near, outside = t_extract.carve_masks(
            pts, torch.from_numpy(verts), torch.from_numpy(faces).long())
        s["refs"][key] = dict(grid=grid, pts=grid.points(), jv=jv, jt=jt,
                              tv=tv, tt=tt, occ_j=occ_j["occ"].reshape(-1),
                              occ_t=occ_t, near=near.numpy(),
                              outside=outside.numpy(), stats=stats,
                              j=_j_masks(grid.points(), verts, faces))
    return s["refs"][key]


def _nn_dist(a, b):
    """Each point of ``a``'s distance to the nearest point of ``b``."""
    from scipy.spatial import cKDTree

    return cKDTree(b).query(a)[0]


@pytest.mark.parametrize("canonical", [False, True])
def test_extract_density_mesh_matches_jax(scene, canonical, monkeypatch):
    """A 32^3 grid in the target pose (``"full"``, the body grid's
    compaction) and in the canonical frame (``"extract_mesh"``)."""
    r = _extract_both(scene, canonical, monkeypatch)
    d2, dot = r["j"]
    clear_n = np.abs(d2 - t_extract.DIST_THRESHOLD_SQ) > 1e-6
    clear_o = np.abs(dot) > 1e-5
    np.testing.assert_array_equal(r["near"][clear_n],
                                  (d2 < t_extract.DIST_THRESHOLD_SQ)[clear_n])
    np.testing.assert_array_equal(r["outside"][clear_o], (dot > 0)[clear_o])
    assert 0.02 < r["near"].mean() < 0.9 and 0.05 < r["outside"].mean() < 0.99
    same = (r["near"] == (d2 < t_extract.DIST_THRESHOLD_SQ)) & (
        r["outside"] == (dot > 0))
    occ_j, occ_t = r["occ_j"], r["occ_t"]
    assert np.abs(occ_j - occ_t)[same].max() <= 1e-4 * np.abs(occ_j).max()
    assert len(r["tv"]) > 100
    assert len(r["tt"]) == len(r["jt"])
    extent = float(np.max(r["grid"].size))
    assert _nn_dist(r["tv"], r["jv"]).max() <= 1e-4 * extent
    assert _nn_dist(r["jv"], r["tv"]).max() <= 1e-4 * extent
    assert set(r["stats"]) >= {"density_ms", "mask_ms", "carve_ms", "mc_ms"}
    assert r["stats"]["n_points"] == GRID_N ** 3


# ---- normal maps ------------------------------------------------------------


def test_render_normal_map_matches_jax(scene, tmp_path, monkeypatch):
    """The canonical mesh from ring camera 3 at 64^2: the RGBA pixels equal
    JAX's; the port's PNG decodes to them and equals JAX's (cv2's) file
    decoded."""
    from mpsnerf_torch.data.synthetic import _ring_camera

    r = _extract_both(scene, True, monkeypatch)
    K, R, T = _ring_camera(2 * np.pi * 3 / 24, 2.2, 0.1, 64, 64)
    crop = (0, 10, 64, 40)
    jp, tp = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    j = j_normal.render_normal_map(r["jv"], r["jt"], K, R, T, 64, 64,
                                   crop=crop, save_path=jp)
    t = t_normal.render_normal_map(r["jv"], r["jt"], K, R, T, 64, 64,
                                   crop=crop, save_path=tp)
    assert t.shape == (64, 40, 4) and t.dtype == np.uint8
    assert 0 < (t[..., 3] > 0).mean() < 1
    np.testing.assert_array_equal(t, j)
    with open(tp, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()), t)
    back = cv2.imread(jp, cv2.IMREAD_UNCHANGED)[..., [2, 1, 0, 3]]
    np.testing.assert_array_equal(back, t)


# ---- the mesh animation -----------------------------------------------------


def _j_faces(renderer, tp_item, k, h, w):
    """The face ids of JAX's rasterisation of the animated mesh (its
    ``render_pose`` projection)."""
    tp = j_to_device_input({"params": tp_item["params"]})
    tf_t = j_lbs.PoseTransforms.create(renderer.smpl, tp["params"])
    wv = np.asarray(renderer._deform_with_weights(
        tf_t, renderer._baked["bweights"]))
    K, R = tp_item["K_all"][k], tp_item["R_all"][k]
    T = np.asarray(tp_item["T_all"][k]).reshape(3)
    cam = wv @ R.T + T
    z = np.maximum(cam[:, 2], 1e-6)
    screen = np.stack([K[0, 0] * cam[:, 0] / z + K[0, 2],
                       K[1, 1] * cam[:, 1] / z + K[1, 2], cam[:, 2]],
                      1).astype(np.float32)
    return j_native.rasterize_mesh(screen, renderer.tris, h, w)[0]


def test_mesh_animation_matches_jax(scene, monkeypatch):
    """Bake at the canonical mesh extracted above (1e-5), then
    ``render_pose`` at 32^2 from view 1, fast and full."""
    s = scene
    r = _extract_both(s, True, monkeypatch)
    _, _, t_model, _, j_lat, _, _ = _models(s, "flagship")

    def j_qfn(v, smpl, sp, latent, pts):
        o = j_query(s, "flagship", np.asarray(pts), "mesh_animation")
        return o["bweights"], o["rgb"], o["sigma"]

    jr = j_animation.MeshAnimationRenderer(
        None, None, s["j_smpl"], r["jv"], r["jt"], query_fn=j_qfn,
        encode_fn=lambda v, images: j_lat, mean_shape=False)
    item = {k: v for k, v in s["item"].items()
            if k not in ("body_grid", "msk_all")}
    jr.bake(item)
    tr = t_animation.MeshAnimationRenderer(
        t_model, s["t_smpl"], r["jv"], r["jt"], device="cpu")
    tr.bake(item)
    for f in ("bweights", "rgb", "sigma"):
        np.testing.assert_allclose(tr._baked[f], jr._baked[f], atol=1e-5,
                                   err_msg=f)
    faces_j = _j_faces(jr, item, 1, 32, 32)
    for fast in (True, False):
        j = jr.render_pose(item, 1, 32, 32, fast=fast)
        t = tr.render_pose(item, 1, 32, 32, fast=fast)
        faces_t = tr.last_pose["pix_to_face"]
        hit = (faces_j >= 0) | (faces_t >= 0)
        agree = faces_j == faces_t
        assert hit.sum() > 50
        assert (~agree[hit]).mean() <= 0.02
        np.testing.assert_allclose(t[agree], j[agree], atol=1e-4)
        assert np.isfinite(t).all()
        if not fast:
            assert tr.last_pose["n_samples"] == 11 * int((faces_t >= 0).sum())


# ---- spiral and camera info -------------------------------------------------


def test_spiral_and_camera_info_match_jax(tmp_path):
    """``gen_path`` on a ring of 8 cameras (with and without a centre),
    ``load_cam`` from ``annots.npy`` and from json, ``viewmatrix``, and the
    camera-info file: equal to JAX's."""
    from mpsnerf_torch.data.synthetic import _ring_camera

    cams = [_ring_camera(2 * np.pi * i / 8, 2.2, 0.1, 64, 64)
            for i in range(8)]
    lower = np.array([[0.0, 0.0, 0.0, 1.0]])
    RT = [np.concatenate([np.concatenate([R, T], 1), lower], 0)
          for _, R, T in cams]
    for center in (None, np.array([0.1, 0.0, -0.2])):
        for a, b in zip(j_spiral.gen_path(RT, center, 5),
                        t_spiral.gen_path(RT, center, 5)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(6)
    z, up, pos = rng.normal(size=(3, 3))
    np.testing.assert_array_equal(j_spiral.viewmatrix(z, up, pos),
                                  t_spiral.viewmatrix(z, up, pos))
    annots = {"cams": {"K": [c[0] for c in cams], "R": [c[1] for c in cams],
                       "T": [c[2] * 1000 for c in cams]}}
    np.save(tmp_path / "annots.npy", annots)
    with open(tmp_path / "annots.json", "w") as f:
        json.dump({"cams": {"20190823": {
            k: [np.asarray(x).tolist() for x in v]
            for k, v in annots["cams"].items()}}}, f)
    for name in ("annots.npy", "annots.json"):
        jk, jrt = j_spiral.load_cam(str(tmp_path / name))
        tk, trt = t_spiral.load_cam(str(tmp_path / name))
        np.testing.assert_array_equal(np.array(jk), np.array(tk))
        np.testing.assert_array_equal(np.array(jrt), np.array(trt))
    w2c = t_spiral.gen_path(RT, num_views=3)
    Ks = [c[0] for c in cams[:3]]
    j_cameras.write_camera_info(str(tmp_path / "j" / "cams.json"), Ks, w2c)
    t_cameras.write_camera_info(str(tmp_path / "t" / "cams.json"), Ks, w2c)
    assert (tmp_path / "j" / "cams.json").read_text() == \
        (tmp_path / "t" / "cams.json").read_text()


# ---- the two mesh CLIs ------------------------------------------------------


def test_mesh_clis_on_a_tiny_fixture(tmp_path, monkeypatch):
    """``extract_thuman_mesh_torch.py`` (target and ``--can_flag 1``) on
    the synthetic config at 32^2 and ``--mesh_N`` 16, on the CPU; then
    ``render_thuman_mesh_torch.py`` over its OBJ files: the JAX CLIs'
    file names, RGBA PNGs with coverage."""
    import extract_thuman_mesh_torch
    import render_thuman_mesh_torch

    config = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "synthetic_smoke.txt")
    monkeypatch.chdir(tmp_path)
    argv = ["--config", config, "--device", "cpu", "--mesh_N", "16",
            "--image_scaling", "0.0625", "--basedir", str(tmp_path / "logs")]
    runs = [extract_thuman_mesh_torch.main(argv + ["--can_flag", str(c)])
            for c in (0, 1)]
    out = tmp_path / "objs" / "THuman" / "synthetic_smoke"
    names = sorted(os.listdir(out))
    assert names == ["canonical_3_view_pose_000.obj",
                     "novel_3_view_pose_000.obj"]
    for run in runs:
        assert len(run.verts) > 50 and run.n_dropped == 0
        assert np.isfinite(run.verts).all()
        v, t = t_native.load_obj(run.obj_path)
        np.testing.assert_allclose(v, run.verts, rtol=1e-5)
        np.testing.assert_array_equal(t, run.tris)
    pngs = render_thuman_mesh_torch.main(["--config", config, "--cameras",
                                          "4", "12"])
    assert sorted(os.path.basename(p) for p in pngs) == [
        f"{m}_view_{j:03d}_normal.png" for m in (
            "canonical_3_view_pose_000", "novel_3_view_pose_000")
        for j in (0, 1)]
    for p in pngs:
        with open(p, "rb") as f:
            img = decode_png(f.read())
        assert img.shape == (512, 256, 4) and (img[..., 3] > 0).any()
