"""Parity of the PyTorch port's model, data and weight bridge with the JAX
package, on the CPU.  The weights come from the JAX package's init and
cross over through ``mpsnerf_torch.compat.from_jax``; the scene is
``__graft_entry__._build_scene`` (600 vertices, 64^2, 3 input views)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from mpsnerf_tpu.compat.torch_import import convert_reference_state_dict
from mpsnerf_tpu.data import attach_body_grid as j_attach_body_grid
from mpsnerf_tpu.data.synthetic import SyntheticHumanDataset as JDataset
from mpsnerf_tpu.models.mps_nerf import MPSNeRF as JMPSNeRF
from mpsnerf_tpu.models.resnet import SpatialEncoder as JSpatialEncoder
from mpsnerf_tpu.models.transformer import ViewFusionTransformer as JTransformer
from mpsnerf_tpu.smpl.model import synthetic_smpl as j_synthetic_smpl

from mpsnerf_torch.compat.from_jax import (
    encoder_state_dict,
    from_jax,
    transformer_state_dict,
)
from mpsnerf_torch.data import attach_body_grid, to_device_input
from mpsnerf_torch.data.synthetic import (
    SyntheticHumanDataset as TDataset,
    dilate5,
    gaussian_blur5,
)
from mpsnerf_torch.models.layers import TorchLinear
from mpsnerf_torch.models.mps_nerf import MPSNeRF as TMPSNeRF
from mpsnerf_torch.models.resnet import SpatialEncoder as TSpatialEncoder
from mpsnerf_torch.models.transformer import ViewFusionTransformer as TTransformer
from mpsnerf_torch.smpl.model import SMPLModel, synthetic_smpl as t_synthetic_smpl


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_smpl(j_smpl) -> SMPLModel:
    return SMPLModel(
        **{f: torch.from_numpy(np.asarray(getattr(j_smpl, f)).copy())
           for f in ("v_template", "shapedirs", "posedirs", "J_regressor",
                     "weights")},
        faces=torch.from_numpy(np.asarray(j_smpl.faces).astype(np.int64)),
        parents=tuple(j_smpl.parents),
    )


@pytest.fixture(scope="module")
def scene():
    """The JAX scene, init and latent, and the same on the port's side."""
    ds, j_smpl, inp = __graft_entry__._build_scene()
    item = _np_tree(inp)
    j_item = dict(item)
    j_attach_body_grid(j_item)
    j_inp = dict(inp, body_grid=j_item["body_grid"])
    model = JMPSNeRF(num_instances=1)
    variables = model.init(
        {"params": jax.random.PRNGKey(0)}, j_smpl, inp, inp,
        jnp.zeros((8, 3)), jnp.zeros((8, 3)), train=False,
    )
    latent = model.apply(variables, inp["img_all"], method=JMPSNeRF.encode)

    t_model = TMPSNeRF().eval()
    t_model.load_state_dict(from_jax(_np_tree(variables)), strict=True)
    t_item = attach_body_grid(dict(item))
    t_inp = to_device_input(t_item, "cpu")
    return dict(j_smpl=j_smpl, j_inp=j_inp, model=model, variables=variables,
                latent=latent, t_model=t_model, t_smpl=_port_smpl(j_smpl),
                t_inp=t_inp)


def test_synthetic_rig_is_the_same():
    j = j_synthetic_smpl(n_verts=600, seed=3)
    t = t_synthetic_smpl(n_verts=600, seed=3, device="cpu")
    for f in ("v_template", "shapedirs", "posedirs", "J_regressor",
              "weights", "faces"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)
    assert tuple(j.parents) == t.parents


@pytest.mark.parametrize("channels", [1, 3])
def test_dilate_and_blur_match_opencv(channels):
    """scipy redoes cv2.dilate(5x5 ones) and cv2.GaussianBlur((5,5), 0)
    (the [1,4,6,4,1]/16 kernel, reflect-101 border); 1e-6 covers float32
    rounding of the separable sums."""
    rng = np.random.default_rng(channels)
    shape = (37, 41) if channels == 1 else (37, 41, 3)
    img = (rng.uniform(size=shape) * (rng.uniform(size=shape) < 0.1)
           ).astype(np.float32)
    np.testing.assert_array_equal(
        cv2.dilate(img, np.ones((5, 5), np.uint8)), dilate5(img))
    np.testing.assert_allclose(cv2.GaussianBlur(img, (5, 5), 0),
                               gaussian_blur5(img), atol=1e-6)


def test_scene_builder_matches_jax_item():
    """The port's scene builder gives the JAX item without cv2 or jax:
    images, ray colours, geometry and the depth range it bounds at 1e-5
    (fp32 posing in another library), cameras, rays and masks exact (the
    same numpy code)."""
    kw = dict(n_poses=1, n_cameras=4, image_size=64, n_verts=600,
              num_instances=1)
    j = JDataset(split="test", n_rays=64, **kw).get_item(0, instance_idx=0)
    t = TDataset(**kw).get_item(0, instance_idx=0)
    assert set(t) == set(j)
    for k in ("img_all", "rgb_all", "msk_all", "vertices", "t_vertices",
              "feature", "t_feature", "bounds", "t_bounds", "near_all",
              "far_all"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-5, err_msg=k)
    for k in ("K_all", "R_all", "T_all", "ray_o_all", "ray_d_all",
              "mask_at_box_all", "bkgd_msk_all", "coord", "out_sh",
              "t_coord", "t_out_sh", "gender", "instance_idx", "pose_index"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for k in j["params"]:
        np.testing.assert_array_equal(t["params"][k], j["params"][k])


def test_torch_linear_init_bound():
    torch.manual_seed(0)
    layer = TorchLinear(100, 50)
    assert layer.weight.abs().max() <= 0.1 and layer.bias.abs().max() <= 0.1
    assert layer.weight.abs().max() > 0.09 and layer.bias.abs().max() > 0.05
    assert TorchLinear(7, 3, bias=False).bias is None


def test_weight_bridge_round_trip(scene):
    """JAX init -> from_jax -> the port's state_dict() ->
    convert_reference_state_dict gives back the JAX tree, consuming every
    key."""
    sd = {k: v.numpy() for k, v in scene["t_model"].state_dict().items()}
    params, stats, report = convert_reference_state_dict(sd)
    assert report["skipped"] == []
    want = _np_tree(scene["variables"])
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat_p) == len(jax.tree.leaves(want["params"]))
    jax.tree.map(np.testing.assert_array_equal, params,
                 jax.tree.map(np.asarray, dict(want["params"])))
    jax.tree.map(np.testing.assert_array_equal, stats,
                 jax.tree.map(np.asarray, dict(want["batch_stats"])))


def test_spatial_encoder(scene):
    """atol 1e-4: fp32 convolutions in XLA and oneDNN sum in other orders
    over 7x7x3 and 3x3x64 windows."""
    enc = TSpatialEncoder().eval()
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(3, 3, 64, 48)).astype(np.float32)
    jenc = JSpatialEncoder()
    v = jenc.init(jax.random.PRNGKey(1), jnp.asarray(imgs))
    # non-trivial running statistics, so eval-mode BN is exercised
    v = jax.tree.map(np.asarray, v)
    v["batch_stats"] = jax.tree.map(
        lambda x: x + rng.uniform(0.1, 0.5, size=x.shape).astype(np.float32),
        v["batch_stats"])
    enc.load_state_dict(
        encoder_state_dict(v["params"], v["batch_stats"]), strict=True)
    j = jenc.apply(v, jnp.asarray(imgs))
    with torch.no_grad():
        t = enc(torch.from_numpy(imgs))
    assert t.shape == (3, 128, 16, 12)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-4)
    # the model's own encoder on the scene's images
    with torch.no_grad():
        lat = scene["t_model"].encode(scene["t_inp"]["img_all"])
    np.testing.assert_allclose(np.asarray(scene["latent"]), lat.numpy(),
                               atol=1e-4)


def test_encode_latent_is_channels_last_and_matches_jax(scene):
    """``MPSNeRF.encode`` returns the latent channels-last in memory (the
    layout the patch grid-sample kernels read, made once per encode) with
    the logical shape (V, C, H/4, W/4) and JAX's values (atol 1e-4, as
    above); features sampled from it equal those from a contiguous copy."""
    from mpsnerf_torch.ops.grid_sample import index_features_patch

    with torch.no_grad():
        lat = scene["t_model"].encode(scene["t_inp"]["img_all"])
    assert lat.shape == tuple(np.asarray(scene["latent"]).shape)
    assert lat.is_contiguous(memory_format=torch.channels_last)
    assert lat.stride(1) == 1
    np.testing.assert_allclose(np.asarray(scene["latent"]), lat.numpy(),
                               atol=1e-4)
    uv = torch.rand(lat.shape[0], 50, 2,
                    generator=torch.Generator().manual_seed(0)) * 64
    torch.testing.assert_close(
        index_features_patch(lat, uv, (64.0, 64.0)),
        index_features_patch(lat.contiguous(), uv, (64.0, 64.0)),
        rtol=0, atol=0)


@pytest.mark.parametrize("out_views", [None, 2])
def test_transformer(out_views):
    """atol 1e-5: LayerNorm statistics and softmax in fp32 (flax takes
    E[x^2] - E[x]^2, torch two passes)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 257, 155)).astype(np.float32)
    jt = JTransformer(dim=155)
    v = jt.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tt = TTransformer(dim=155).eval()
    tt.load_state_dict(
        transformer_state_dict(jax.tree.map(np.asarray, v["params"])),
        strict=True)
    j = jt.apply(v, jnp.asarray(x), out_views=out_views)
    with torch.no_grad():
        t = tt(torch.from_numpy(x), out_views=out_views)
    assert t.shape == ((out_views or 3), 257, 155)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-5)


def _query_points(scene, n=2048, seed=0):
    rng = np.random.default_rng(seed)
    verts = np.asarray(scene["j_inp"]["vertices"])
    near = verts[rng.integers(0, len(verts), n // 2)] \
        + rng.normal(size=(n // 2, 3)) * 0.05
    lo, hi = verts.min(0) - 0.2, verts.max(0) + 0.2
    far = rng.uniform(lo, hi, size=(n - n // 2, 3))
    pts = np.concatenate([near, far]).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return pts, vd


@pytest.mark.parametrize("branch", ["nn_ids", "body_grid", "single_phase"])
def test_query_branches(scene, branch, monkeypatch):
    """All three branches of MPSNeRF.query: rgb and sigma at atol 1e-4
    (the tail stacks convolutions, the transformer and an 8-layer MLP in
    fp32), pts_mask and n_dropped exact; on the CPU no branch builds 1-NN
    buckets (the brute force reads none)."""
    from mpsnerf_torch.ops import knn as t_knn

    def no_build(verts):
        raise AssertionError("buckets built for a CPU table")

    monkeypatch.setattr(t_knn, "build_vertex_buckets_plain", no_build)
    pts, vd = _query_points(scene)
    model, variables = scene["model"], scene["variables"]
    j_inp, t_inp = scene["j_inp"], scene["t_inp"]
    t_model = scene["t_model"]
    nn_ids = None
    if branch == "nn_ids":
        ids = np.random.default_rng(1).integers(0, 600, len(pts))
        nn_ids = ids
    if branch == "single_phase":
        j_inp = {k: v for k, v in j_inp.items() if k != "body_grid"}
        t_inp = {k: v for k, v in t_inp.items() if k != "body_grid"}
    j = model.apply(
        variables, scene["j_smpl"], j_inp, j_inp, scene["latent"],
        jnp.asarray(pts), jnp.asarray(vd), train=False,
        nn_ids=None if nn_ids is None else jnp.asarray(nn_ids, jnp.int32),
        method=JMPSNeRF.query,
    )
    with torch.no_grad():
        lat = t_model.encode(t_inp["img_all"])
        t = t_model.query(
            scene["t_smpl"], t_inp, t_inp, lat, torch.from_numpy(pts),
            torch.from_numpy(vd),
            nn_ids=None if nn_ids is None else torch.from_numpy(nn_ids),
        )
    np.testing.assert_array_equal(np.asarray(j.pts_mask), t.pts_mask.numpy())
    assert int(j.n_dropped) == int(t.n_dropped)
    mask = t.pts_mask.numpy() > 0
    if branch != "nn_ids":
        assert 0.05 < mask.mean() < 0.95
    np.testing.assert_allclose(np.asarray(j.rgb), t.rgb.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(j.sigma), t.sigma.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(j.smpl_src_pts),
                               t.smpl_src_pts.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(j.bweights), t.bweights.numpy(),
                               atol=1e-6)


def test_load_smpl_pickle_matches_jax(tmp_path):
    """A SMPL pickle with a scipy-sparse regressor and the uint32 root
    sentinel loads to the same rig in both packages."""
    import pickle

    import scipy.sparse

    from mpsnerf_tpu.smpl.model import load_smpl_pickle as j_load
    from mpsnerf_torch.smpl.model import load_smpl_pickle as t_load

    rig = j_synthetic_smpl(n_verts=300, seed=4)
    kintree = np.stack([np.asarray(rig.parents, np.int64),
                        np.arange(24, dtype=np.int64)])
    kintree[0, 0] = 4294967295
    path = tmp_path / "smpl.pkl"
    with open(path, "wb") as f:
        pickle.dump({
            "v_template": np.asarray(rig.v_template, np.float64),
            "shapedirs": np.asarray(rig.shapedirs, np.float64),
            "posedirs": np.asarray(rig.posedirs, np.float64),
            "J_regressor": scipy.sparse.csc_matrix(
                np.asarray(rig.J_regressor, np.float64)),
            "weights": np.asarray(rig.weights, np.float64),
            "f": np.asarray(rig.faces, np.uint32),
            "kintree_table": kintree,
        }, f)
    j = j_load(str(path))
    t = t_load(str(path), device="cpu")
    for f_ in ("v_template", "shapedirs", "posedirs", "J_regressor",
               "weights", "faces"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f_)),
                                      getattr(t, f_).numpy(), err_msg=f_)
    assert t.parents == tuple(j.parents) and t.parents[0] == 0
