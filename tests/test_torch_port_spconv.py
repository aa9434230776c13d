"""Parity of the port's parts of the correction and skinning fields with
the JAX package, on the CPU: ``build_plan``'s tables, ``SparseConvNet3D``
in eval and train mode with its BatchNorm statistics, ``DeformField``,
the LBS with a blend-weight correction and with ``mean_shape``, the loss
terms with the pair pose gate, ``grid_sample_3d``.  Inputs are seeded with
numpy; weights cross over through ``mpsnerf_torch.compat.from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu.data.synthetic import SyntheticHumanDataset as JDataset
from mpsnerf_tpu.models import sparse_conv as j_sc
from mpsnerf_tpu.models.deform import DeformField as JDeformField
from mpsnerf_tpu.ops.grid_sample import grid_sample_3d as j_grid_sample_3d
from mpsnerf_tpu.smpl import lbs as j_lbs
from mpsnerf_tpu.train import losses as j_losses

from mpsnerf_torch.compat.from_jax import (
    deform_state_dict,
    encoder_3d_state_dict,
)
from mpsnerf_torch.models import sparse_conv as t_sc
from mpsnerf_torch.models.deform import DeformField as TDeformField
from mpsnerf_torch.ops.grid_sample import grid_sample_3d
from mpsnerf_torch.smpl import lbs as t_lbs
from mpsnerf_torch.smpl.model import synthetic_smpl
from mpsnerf_torch.train import losses as t_losses

from tests.test_torch_port_train import _raw
from tests.test_torch_port_variants import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def item():
    ds = JDataset(n_poses=1, n_cameras=2, image_size=32, n_verts=800,
                  num_instances=1)
    return ds.get_item(0, instance_idx=0)


@pytest.mark.parametrize("grid", ["posed", "canonical"])
def test_build_plan_equals_jax(item, grid):
    """Every table bit-equal, on the posed and the canonical voxel grid of
    an 800-vertex rig, with three coordinates listed twice (a voxel that
    holds two vertices: the later row wins)."""
    pre = "" if grid == "posed" else "t_"
    coord, out_sh = item[pre + "coord"], item[pre + "out_sh"]
    coord = np.concatenate([coord, coord[[5, 77, 5]]])
    j = j_sc.build_plan(coord, out_sh)
    t = t_sc.build_plan(coord, out_sh)
    assert int(t.n_fine) == len(coord) and int(t.n_coarse) > len(coord)
    for f in j_sc.SparseConvPlan._fields:
        a, b = np.asarray(getattr(j, f)), np.asarray(getattr(t, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _encoder_inputs(item, n=700, seed=0):
    rng = np.random.default_rng(seed)
    plan = j_sc.build_plan(item["coord"], item["out_sh"])
    feats = item["feature"].astype(np.float32)
    b = item["bounds"]
    pts = item["feature"][rng.integers(0, len(feats), n)] \
        + rng.normal(size=(n, 3)) * 0.02
    q = ((pts - 0.5 * (b[0] + b[1])) / (0.5 * (b[1] - b[0]))).astype(
        np.float32)
    q[:20] = rng.uniform(-1.3, 1.3, (20, 3))  # some outside the grid
    return plan, feats, q


@pytest.mark.parametrize("train", [False, True])
def test_sparse_conv_net_matches_jax(item, train):
    """The encoder's (Nq, 32) features at 1e-5 of their max, in eval mode
    (non-trivial running statistics) and in train mode (masked batch
    statistics), twice in a row in train mode as a query's two calls do,
    the running statistics after each call at 1e-6."""
    plan, feats, q = _encoder_inputs(item)
    net = j_sc.SparseConvNet3D()
    shapes = jax.eval_shape(lambda k: net.init(
        k, jnp.asarray(feats), plan, jnp.asarray(q)), jax.random.PRNGKey(0))
    variables = random_variables(shapes)
    t_net = t_sc.SparseConvNet3D()
    t_net.load_state_dict(encoder_3d_state_dict(
        variables["params"], variables["batch_stats"]), strict=True)
    t_net.train(train)
    t_plan = t_sc.plan_to(t_sc.build_plan(item["coord"], item["out_sh"]),
                          "cpu")

    @jax.jit
    def run(v, f, p):
        if not train:
            return net.apply(v, f, plan, p), v["batch_stats"]
        out, mut = net.apply(v, f, plan, p, train=True,
                             mutable=["batch_stats"])
        return out, mut["batch_stats"]

    v = variables
    for call in range(2 if train else 1):
        j_out, stats = run(v, jnp.asarray(feats), jnp.asarray(q))
        v = {"params": v["params"], "batch_stats": stats}
        t_out = t_net(torch.from_numpy(feats), t_plan, torch.from_numpy(q))
        a, b = np.asarray(j_out), t_out.detach().numpy()
        assert a.shape == (len(q), 32) and np.abs(a[:20]).max() < np.abs(
            a).max()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), call
        want = encoder_3d_state_dict(v["params"], _np(stats))
        for name, x in t_net.state_dict().items():
            if "running" in name:
                np.testing.assert_allclose(x.numpy(), want[name].numpy(),
                                           atol=1e-6, err_msg=name)
        moved = not np.allclose(
            t_net.conv1[4].running_mean.numpy(),
            np.asarray(variables["batch_stats"]["conv1_bn1"]["BatchNorm_0"]
                       ["mean"]))
        assert moved == train


@pytest.mark.parametrize("deform_type,depth,in_ch,out_ch", [
    ("correction", 2, 199, 3), ("correction", 4, 271, 3),
    ("weights", 4, 167, 24)])
def test_deform_field_matches_jax(deform_type, depth, in_ch, out_ch):
    """The three fields' shapes: outputs at 1e-6; the weights field's rows
    sum to 1; the correction field's zero init gives 0."""
    x = np.random.default_rng(1).normal(size=(300, in_ch)).astype(np.float32)
    field = JDeformField(depth=depth, out_ch=out_ch, deform_type=deform_type)
    v = field.init(jax.random.PRNGKey(3), jnp.asarray(x))
    t = TDeformField(in_ch, depth=depth, out_ch=out_ch,
                     deform_type=deform_type)
    if deform_type == "correction":
        with torch.no_grad():
            assert float(torch.abs(t(torch.from_numpy(x))).max()) == 0.0
    v = random_variables(jax.eval_shape(lambda: v))
    t.load_state_dict(deform_state_dict(v["params"]), strict=True)
    a = np.asarray(field.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        b = t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(a, b, atol=1e-6)
    if deform_type == "weights":
        np.testing.assert_allclose(b.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("mean_shape", [False, True])
def test_lbs_with_weights_correction_matches_jax(mean_shape):
    """Both warps at ``mean_shape`` 0 and 1, the forward warp with a
    softmax blend-weight correction (``bw + 0.2 * corr``, renormalised):
    points at 1e-5, blend weights at 1e-6 with rows summing to 1."""
    from mpsnerf_tpu.smpl.model import synthetic_smpl as j_synthetic_smpl

    j_smpl = j_synthetic_smpl(n_verts=800, seed=2)
    t_smpl = synthetic_smpl(n_verts=800, seed=2, device="cpu")
    rng = np.random.default_rng(4)
    params = {"poses": rng.normal(size=72) * 0.2,
              "shapes": rng.normal(size=10) * 0.5,
              "R": np.eye(3), "Th": rng.normal(size=3) * 0.1}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    jtf = j_lbs.PoseTransforms.create(
        j_smpl, {k: jnp.asarray(v) for k, v in params.items()})
    ttf = t_lbs.PoseTransforms.create(
        t_smpl, {k: torch.from_numpy(v) for k, v in params.items()})
    ids = rng.integers(0, 800, 600)
    pts = (np.asarray(j_smpl.v_template)[ids]
           + rng.normal(size=(600, 3)) * 0.02).astype(np.float32)
    logits = rng.normal(size=(600, 24)).astype(np.float32)
    corr = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    j_can = j_lbs.deform_target_to_canonical(
        j_smpl, jtf, jnp.asarray(pts), jnp.asarray(ids), mean_shape)
    t_can = t_lbs.deform_target_to_canonical(
        t_smpl, ttf, torch.from_numpy(pts), torch.from_numpy(ids),
        mean_shape)
    np.testing.assert_allclose(np.asarray(j_can), t_can.numpy(), atol=1e-5)
    j_out = j_lbs.deform_canonical_to_source(
        j_smpl, jtf, j_can, jnp.asarray(ids), jnp.asarray(corr), mean_shape)
    t_out = t_lbs.deform_canonical_to_source(
        t_smpl, ttf, t_can, torch.from_numpy(ids), mean_shape,
        torch.from_numpy(corr))
    for a, b in zip(j_out[:2], t_out[:2]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(j_out[2]), t_out[2].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(t_out[2].numpy().sum(-1), 1.0, atol=1e-6)
    plain = t_lbs.deform_canonical_to_source(
        t_smpl, ttf, t_can, torch.from_numpy(ids), mean_shape)
    assert float(torch.abs(plain[2] - t_out[2]).max()) > 1e-3


@pytest.mark.parametrize("same_pose", [True, False])
def test_losses_with_every_term_and_the_pose_gate(same_pose):
    """Every term on, with the smooth pair, under the pair gate: at 1e-6;
    across poses the image term is 0 and ``img_raw`` is the true MSE."""
    rng = np.random.default_rng(9)
    r, n = 16, 64
    rgb, tgt = (rng.uniform(size=(r, 3)).astype(np.float32) for _ in "ab")
    acc = rng.uniform(size=r).astype(np.float32)
    bk = (rng.uniform(size=(r, 1)) < 0.7).astype(np.float32)
    opts = dict(use_acc_loss=True, use_correction_loss=True,
                use_consistency_loss=True, use_density_loss=True)
    j = j_losses.compute_losses(
        *map(jnp.asarray, (rgb, acc, tgt, bk)),
        _raw(np.random.default_rng(5), n, True),
        _raw(np.random.default_rng(6), n, True),
        pose_match=jnp.asarray(same_pose), **opts)
    t = t_losses.compute_losses(
        *map(torch.from_numpy, (rgb, acc, tgt, bk)),
        _raw(np.random.default_rng(5), n, False),
        _raw(np.random.default_rng(6), n, False),
        pose_match=torch.tensor(same_pose), **opts)
    for f in j._fields:
        np.testing.assert_allclose(float(getattr(j, f)),
                                   float(getattr(t, f)), atol=1e-6,
                                   err_msg=f)
    assert (float(t.img) == float(t.img_raw) > 0) == same_pose
    assert same_pose or float(t.img) == 0.0


def test_grid_sample_3d_matches_jax():
    """Trilinear samples of a (5, 6, 7, 8) volume at 500 coords, some
    outside (zero padding) and some on the border: at 1e-6."""
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(5, 6, 7, 8)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    coords[:10] = 1.0
    coords[10:20] = -1.0
    a = np.asarray(j_grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords)))
    b = grid_sample_3d(torch.from_numpy(vol), torch.from_numpy(coords))
    assert b.shape == (5, 500)
    np.testing.assert_allclose(a, b.numpy(), atol=1e-6)
    assert np.abs(a[:, 40:]).max() > 0 and (np.abs(coords) > 1).any()
