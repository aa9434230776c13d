"""Parity of the PyTorch port's training path with the JAX package, on the
CPU: the train-split data and ray sampler, train-mode BatchNorm, the
occupancy normals, the losses, the plain and smooth view-step gradients,
Adam, the trainer's cadence and checkpoints.  The scene is the 400-vertex
rig of ``tests/test_train.py`` at 64^2 with 32 rays per view and 8 samples;
weights come from the JAX package's init through
``mpsnerf_torch.compat.from_jax``."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpsnerf_tpu.data.synthetic import (
    SyntheticHumanDataset as JDataset,
    _ring_camera,
)
from mpsnerf_tpu.models.mps_nerf import MPSNeRF as JMPSNeRF
from mpsnerf_tpu.models.mps_nerf import RawOutput as JRawOutput
from mpsnerf_tpu.rays import rays as j_rays
from mpsnerf_tpu.train import losses as j_losses
from mpsnerf_tpu.train import trainer as j_trainer

from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.data import to_device_input
from mpsnerf_torch.data.synthetic import SyntheticHumanDataset as TDataset
from mpsnerf_torch.models.mps_nerf import MPSNeRF as TMPSNeRF
from mpsnerf_torch.models.mps_nerf import RawOutput as TRawOutput
from mpsnerf_torch.rays import rays as t_rays
from mpsnerf_torch.smpl.model import synthetic_smpl
from mpsnerf_torch.train import checkpoint as t_ckpt
from mpsnerf_torch.train import losses as t_losses
from mpsnerf_torch.train import trainer as t_trainer

N_SAMPLES = 8
N_RAYS = 32
KW = dict(n_poses=1, n_cameras=4, image_size=64, n_rays=N_RAYS, n_verts=400,
          num_instances=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def scene():
    ds = JDataset(**KW)
    item = ds.get_item(0, instance_idx=0)
    j_smpl = ds.smpl_for(0)
    inp = j_trainer.to_device_input(item)
    model = JMPSNeRF(num_instances=1)
    variables = model.init(
        {"params": jax.random.PRNGKey(0)}, j_smpl, inp, inp,
        jnp.zeros((8, 3)), jnp.zeros((8, 3)), train=False,
    )
    # the model-level tests feed the JAX item's arrays to both packages:
    # the port's own item differs by fp32 posing (~2e-7), and the random
    # faces of the synthetic rig include near-degenerate triangles whose
    # normals turn by much more under such a change
    return dict(model=model, variables=variables, vnp=_np(variables),
                j_smpl=j_smpl, inp=inp,
                t_smpl=synthetic_smpl(n_verts=400, seed=0, device="cpu"),
                t_inp=to_device_input(item, "cpu", rays=True))


def _port_model(scene):
    m = TMPSNeRF()
    m.load_state_dict(from_jax(scene["vnp"]), strict=True)
    return m


def test_train_split_items_and_rays_match():
    """The same seed gives the same train items: rays, pixel picks and
    masks exact (the same numpy draws in the same order), colours and
    depths to 1e-5 (fp32 posing in another library), over two items."""
    j, t = JDataset(**KW), TDataset(split="train", **KW)
    for _ in range(2):
        a, b = j.get_item(0), t.get_item(0)
        assert set(a) == set(b)
        for k in ("ray_o_all", "ray_d_all", "bkgd_msk_all",
                  "mask_at_box_all", "K_all", "R_all", "T_all"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("rgb_all", "near_all", "far_all", "img_all", "msk_all"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
        assert b["rgb_all"].shape == (4, N_RAYS, 3)


def test_sample_rays_batch_train_identical():
    """``sample_rays_batch(split="train")`` returns the JAX package's rays
    exactly under the same seed (body/background picks, resampling)."""
    rng_img = np.random.default_rng(3)
    H = W = 48
    K, R, T = _ring_camera(0.7, 2.2, 0.1, H, W)
    img = rng_img.uniform(size=(H, W, 3)).astype(np.float32)
    msk = np.zeros((H, W), np.float32)
    msk[12:36, 18:30] = 1.0
    bounds = np.array([[-0.4, -0.6, -0.3], [0.4, 0.6, 0.3]], np.float32)
    a = j_rays.sample_rays_batch(img, msk, K, R, T, bounds, 100, "train",
                                 rng=np.random.default_rng(11))
    b = t_rays.sample_rays_batch(img, msk, K, R, T, bounds, 100, "train",
                                 rng=np.random.default_rng(11))
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.ray_o.shape == (100, 3) and 0 < a.bkgd_msk.mean() < 1


def _random_box_in_front(rng):
    H = W = int(rng.choice([64, 128, 512]))
    K, R, T = _ring_camera(rng.uniform(0, 2 * np.pi), rng.uniform(1.6, 3.5),
                           rng.uniform(-0.5, 0.5), H, W)
    c = rng.uniform(-0.5, 0.5, 3)
    e = rng.uniform(0.05, 0.7, 3)
    return np.stack([c - e, c + e]), K, np.concatenate([R, T], 1), H, W


def test_bound_2d_mask_equals_cv2():
    """The numpy rasteriser gives ``cv2.fillPoly``'s mask exactly, on every
    camera of the synthetic set (64^2 and 512^2) and on 100 seeded random
    boxes (some leaving the image)."""
    cases = []
    for size in (64, 512):
        ds = TDataset(n_poses=1, n_cameras=6, image_size=size, n_verts=400)
        item = ds.get_item(0, instance_idx=0)
        v = item["vertices"]
        bounds = np.stack([v.min(0) - 0.05, v.max(0) + 0.05])
        for K, R, T in ds.cameras:
            cases.append((bounds, K, np.concatenate([R, T], 1), size, size))
    rng = np.random.default_rng(0)
    cases += [_random_box_in_front(rng) for _ in range(100)]
    clipped = 0
    for bounds, K, pose, H, W in cases:
        a = j_rays.get_bound_2d_mask(bounds, K, pose, H, W)
        b = t_rays.get_bound_2d_mask(bounds, K, pose, H, W)
        assert b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        clipped += bool(a[0].any() or a[-1].any() or a[:, 0].any()
                        or a[:, -1].any())
    assert clipped >= 5  # the border clipping is exercised


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_poly_equals_cv2_on_convex_polygons(seed):
    """Random convex polygons inside the image, with and without a
    repeated closing vertex.  (Polygons that leave the image: the box
    masks above and the tests below.)"""
    rng = np.random.default_rng(seed)
    for t in range(150):
        H, W = int(rng.integers(8, 90)), int(rng.integers(8, 90))
        n = int(rng.integers(3, 9))
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        c = rng.uniform(0.2, 0.8, 2) * (W, H)
        r = rng.uniform(1, min(c[0], c[1], W - 1 - c[0], H - 1 - c[1]))
        pts = np.round(c + r * np.stack([np.cos(ang), np.sin(ang)], 1)
                       ).astype(np.int64)
        if t % 2:
            pts = np.concatenate([pts, pts[:1]])
        a = np.zeros((H, W), np.uint8)
        cv2.fillPoly(a, [pts.astype(np.int32)], 1)
        b = t_rays.fill_poly(np.zeros((H, W), np.uint8), [pts], 1)
        np.testing.assert_array_equal(a, b, err_msg=str(pts.tolist()))


def _fill_both(pts, H, W):
    pts = np.asarray(pts, np.int64)
    a = np.zeros((H, W), np.uint8)
    cv2.fillPoly(a, [pts.astype(np.int32)], 1)
    return a, t_rays.fill_poly(np.zeros((H, W), np.uint8), [pts], 1)


@pytest.mark.parametrize("pts", [
    [[18, -15], [-40, 22], [67, 2], [82, -12], [-20, 16]],
    [[11, 20], [-8, 75], [0, 23]],
    [[91, 11], [46, 97], [-26, 100]],
])
def test_fill_poly_equals_cv2_where_a_side_touches_the_border(pts):
    """Polygons with a side whose clipped ends fall on one point of the
    border: OpenCV runs that side's edge at the clipped x, so it fills a
    border column the unclipped edge would leave empty (column 0, rows
    1-10 of the first polygon, rows 53-63 of the second; column 63, rows
    11-31 of the third)."""
    a, b = _fill_both(pts, 64, 64)
    assert (a[:, 0].any() or a[:, -1].any())
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_poly_equals_cv2_on_polygons_leaving_the_image(seed):
    """150 seeded random polygons of 3-6 vertices per seed, self-intersecting
    ones included, with vertices far outside a 64^2 or a 48x80 image."""
    rng = np.random.default_rng(100 + seed)
    left = 0
    for t in range(150):
        H, W, lo, hi = ((64, 64, -40, 104), (48, 80, -100, 180))[t % 2]
        pts = rng.integers(lo, hi, (int(rng.integers(3, 7)), 2))
        a, b = _fill_both(pts, H, W)
        left += bool(((pts < 0) | (pts >= (W, H))).any())
        np.testing.assert_array_equal(a, b, err_msg=str(pts.tolist()))
    assert left >= 140


def test_train_mode_encode_updates_batch_stats_like_flax(scene):
    """Train-mode encode: the output and the moved running statistics
    against flax's ``mutable=["batch_stats"]``.  The running variance is
    the biased batch variance (torch's own BatchNorm2d would move it by
    n/(n-1)).  atol 1e-5 on the statistics (means of O(1) values in fp32);
    the output at 1e-4 (fp32 convolutions in two libraries, as in
    test_torch_port_model.py)."""
    model, variables = scene["model"], scene["variables"]
    imgs = scene["inp"]["img_all"]
    j_out, mutated = model.apply(variables, imgs, train=True,
                                 mutable=["batch_stats"], method="encode")
    t_model = _port_model(scene).train()
    t_out = t_model.encode(torch.from_numpy(np.array(imgs)))
    np.testing.assert_allclose(np.asarray(j_out), t_out.detach().numpy(),
                               atol=1e-4)
    want = from_jax({"params": scene["vnp"]["params"],
                     "batch_stats": _np(mutated["batch_stats"])})
    sd = t_model.state_dict()
    moved = 0
    for name in sd:
        if "running" in name:
            np.testing.assert_allclose(sd[name].numpy(), want[name].numpy(),
                                       atol=1e-5, err_msg=name)
            moved += not np.allclose(want[name].numpy(),
                                     from_jax(scene["vnp"])[name].numpy())
    assert moved > 10


def test_query_normals_match_jax(scene):
    """``query(compute_normals=True)``: the occupancy normal (a gradient
    of the tail, normalised) and the nearest SMPL vertex normal at atol
    1e-4 (the fp32 tail differentiated in two libraries), pts_mask
    exact."""
    model, variables = scene["model"], scene["variables"]
    inp, t_inp = scene["inp"], scene["t_inp"]
    rng = np.random.default_rng(2)
    v = np.asarray(inp["vertices"])
    pts = (v[rng.integers(0, len(v), 512)]
           + rng.normal(size=(512, 3)) * 0.03).astype(np.float32)
    vd = rng.normal(size=(512, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    latent = model.apply(variables, inp["img_all"], method="encode")
    j, _ = model.apply(variables, scene["j_smpl"], inp, inp, latent,
                       jnp.asarray(pts), jnp.asarray(vd), train=True,
                       compute_normals=True, method="query",
                       mutable=["batch_stats"])
    t_model = _port_model(scene).eval()
    t_lat = t_model.encode(t_inp["img_all"])
    t = t_model.query(scene["t_smpl"], t_inp, t_inp, t_lat,
                      torch.from_numpy(pts), torch.from_numpy(vd),
                      compute_normals=True)
    np.testing.assert_array_equal(np.asarray(j.pts_mask), t.pts_mask.numpy())
    mask = t.pts_mask.numpy() > 0
    assert mask.mean() > 0.5
    for f in ("occ_normal", "nearest_smpl_normal", "sigma"):
        np.testing.assert_allclose(np.asarray(getattr(j, f)),
                                   getattr(t, f).detach().numpy(),
                                   atol=1e-4, err_msg=f)
    norms = np.linalg.norm(t.occ_normal.detach().numpy()[mask], axis=-1)
    assert (np.abs(norms - 1) < 1e-4).mean() > 0.9
    assert t.occ_normal.requires_grad  # the smooth loss differentiates it
    assert tuple(TRawOutput._fields) == tuple(JRawOutput._fields)


def _raw(rng, n, jax_side):
    f = {
        "rgb": rng.normal(size=(n, 3)), "sigma": rng.normal(size=n),
        "pts_mask": (rng.uniform(size=n) < 0.6).astype(np.int32),
        "correction": rng.normal(size=(n, 3)),
        "correction_": rng.normal(size=(n, 3)),
        "smpl_query_pts": rng.normal(size=(n, 3)),
        "smpl_src_pts": rng.normal(size=(n, 3)),
        "occ_normal": rng.normal(size=(n, 3)),
        "nearest_smpl_normal": rng.normal(size=(n, 3)),
        "world_src_pts": rng.normal(size=(n, 3)),
        "bweights": rng.uniform(size=(n, 24)), "n_dropped": np.int32(3),
    }
    f = {k: np.asarray(v).astype(np.int32 if k in ("pts_mask", "n_dropped")
                                 else np.float32) for k, v in f.items()}
    if jax_side:
        return JRawOutput(**{k: jnp.asarray(v) for k, v in f.items()})
    return TRawOutput(**{k: torch.from_numpy(np.array(v)) for k, v in
                         f.items()})


@pytest.mark.parametrize("smooth", [False, True])
def test_compute_losses(smooth):
    """Every loss term, every option on, at atol 1e-6 (fp32 means)."""
    rng = np.random.default_rng(4)
    r, n = 16, 64
    rgb = rng.uniform(size=(r, 3)).astype(np.float32)
    acc = rng.uniform(size=r).astype(np.float32)
    tgt = rng.uniform(size=(r, 3)).astype(np.float32)
    bk = (rng.uniform(size=(r, 1)) < 0.7).astype(np.float32)
    opts = dict(use_acc_loss=True, use_correction_loss=True,
                use_consistency_loss=True, use_density_loss=True)
    j = j_losses.compute_losses(
        *map(jnp.asarray, (rgb, acc, tgt, bk)),
        _raw(np.random.default_rng(5), n, True),
        _raw(np.random.default_rng(6), n, True) if smooth else None, **opts)
    t = t_losses.compute_losses(
        *map(torch.from_numpy, (rgb, acc, tgt, bk)),
        _raw(np.random.default_rng(5), n, False),
        _raw(np.random.default_rng(6), n, False) if smooth else None, **opts)
    assert j._fields == t._fields
    for f in j._fields:
        np.testing.assert_allclose(float(getattr(j, f)),
                                   float(getattr(t, f)), atol=1e-6,
                                   err_msg=f)
    assert (float(t.normal_smooth) > 0) == smooth
    np.testing.assert_allclose(
        float(j_losses.mse2psnr(jnp.float32(0.01))),
        float(t_losses.mse2psnr(torch.tensor(0.01))), atol=1e-5)


@pytest.mark.parametrize("smooth,grad_tol", [(False, 1e-4), (True, 1e-3)])
def test_view_step_loss_and_gradients_match_jax(scene, smooth, grad_tol,
                                                monkeypatch):
    """One plain and one smooth view-step with perturb 0 and the JAX
    package's own smooth delta (``0.01 * normal(split(key, 3)[1])``): loss
    terms at atol 1e-5 and every parameter gradient within ``grad_tol``
    of its tensor's max |grad| (fp32 forward and double backward through
    the transformer and MLP summed in another order); the BN statistics
    after the step at 1e-5.  The latent's K2 backward computes only what
    the step uses: the plain step's one call no coordinate gradient, the
    smooth step's inner normal gradients no image scatter."""
    from mpsnerf_torch.ops import grid_sample as t_gs

    seen = []
    plain_bwd = t_gs.grid_sample_patch_backward_plain

    def spy(g, image, coords, need_image, need_coords):
        if image.shape[1] > 3:
            seen.append((need_image, need_coords))
        return plain_bwd(g, image, coords, need_image, need_coords)

    monkeypatch.setattr(t_gs, "grid_sample_patch_backward_plain", spy)
    model, variables, inp = scene["model"], scene["variables"], scene["inp"]
    cfg = j_trainer.TrainConfig(n_samples=N_SAMPLES, perturb=0.0)
    key = jax.random.PRNGKey(5)
    rays = (inp["ray_o_all"][0], inp["ray_d_all"][0], inp["near_all"][0][:, 0],
            inp["far_all"][0][:, 0], inp["rgb_all"][0], inp["bkgd_msk_all"][0])
    loss = j_trainer.make_loss_fn(model, cfg, smooth)
    grads, (terms, new_bs, _) = jax.grad(
        lambda p: loss(p, variables["batch_stats"], scene["j_smpl"], inp,
                       inp, *rays, key), has_aux=True)(variables["params"])
    delta = 0.01 * jax.random.normal(jax.random.split(key, 3)[1],
                                     (N_RAYS * N_SAMPLES, 3), jnp.float32)

    t_model = _port_model(scene)
    t_inp = scene["t_inp"]
    t_loss = t_trainer.make_loss_fn(
        t_model, t_trainer.TrainConfig(n_samples=N_SAMPLES, perturb=0.0),
        smooth)
    total, (t_terms, _) = t_loss(
        scene["t_smpl"], t_inp, t_inp, *t_trainer.train_rays(t_inp, 0, "cpu"),
        delta=torch.from_numpy(np.asarray(delta)))
    total.backward()
    assert seen == ([(False, True)] * 2 + [(True, True)] * 2 if smooth
                    else [(True, False)])
    for f in terms._fields:
        np.testing.assert_allclose(float(getattr(terms, f)),
                                   float(getattr(t_terms, f).detach()),
                                   atol=1e-5,
                                   err_msg=f)
    assert (float(t_terms.smpl_normal) > 0) == smooth
    want = from_jax({"params": _np(grads),
                     "batch_stats": scene["vnp"]["batch_stats"]})
    for name, p in t_model.named_parameters():
        g = want[name].numpy()
        err = np.abs(p.grad.numpy() - g).max() / max(np.abs(g).max(), 1e-30)
        assert err <= grad_tol, (name, err)
    stats = from_jax({"params": scene["vnp"]["params"],
                      "batch_stats": _np(new_bs)})
    sd = t_model.state_dict()
    for name in sd:
        if "running" in name:
            np.testing.assert_allclose(sd[name].numpy(), stats[name].numpy(),
                                       atol=1e-5, err_msg=name)


def test_adam_step_matches_optax_on_the_same_gradients():
    """The trainer's Adam with the lr from ``lr_at_step`` equals
    ``optax.scale_by_adam`` scaled by the JAX package's ``lr_at_step``, on
    the same gradients over two steps, at atol 1e-7 on weights below 0.1
    (updates of ~lr rounded in another order).  (One Adam step is
    close to lr * sign(g), so parameters after a step are no parity
    measure of the gradients themselves.)"""
    rng = np.random.default_rng(8)
    shapes = {"a": (7, 5), "b": (11,)}
    # weights of the size of the MLP's (|w| < 0.1, an ulp < 1e-8)
    p0 = {k: rng.uniform(-0.1, 0.1, size=s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 1e-3
              for k, s in shapes.items()} for _ in range(2)]
    cfg_j = j_trainer.TrainConfig(decay_steps=100)
    cfg_t = t_trainer.TrainConfig(decay_steps=100)
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in p0.items()})
    opt = t_trainer.make_optimizer(module, cfg_t)
    tx = optax.scale_by_adam(b1=0.9, b2=0.999)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for step, g in zip((0, 37), grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        lr = j_trainer.lr_at_step(cfg_j, step)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: -lr * u, upd))
        for k, v in g.items():
            module[k].grad = torch.from_numpy(v)
        for group in opt.param_groups:
            group["lr"] = t_trainer.lr_at_step(cfg_t, step)
        opt.step()
        assert t_trainer.lr_at_step(cfg_t, step) == float(lr)
    for k in shapes:
        np.testing.assert_allclose(module[k].detach().numpy(),
                                   np.asarray(jp[k]), atol=1e-7, rtol=0)


def test_trainer_cadence_lr_decay_and_logs(scene):
    """``train_item``: one view-step per output view, the smooth loss on
    every 4th step only, the lr decayed from the step counter, finite
    logs with nothing dropped, and parameters that move."""
    cfg = t_trainer.TrainConfig(n_samples=N_SAMPLES, decay_steps=10)
    trainer = t_trainer.Trainer(_port_model(scene), cfg, device="cpu",
                                start_step=3, seed=1)
    p0 = [p.detach().clone() for p in trainer.model.parameters()]
    logs = trainer.train_item(scene["t_smpl"], scene["t_inp"],
                              scene["t_inp"])
    assert trainer.global_step == 7
    smooth = [float(t.smpl_normal) > 0 for t, _ in trainer.last_logs]
    assert smooth == [False, True, False, False]  # steps 3, 4, 5, 6
    assert trainer.optimizer.param_groups[0]["lr"] == \
        t_trainer.lr_at_step(cfg, 6) == pytest.approx(5e-4 * 0.5 ** 0.6)
    assert logs["n_dropped"] == 0 and np.isfinite(logs["loss"])
    assert logs["smpl_normal_loss"] > 0
    moved = [not torch.equal(a, b) for a, b in
             zip(p0, trainer.model.parameters())]
    assert np.mean(moved) > 0.9


def test_overflow_signal(monkeypatch, capsys):
    monkeypatch.setenv("MPSNERF_TRAIN_OVERFLOW", "warn")
    t_trainer.check_train_overflow(2.0, 5)
    assert "compaction overflow" in capsys.readouterr().err
    monkeypatch.setenv("MPSNERF_TRAIN_OVERFLOW", "raise")
    with pytest.raises(RuntimeError, match="compaction overflow"):
        t_trainer.check_train_overflow(0.5, 5)
    t_trainer.check_train_overflow(0.0, 5)


def test_checkpoint_latest_restore_with_fresh_adam(scene, tmp_path):
    """``{step:06d}`` files under ``<basedir>/<expname>/checkpoints``; the
    newest one restores the weights and the step, and Adam restarts
    fresh unless asked; only the primary process writes."""
    cfg = t_trainer.TrainConfig(n_samples=N_SAMPLES, smooth_loss=False)
    trainer = t_trainer.Trainer(_port_model(scene), cfg, device="cpu")
    trainer.view_step(scene["t_smpl"], scene["t_inp"], scene["t_inp"], 0)
    base = str(tmp_path)
    assert t_ckpt.restore_latest(base, "exp") == (0, None)
    t_ckpt.save_checkpoint(base, "exp", 7, trainer.state())
    trainer.step = 12
    path = t_ckpt.save_checkpoint(base, "exp", 12, trainer.state())
    assert path.endswith("exp/checkpoints/000012")
    assert [s for s, _ in t_ckpt.list_checkpoints(base, "exp")] == [7, 12]
    assert t_ckpt.save_checkpoint(base, "other", 1, trainer.state(),
                                  is_primary=False) is None
    assert not (tmp_path / "other").exists()

    step, state = t_ckpt.restore_latest(base, "exp")
    fresh = t_trainer.Trainer(_port_model(scene), cfg, device="cpu")
    fresh.restore(state)
    assert step == 12 and fresh.global_step == 12
    for a, b in zip(fresh.model.state_dict().values(),
                    trainer.model.state_dict().values()):
        assert torch.equal(a, b)
    assert fresh.optimizer.state_dict()["state"] == {}
    fresh.restore(state, load_optimizer=True)
    assert len(fresh.optimizer.state_dict()["state"]) > 0
