"""Parity of the PyTorch port's eval entry point with the JAX package on the
CPU: ``sample_pdf``, the block renderer with the hierarchical pass and a
white background, ``render_rays_mapped``/``render_image``, the grid-only
global render, every ``ViewRenderer`` path, the metrics, the protocol's
files, ``run_synthetic_eval`` and the config parser.

Scene: the synthetic subject at 64^2 (4 ring cameras, 500 vertices), 8
samples per ray, ``n_importance`` 4.  Weights: the JAX model's, through
``from_jax``.  Tolerances: pixels at atol 1e-4 (each rendered sample runs
the fp32 tail, held at 1e-4 per raw value in test_torch_port_model.py,
and compositing sums a few of them; masks and plans are exact);
``sample_pdf`` z at 1e-5 plus its sensitivity to the fp32 CDF (see the
test); depth at 5e-4 (it sums z of 2-4 units, and the hierarchical z
inherit that sensitivity); SSIM in
float64 at 1e-12; protocol metrics at 1e-4 relative.
"""

import json
import os
import warnings

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu import config as j_config
from mpsnerf_tpu.data import attach_body_grid as j_attach_body_grid
from mpsnerf_tpu.data.synthetic import SyntheticHumanDataset as JDataset
from mpsnerf_tpu.eval import metrics as j_metrics
from mpsnerf_tpu.eval import protocol as j_protocol
from mpsnerf_tpu.eval import runner as j_runner
from mpsnerf_tpu.models.mps_nerf import MPSNeRF as JMPSNeRF
from mpsnerf_tpu.ops import composite as j_composite
from mpsnerf_tpu.renderer import render as j_render
from mpsnerf_tpu.train.trainer import to_device_input as j_to_device_input

from mpsnerf_torch import config as t_config
from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.data import attach_body_grid, to_device_input
from mpsnerf_torch.data.synthetic import SyntheticHumanDataset as TDataset
from mpsnerf_torch.eval import metrics as t_metrics
from mpsnerf_torch.eval import protocol as t_protocol
from mpsnerf_torch.eval import runner as t_runner
from mpsnerf_torch.models.mps_nerf import MPSNeRF as TMPSNeRF
from mpsnerf_torch.ops import composite as t_composite
from mpsnerf_torch.renderer import render as t_render
from mpsnerf_torch.smpl.model import synthetic_smpl

N_SAMPLES = 8
N_IMP = 4
N_VERTS = 500
VIEW = 1
CHUNK = 512
CONFIGS = ["canonical_transformer", "h36m", "synthetic_smoke"]


@pytest.fixture(scope="module")
def setup():
    ds = JDataset(n_poses=2, n_cameras=4, image_size=64, n_rays=32,
                  n_verts=N_VERTS, num_instances=1, split="test")
    items = [ds.get_item(i, instance_idx=0) for i in range(2)]
    smpl = ds.smpl_for(0)
    inp = j_to_device_input(items[0])
    model = JMPSNeRF(num_instances=1, compact_fraction=0.5)
    # jitted: one compile instead of ~20 s of op-by-op dispatch
    variables = jax.jit(lambda key: model.init(
        {"params": key}, smpl, inp, inp, jnp.zeros((8, 3)),
        jnp.zeros((8, 3)), train=False))(jax.random.PRNGKey(0))
    t_model = TMPSNeRF().eval()
    t_model.load_state_dict(from_jax(jax.tree.map(np.asarray, variables)))
    t_smpl = synthetic_smpl(n_verts=N_VERTS, seed=0, device="cpu")
    return dict(ds=ds, items=items, smpl=smpl, model=model,
                variables=variables, t_model=t_model, t_smpl=t_smpl,
                j_refs={})


def _fresh(item):
    """A copy of an item dict without any renderer's caches (each package
    caches its own device arrays, body grid and latent on the dict)."""
    return {k: v for k, v in item.items()
            if not k.startswith("_") and k != "body_grid"}


# ---- JAX references, one renderer (and one compile) per configuration ----

J_CONFIGS = {
    "global": dict(chunk=CHUNK, n_samples=N_SAMPLES,
                   eval_compact_fraction=0.5),
    "chunked": dict(chunk=CHUNK, n_samples=N_SAMPLES,
                    eval_compact_fraction=0.5, global_compact=False),
    "hier": dict(chunk=CHUNK, n_samples=N_SAMPLES, n_importance=N_IMP,
                 eval_compact_fraction=0.5, shuffle_rays=False),
}


def _j_renderer(s, name):
    key = ("renderer", name)
    if key not in s["j_refs"]:
        s["j_refs"][key] = j_runner.ViewRenderer(
            s["model"], lambda g: s["smpl"], **J_CONFIGS[name])
    return s["j_refs"][key]


def _j_ref(s, name, item=0, k=VIEW, masked=False):
    key = (name, item, k, masked)
    if key not in s["j_refs"]:
        it = s["items"][item]
        mask = (np.asarray(it["mask_at_box_all"][k]).reshape(-1)
                if masked else None)
        jit = _fresh(it)
        s["j_refs"][key] = _j_renderer(s, name).render_view(
            s["variables"], jit, jit, k, ray_mask=mask)
    return s["j_refs"][key]


def _t_renderer(s, **kw):
    return t_runner.ViewRenderer(s["t_model"], lambda g: s["t_smpl"],
                                 device="cpu", **kw)


# ---- sample_pdf -----------------------------------------------------------


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    """Deterministic (linspace01 draws) and with JAX's own uniform draws
    injected.  XLA's and torch's fp32 cumsum may differ by ~1e-6; z then
    moves by that over the draw's CDF step times the bin's width, so z is
    held to 1e-5 plus that much, except where a draw lies within 1e-6 of a
    CDF value (the other bin may be picked there): those are counted."""
    rng = np.random.default_rng(3)
    r, b, n = 256, 16, 24
    bins = np.sort(rng.uniform(0.5, 4.0, (r, b)), axis=-1).astype(np.float32)
    weights = (rng.uniform(0, 1, (r, b - 1)) ** 4).astype(np.float32)
    weights[::7] = 0.0  # rays with nothing in front: the 1e-5 floor
    key = jax.random.PRNGKey(4)
    j = np.asarray(j_composite.sample_pdf(key, jnp.asarray(bins),
                                          jnp.asarray(weights), n, det=det))
    u = None if det else torch.from_numpy(np.array(
        jax.random.uniform(key, (r, n), dtype=jnp.float32)))
    t = t_composite.sample_pdf(torch.from_numpy(bins),
                               torch.from_numpy(weights), n, det=det,
                               u=u).numpy()
    assert t.shape == (r, n)
    w = weights.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros((r, 1)), np.cumsum(
        w / w.sum(-1, keepdims=True), -1)], -1)
    uu = (np.broadcast_to(np.linspace(0, 1, n), (r, n)) if det
          else u.numpy().astype(np.float64))
    near_step = (np.abs(uu[:, :, None] - cdf[:, None, :]) < 1e-6).any(-1)
    inds = np.stack([np.searchsorted(c, x, side="right")
                     for c, x in zip(cdf, uu)])
    lo, hi = np.clip(inds - 1, 0, b - 1), np.clip(inds, 0, b - 1)
    step = np.take_along_axis(cdf, hi, -1) - np.take_along_axis(cdf, lo, -1)
    width = (np.take_along_axis(bins, hi, -1)
             - np.take_along_axis(bins, lo, -1))
    tol = 1e-5 + 2e-6 * width / np.maximum(step, 1e-5)
    bad = np.abs(t - j) > tol
    assert not (bad & ~near_step).any()
    # the exceptions: draws on a step (in det mode u = 0 and 1, the CDF's
    # ends, on every ray)
    assert near_step.mean() <= (2.5 / n if det else 0.01)
    # from a generator: the draws stay inside each ray's bins
    g = torch.Generator().manual_seed(0)
    z = t_composite.sample_pdf(torch.from_numpy(bins),
                               torch.from_numpy(weights), n, generator=g)
    assert ((z >= torch.from_numpy(bins[:, :1]) - 1e-6)
            & (z <= torch.from_numpy(bins[:, -1:]) + 1e-6)).all()


# ---- the model at another compaction fraction -----------------------------


@pytest.mark.parametrize("fraction", [None, 1e-6])
def test_query_at_another_compact_fraction_matches_jax(setup, fraction):
    """``with_compact_fraction`` shares the weights (nothing is copied)
    and its query equals JAX's ``model.clone(compact_fraction=...)``: None
    runs the single-phase 1-NN on every point without compaction; a tiny
    fraction overflows the 1024-slot floor and counts the drop."""
    s = setup
    it = _fresh(s["items"][0])
    j_attach_body_grid(it)
    t_it = _fresh(s["items"][0])
    attach_body_grid(t_it)
    inp = j_to_device_input({k: v for k, v in it.items()})
    t_inp = to_device_input(t_it, "cpu")
    rng = np.random.default_rng(0)
    pts = (np.asarray(it["vertices"])[rng.integers(0, N_VERTS, 3000)]
           + rng.normal(size=(3000, 3)) * 0.04).astype(np.float32)
    vd = np.tile(np.float32([[0, 0, 1]]), (3000, 1))
    jm = s["model"].clone(compact_fraction=fraction)
    latent = s["model"].apply(s["variables"], inp["img_all"],
                              method=JMPSNeRF.encode)
    j = jm.apply(s["variables"], s["smpl"], inp, inp, latent,
                 jnp.asarray(pts), jnp.asarray(vd), method="query")
    view = s["t_model"].with_compact_fraction(fraction)
    assert view.compact_fraction == fraction
    assert s["t_model"].compact_fraction == 0.5
    assert view.alpha_linear.weight is s["t_model"].alpha_linear.weight
    with torch.no_grad():
        t = view.query(s["t_smpl"], t_inp, t_inp,
                       view.encode(t_inp["img_all"]), torch.from_numpy(pts),
                       torch.from_numpy(vd))
    assert int(j.n_dropped) == int(t.n_dropped)
    assert (int(t.n_dropped) > 0) == (fraction is not None)
    np.testing.assert_array_equal(np.asarray(j.pts_mask), t.pts_mask.numpy())
    for name in ("rgb", "sigma"):
        np.testing.assert_allclose(np.asarray(getattr(j, name)),
                                   getattr(t, name).numpy(), atol=1e-4,
                                   err_msg=name)


# ---- the block renderer ---------------------------------------------------


@pytest.fixture(scope="module")
def block(setup):
    """Box-hit rays of view 1 (256 of them crossing the body), both
    packages' inputs and latents."""
    s = setup
    it = _fresh(s["items"][0])
    j_attach_body_grid(it)
    t_it = _fresh(s["items"][0])
    attach_body_grid(t_it)
    inp = j_to_device_input(it)
    t_inp = to_device_input(t_it, "cpu")
    rays, _, _ = t_runner.view_rays(t_it, VIEW, "cpu",
                                    t_it["mask_at_box_all"][VIEW])
    rays = [r[256:512].contiguous() for r in rays]
    with torch.no_grad():
        t_latent = s["t_model"].encode(t_inp["img_all"])
    return dict(inp=inp, t_inp=t_inp, t_rays=rays, j_out={},
                j_rays=[jnp.asarray(r.numpy()) for r in rays],
                latent=s["model"].apply(s["variables"], inp["img_all"],
                                        method=JMPSNeRF.encode),
                t_latent=t_latent)


def _j_block(s, b, n_importance, perturb):
    """JAX's ``render_rays`` on the block (black background), one compile
    per (n_importance, perturb), shared by the tests."""
    key = (n_importance, perturb)
    if key not in b["j_out"]:
        b["j_out"][key] = jax.jit(lambda *r: j_render.render_rays(
            s["model"], s["variables"], s["smpl"], b["inp"], b["inp"],
            b["latent"], *r, jax.random.PRNGKey(7), N_SAMPLES,
            perturb=perturb, n_importance=n_importance))(*b["j_rays"])
    return b["j_out"][key]


@pytest.mark.parametrize("n_importance,white_bkgd,perturb", [
    (0, False, 0.0), (0, True, 0.0), (N_IMP, False, 0.0), (N_IMP, True, 0.0),
    (N_IMP, False, 1.0)])
def test_render_rays_matches_jax(setup, block, n_importance, white_bkgd,
                                 perturb):
    """``render_rays`` with the hierarchical pass and a white background
    (against JAX's black render plus ``1 - acc``, which is all the white
    background changes in JAX's compositing: the weights, and so the
    importance z, do not move); with perturb 1 the JAX key's own jitter
    and importance draws are injected (``u`` from the first half of
    ``split(key)``, ``u_imp`` from the second).  The hierarchical image
    differs from the plain one."""
    s, b = setup, block
    key = jax.random.PRNGKey(7)
    opts = dict(perturb=perturb, white_bkgd=white_bkgd,
                n_importance=n_importance)
    j = _j_block(s, b, n_importance, perturb)
    if white_bkgd:
        j = j._replace(rgb_map=j.rgb_map + (1.0 - j.acc_map[:, None]))
    draws = {}
    if perturb:
        k_z, k_imp = jax.random.split(key)
        r = b["t_rays"][0].shape[0]
        draws = dict(
            u=torch.from_numpy(np.array(jax.random.uniform(
                k_z, (r, N_SAMPLES), dtype=jnp.float32))),
            u_imp=torch.from_numpy(np.array(jax.random.uniform(
                k_imp, (r, n_importance), dtype=jnp.float32))))
    t = t_render.render_rays(
        s["t_model"], s["t_smpl"], b["t_inp"], b["t_inp"], b["t_latent"],
        *b["t_rays"], N_SAMPLES, **opts, **draws)
    assert t.weights.shape == (256, N_SAMPLES + n_importance)
    assert not t.rgb_map.requires_grad  # an eval render builds no graph
    assert int(j.raw.n_dropped) == int(t.raw.n_dropped) == 0
    np.testing.assert_array_equal(np.asarray(j.raw.pts_mask),
                                  t.raw.pts_mask.numpy())
    for name in ("rgb_map", "acc_map", "depth_map", "weights"):
        np.testing.assert_allclose(
            np.asarray(getattr(j, name)), getattr(t, name).numpy(),
            atol=5e-4 if name == "depth_map" else 1e-4, err_msg=name)
    if n_importance and not perturb:
        plain = t_render.render_rays(
            s["t_model"], s["t_smpl"], b["t_inp"], b["t_inp"], b["t_latent"],
            *b["t_rays"], N_SAMPLES, white_bkgd=white_bkgd)
        assert (plain.rgb_map - t.rgb_map).abs().max() > 1e-4


def test_render_rays_mapped_and_render_image_match_jax(setup, block):
    """``render_rays_mapped`` over 4 chunks of 64 rays (with the largest
    per-chunk drop) and ``render_image`` over 100 rays padded to 128, at
    perturb 0 with the hierarchical pass, against JAX's block render (at
    perturb 0 JAX's mapped render is that, chunk by chunk); the chunking
    does not move a pixel."""
    s, b = setup, block
    opts = dict(perturb=0.0, n_importance=N_IMP)
    j = _j_block(s, b, N_IMP, 0.0)
    t = t_render.render_rays_mapped(
        s["t_model"], s["t_smpl"], b["t_inp"], b["t_inp"], b["t_latent"],
        *b["t_rays"], 64, N_SAMPLES, with_dropped=True, **opts)
    assert int(j.raw.n_dropped) == int(t[3]) == 0
    for a, c in zip((j.rgb_map, j.disp_map, j.acc_map), t[:3]):
        np.testing.assert_allclose(np.asarray(a), c.numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        t_render.render_rays_mapped(
            s["t_model"], s["t_smpl"], b["t_inp"], b["t_inp"],
            b["t_latent"], *b["t_rays"], 100, N_SAMPLES)
    whole = t_render.render_rays(
        s["t_model"], s["t_smpl"], b["t_inp"], b["t_inp"], b["t_latent"],
        *b["t_rays"], N_SAMPLES, **opts)
    np.testing.assert_allclose(t[0].numpy(), whole.rgb_map.numpy(),
                               atol=1e-6)

    host = [r[:100].numpy() for r in b["t_rays"]]

    def t_fn(ro, rd, nr, fr):
        out = t_render.render_rays(
            s["t_model"], s["t_smpl"], b["t_inp"], b["t_inp"],
            b["t_latent"], ro, rd, nr, fr, N_SAMPLES, **opts)
        return out.rgb_map, out.disp_map, out.acc_map

    t_img = t_render.render_image(t_fn, *host, 64, device="cpu")
    for a, c in zip((j.rgb_map, j.disp_map, j.acc_map), t_img):
        assert c.shape == (100,) + tuple(a.shape[1:])
        np.testing.assert_allclose(np.asarray(a)[:100], c, atol=1e-4)


@pytest.mark.parametrize("with_plan", [False, True])
def test_render_rays_compact_grid_only_matches_jax(setup, block, with_plan):
    """The grid-only global render (``fine_capacity = 0``): tail tiles over
    the body-grid candidates through the uncompacted model, with the
    candidate plan given by the pre-pass or built in the render, and a
    white background."""
    s, b = setup, block
    key = jax.random.PRNGKey(0)
    tile = 1024
    t_plan = t_render.plan_rays_compact(s["t_smpl"], b["t_inp"],
                                        *b["t_rays"], N_SAMPLES)
    cap = max(1, -(-int(t_plan.n_valid) // tile)) * tile
    if "grid_only" not in b["j_out"]:  # one compile for both cases
        b["j_out"]["grid_only"] = jax.jit(
            lambda *r: j_render.render_rays_compact(
                s["model"], s["variables"], s["smpl"], b["inp"], b["inp"],
                b["latent"], *r, key, n_samples=N_SAMPLES, capacity=cap,
                tile=tile, white_bkgd=True))(*b["j_rays"])
    j = b["j_out"]["grid_only"]
    t = t_render.render_rays_compact(
        s["t_model"], s["t_smpl"], b["t_inp"], b["t_inp"], b["t_latent"],
        *b["t_rays"], N_SAMPLES, capacity=cap, tile=tile, white_bkgd=True,
        plan=t_plan if with_plan else None)
    assert int(j[3]) == int(t[3]) == 0
    for a, c in zip(j[:3], t[:3]):
        np.testing.assert_allclose(np.asarray(a), c.numpy(), atol=1e-4)
    assert float(t[2].max()) > 0.01


# ---- ViewRenderer ----------------------------------------------------------

# case: (port renderer options, the JAX references it must equal)
T_CASES = {
    "global": (dict(chunk=CHUNK, n_samples=N_SAMPLES,
                    eval_compact_fraction=0.5), ["global", "chunked"]),
    "global_grid_only": (dict(chunk=CHUNK, n_samples=N_SAMPLES,
                              eval_compact_fraction=0.5, fine=False),
                         ["global"]),
    "chunked_shuffled": (dict(chunk=CHUNK, n_samples=N_SAMPLES,
                              eval_compact_fraction=0.5,
                              global_compact=False), ["chunked", "global"]),
    "chunked_unshuffled": (dict(chunk=CHUNK, n_samples=N_SAMPLES,
                                eval_compact_fraction=0.5,
                                global_compact=False, shuffle_rays=False),
                           ["chunked"]),
    "hier_chunk_512": (dict(chunk=CHUNK, n_samples=N_SAMPLES,
                            n_importance=N_IMP, eval_compact_fraction=0.5,
                            shuffle_rays=False), ["hier"]),
    "hier_chunk_2048": (dict(chunk=2048, n_samples=N_SAMPLES,
                             n_importance=N_IMP, eval_compact_fraction=0.5,
                             shuffle_rays=False), ["hier"]),
    "overflow_fallback": (dict(chunk=2048, n_samples=N_SAMPLES,
                               eval_compact_fraction=1e-6,
                               shuffle_rays=False, global_compact=False),
                          ["global", "chunked"]),
    "white_background": (dict(chunk=CHUNK, n_samples=N_SAMPLES,
                              white_bkgd=True, eval_compact_fraction=0.5,
                              global_compact=False), []),
}


@pytest.mark.parametrize("case", list(T_CASES))
def test_view_renderer_matches_jax(setup, case):
    """Each path of the port's ViewRenderer against JAX's on the same
    item: global (fine and grid-only), chunked (shuffled or not), the
    hierarchical chunked path at two chunk sizes (chunk-invariant at
    perturb 0), the overflow fallback (a fraction whose 1024-slot floor
    every body chunk overflows: those chunks render again uncompacted and
    equal the exact image), and a white background (box-culled pixels
    fill 1.0, rendered ones JAX's black image plus ``1 - acc``)."""
    s = setup
    opts, refs = T_CASES[case]
    r = _t_renderer(s, **opts)
    assert r.global_compact == (case.startswith("global"))
    it = _fresh(s["items"][0])
    out = r.render_view(it, it, VIEW)
    assert out.shape == (64 * 64, 3) and out.dtype == np.float32
    for ref in refs:
        np.testing.assert_allclose(out, _j_ref(s, ref), atol=1e-4,
                                   err_msg=ref)
    stats = r.last_view
    hit = np.asarray(s["items"][0]["mask_at_box_all"][VIEW]).reshape(-1)
    assert stats.hit_rays == int(hit.sum())
    assert (stats.acc[~hit] == 0).all() and stats.acc.max() > 0.01
    assert r.n_overflow_chunks == stats.n_overflow_chunks
    if case == "overflow_fallback":
        assert stats.n_overflow_chunks > 0 and stats.n_dropped > 0
    if case == "white_background":
        assert (out[~hit] == 1.0).all()
        np.testing.assert_allclose(
            out[hit], _j_ref(s, "chunked")[hit] + 1.0 - stats.acc[hit, None],
            atol=1e-4)
    if case.startswith("hier"):
        assert np.abs(out - _j_ref(s, "chunked")).max() > 1e-4


def test_masked_ray_mode_matches_jax(setup):
    """H36M's masked-ray mode: only the masked rays render; pixels outside
    the explicit mask are exactly 0 (also under a white background, where
    box-culled pixels would be 1), masked ones equal the full render."""
    s = setup
    mask = np.asarray(s["items"][0]["mask_at_box_all"][VIEW]).reshape(-1)
    it = _fresh(s["items"][0])
    r = _t_renderer(s, chunk=CHUNK, n_samples=N_SAMPLES,
                    eval_compact_fraction=0.5)
    out = r.render_view(it, it, VIEW, ray_mask=mask)
    assert (out[~mask] == 0).all()
    np.testing.assert_allclose(out, _j_ref(s, "global", masked=True),
                               atol=1e-4)
    np.testing.assert_allclose(out[mask], r.render_view(it, it, VIEW)[mask],
                               atol=1e-5)
    w = _t_renderer(s, chunk=CHUNK, n_samples=N_SAMPLES, white_bkgd=True,
                    global_compact=False)
    assert (w.render_view(it, it, VIEW, ray_mask=mask)[~mask] == 0).all()


@pytest.mark.parametrize("global_compact", [True, False])
def test_async_matches_sync(setup, global_compact):
    """``render_view_async`` + ``finish_view`` equal ``render_view``, two
    views in flight on the global path (whose handle holds device tensors
    until it is finished); the chunked path finishes inside the handle."""
    s = setup
    r = _t_renderer(s, chunk=CHUNK, n_samples=N_SAMPLES,
                    global_compact=global_compact)
    i0, i1 = _fresh(s["items"][0]), _fresh(s["items"][1])
    sync0 = r.render_view(i0, i0, 1)
    sync1 = r.render_view(i1, i1, 2)
    h0 = r.render_view_async(i0, i0, 1)
    h1 = r.render_view_async(i1, i1, 2)
    assert (h0.done is None) == global_compact
    if global_compact:
        assert all(isinstance(x, torch.Tensor) for x in h0.out)
    np.testing.assert_array_equal(r.finish_view(h0), sync0)
    np.testing.assert_array_equal(r.finish_view(h1), sync1)
    np.testing.assert_allclose(sync0, _j_ref(s, "global"), atol=1e-4)


def test_latent_cache_and_prewarm(setup):
    """Each source item caches its own latent (encoded once); ``prewarm``
    runs view k's pre-passes and renders at the counted capacities and
    one tile above, and returns those pairs; the chunked path warms
    nothing."""
    s = setup
    i0, i1 = _fresh(s["items"][0]), _fresh(s["items"][1])
    r = _t_renderer(s, chunk=CHUNK, n_samples=N_SAMPLES, tile=2048)
    pairs = r.prewarm(i0, i0, k=VIEW, extra_buckets=1)
    assert len(pairs) == 2 and all(c % 2048 == 0 for p in pairs for c in p)
    assert pairs[1] == (pairs[0][0] + 2048, pairs[0][1] + 2048)
    cached = i0["_latent_cache"]
    r.render_view(i0, i0, VIEW)
    assert i0["_latent_cache"] is cached
    stats = r.last_view
    assert (stats.capacity, stats.fine_capacity) == pairs[0]
    assert stats.n_candidates > stats.n_body > 0
    r.render_view(i1, i1, VIEW)
    assert float((i0["_latent_cache"] - i1["_latent_cache"]).abs().max()) > 0
    assert _t_renderer(s, n_samples=N_SAMPLES,
                       global_compact=False).prewarm(i0, i0) == []


def test_device_cache_refresh_source_then_target(setup):
    """An item first cached as a source (no body grid) is cached anew when
    it is later rendered as a target."""
    s = setup
    i0, i1 = _fresh(s["items"][0]), _fresh(s["items"][1])
    r = _t_renderer(s, chunk=CHUNK, n_samples=N_SAMPLES)
    r.render_view(i0, i1, 1)
    assert "body_grid" not in i0["_torch_cache"][1]
    out = r.render_view(i0, i0, 1)
    assert "body_grid" in i0["_torch_cache"][1]
    np.testing.assert_allclose(out, _j_ref(s, "global"), atol=1e-4)


def test_dataset_window():
    """DatasetWindow indexes its dataset lazily, slices into a shifted
    window, and the port's dataset is indexable like the JAX one."""
    class Counting:
        def __init__(self):
            self.calls = []

        def __getitem__(self, i):
            self.calls.append(i)
            return {"i": i}

    ds = Counting()
    w = t_runner.DatasetWindow(ds, 4)
    assert len(w) == 4 and ds.calls == []
    assert [x["i"] for x in w[1:]] == [1, 2, 3]
    with pytest.raises(IndexError):
        w[4]
    with pytest.raises(ValueError):
        w[::2]
    t_ds = TDataset(n_poses=2, n_cameras=2, image_size=16, n_verts=50)
    assert len(t_ds) == 2 and t_ds.train_view == [0, 1]
    assert int(t_ds[1]["pose_index"]) == 1


# ---- metrics and the protocol ----------------------------------------------


@pytest.mark.parametrize("mask_kind", ["blob", "full", "empty"])
def test_metrics_match_jax(mask_kind):
    """PSNR, SSIM (float64, to 1e-12) and the bbox-cropped masked SSIM;
    the bounding box equals ``cv2.boundingRect``, (0, 0, 0, 0) for an
    empty mask, where both packages' SSIM is NaN."""
    rng = np.random.default_rng(1)
    H = W = 40
    mask = np.zeros((H, W), bool)
    if mask_kind == "blob":
        mask[7:31, 12:35] = rng.uniform(size=(24, 23)) > 0.2
    elif mask_kind == "full":
        mask[:] = True
    m = int(mask.sum())
    pred = rng.uniform(size=(m, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(size=(m, 3)) * 0.1, 0, 1).astype(
        np.float32)
    assert t_metrics.bounding_rect(mask) == cv2.boundingRect(
        mask.astype(np.uint8))
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)
        j = j_metrics.ssim_metric(pred, gt, mask, H, W)
        t = t_metrics.ssim_metric(pred, gt, mask, H, W)
    if mask_kind == "empty":
        assert np.isnan(j) and np.isnan(t)
        return
    assert abs(j - t) <= 1e-12
    assert t_metrics.psnr_metric(pred, gt) == j_metrics.psnr_metric(pred, gt)
    a = rng.uniform(size=(30, 20, 3))
    c = a + rng.normal(size=a.shape) * 0.05
    for kw in (dict(channel_axis=-1), dict(channel_axis=-1, data_range=1.0)):
        assert abs(j_metrics.structural_similarity(a, c, **kw)
                   - t_metrics.structural_similarity(a, c, **kw)) <= 1e-12


def _fake_render(sp, tp, k):
    """A deterministic (H*W, 3) image from the items and the view."""
    rng = np.random.default_rng(int(sp["pose_index"]) * 100
                                + int(tp["pose_index"]) * 10 + k)
    gt = np.asarray(tp["rgb_all"][k]).reshape(-1, 3)
    return np.clip(gt + rng.normal(size=gt.shape) * 0.05, 0, 1).astype(
        np.float32)


@pytest.mark.parametrize("pipelined", [False, True])
def test_evaluate_novel_view_pose_matches_jax(setup, tmp_path, pipelined):
    """The same render function through both protocols: equal
    metrics.json and metrics.npy, and every PNG decodes (with cv2) to the
    JAX file's pixels, for the sequential loop and the depth-1 pipeline."""
    s = setup
    items = s["items"]
    humans = {"a": {"novel_pose": items, "novel_view": items[:1]}}
    kw = dict(start_poses={"a": 3}, verbose=False)
    async_pair = ((lambda sp, tp, k: ("handle", _fake_render(sp, tp, k))),
                  (lambda h: h[1])) if pipelined else None
    j = j_protocol.evaluate_novel_view_pose(
        _fake_render, humans, [1, 3], 64, 64, str(tmp_path / "j"), **kw)
    t = t_protocol.evaluate_novel_view_pose(
        _fake_render, humans, [1, 3], 64, 64, str(tmp_path / "t"),
        render_async=async_pair, **kw)
    with open(tmp_path / "j" / "metrics.json") as f:
        jj = json.load(f)
    with open(tmp_path / "t" / "metrics.json") as f:
        tj = json.load(f)
    assert jj == tj
    jn = np.load(tmp_path / "j" / "metrics.npy", allow_pickle=True).item()
    tn = np.load(tmp_path / "t" / "metrics.npy", allow_pickle=True).item()
    assert jn.keys() == tn.keys() == j.keys() == t.keys()
    for key in jn:
        np.testing.assert_array_equal(np.asarray(jn[key]),
                                      np.asarray(tn[key]), err_msg=key)
    pngs = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                  for d, _, fs in os.walk(tmp_path / "j") for f in fs
                  if f.endswith(".png"))
    assert len(pngs) == 8  # (1 target + 1 item) x 2 views x (pred, gt)
    for name in pngs:
        a = cv2.imread(str(tmp_path / "j" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "t" / name), cv2.IMREAD_UNCHANGED)
        assert a is not None and b is not None and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_png_encoder_grey_and_rgb(tmp_path):
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (13, 7), dtype=np.uint8),
                rng.integers(0, 256, (5, 9, 3), dtype=np.uint8)):
        path = str(tmp_path / "x.png")
        t_protocol._imwrite(path, img)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        want = img if img.ndim == 2 else img[..., ::-1]  # cv2 reads BGR
        np.testing.assert_array_equal(back, want)
    with pytest.raises(ValueError):
        t_protocol.encode_png(np.zeros((4, 4, 2), np.uint8))


def test_run_synthetic_eval_matches_jax(setup, tmp_path):
    """The synthetic protocol end to end at 32^2 (4 cameras, inputs 0-2,
    novel view 3, 2 poses) from the port's config parser: metrics within
    1e-4 relative of JAX's (the two packages' items differ by fp32 posing,
    ~2e-7), the same files."""
    s = setup
    argv = ["--config", "configs/canonical_transformer.txt",
            "--N_samples", str(N_SAMPLES)]
    kw = dict(n_poses=2, n_cameras=4, image_size=32, n_verts=N_VERTS,
              n_rays=32, split="test")
    j = j_runner.run_synthetic_eval(
        j_config.parse_args(argv), s["model"], s["variables"],
        lambda g: s["smpl"], str(tmp_path / "j"), JDataset(**kw),
        verbose=False)
    t = t_runner.run_synthetic_eval(
        t_config.parse_args(argv), s["t_model"], lambda g: s["t_smpl"],
        str(tmp_path / "t"), TDataset(**kw), verbose=False, device="cpu")
    for key in ("novel_view_mse", "novel_view_psnr", "novel_view_ssim",
                "novel_pose_mse", "novel_pose_psnr", "novel_pose_ssim"):
        np.testing.assert_allclose(t[key], j[key], rtol=1e-4, err_msg=key)
    assert t["all_human_names"] == j["all_human_names"]
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "t")
                   for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert files == sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "j")
        for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert "metrics.json" in files and len(files) == 2 + 4


@pytest.mark.parametrize("name", CONFIGS)
def test_parse_args_matches_jax(name):
    """The port's parser reads configs/*.txt to JAX's namespace, with a
    command-line flag winning over the file."""
    argv = ["--config", f"configs/{name}.txt", "--N_importance", "4"]
    j = vars(j_config.parse_args(argv))
    t = vars(t_config.parse_args(argv))
    assert j == t
    assert t["N_importance"] == 4
    assert vars(t_config.parse_args([])) == vars(j_config.parse_args([]))
