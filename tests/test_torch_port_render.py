"""Parity of the PyTorch port's renderer and view renderer with the JAX
package on a 64^2 synthetic view (600 vertices, 16 samples per ray), on
the CPU: plan and fine pre-passes, the global-compaction render, the
block renderer and ``ViewRenderer.render_view``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu.data import attach_body_grid as j_attach_body_grid
from mpsnerf_tpu.data.synthetic import SyntheticHumanDataset
from mpsnerf_tpu.eval.runner import ViewRenderer as JViewRenderer
from mpsnerf_tpu.models.mps_nerf import MPSNeRF as JMPSNeRF
from mpsnerf_tpu.renderer import render as j_render
from mpsnerf_tpu.train.trainer import to_device_input as j_to_device_input

from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.data import attach_body_grid, to_device_input
from mpsnerf_torch.eval.runner import ViewRenderer as TViewRenderer, view_rays
from mpsnerf_torch.models.mps_nerf import MPSNeRF as TMPSNeRF
from mpsnerf_torch.renderer import render as t_render
from mpsnerf_torch.smpl.model import synthetic_smpl

N_SAMPLES = 16
TILE = 2048
VIEW = 1

# Pixels at atol 1e-4: every rendered sample runs the fp32 tail (checked
# at 1e-4 per raw value in test_torch_port_model.py) and compositing sums
# 16 of them; masks and plans are exact, so no sample changes class.


def _round_up(n, m):
    return max(1, -(-n // m)) * m


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticHumanDataset(
        n_poses=1, n_cameras=4, image_size=64, n_rays=32, n_verts=600,
        num_instances=1, split="test",
    )
    item = ds.get_item(0, instance_idx=0)
    t_item = dict(item)
    j_attach_body_grid(item)
    attach_body_grid(t_item)
    smpl = ds.smpl_for(0)
    inp = j_to_device_input(item)
    model = JMPSNeRF(num_instances=1, compact_fraction=0.5)
    variables = model.init(
        {"params": jax.random.PRNGKey(0)}, smpl, inp, inp,
        jnp.zeros((8, 3)), jnp.zeros((8, 3)), train=False,
    )
    latent = model.apply(variables, inp["img_all"], method=JMPSNeRF.encode)

    t_model = TMPSNeRF().eval()
    t_model.load_state_dict(from_jax(jax.tree.map(np.asarray, variables)))
    t_inp = to_device_input(t_item, "cpu")
    t_smpl = synthetic_smpl(n_verts=600, seed=0, device="cpu")
    with torch.no_grad():
        t_latent = t_model.encode(t_inp["img_all"])

    t_rays, _, _ = view_rays(t_item, VIEW, "cpu",  # the box-hit rays
                             t_item["mask_at_box_all"][VIEW])
    return dict(
        item=item, t_item=t_item, smpl=smpl, inp=inp, model=model,
        variables=variables, latent=latent, t_model=t_model, t_inp=t_inp,
        t_smpl=t_smpl, t_latent=t_latent,
        j_rays=[jnp.asarray(r.numpy()) for r in t_rays], t_rays=t_rays,
    )


def _prepasses(s):
    key = jax.random.PRNGKey(0)
    jp = jax.jit(lambda *r: j_render.plan_rays_compact(
        s["smpl"], s["inp"], *r, key, n_samples=N_SAMPLES))(*s["j_rays"])
    tp = t_render.plan_rays_compact(s["t_smpl"], s["t_inp"], *s["t_rays"],
                                    N_SAMPLES)
    cap = _round_up(int(jp.n_valid), TILE)
    jf, jids = jax.jit(lambda *r: j_render.fine_rays_compact(
        s["smpl"], s["inp"], *r, key, n_samples=N_SAMPLES, plan=jp,
        capacity=cap))(*s["j_rays"])
    tf, tids = t_render.fine_rays_compact(s["t_smpl"], s["t_inp"],
                                          *s["t_rays"], N_SAMPLES, tp, cap)
    return key, cap, (jp, jf, jids), (tp, tf, tids)


def test_plan_and_fine_prepasses_exact(setup):
    """Candidate and body plans are equal integer for integer; the fine
    pre-pass's nearest-vertex ids agree (the JAX CPU oracle is the
    product form, so a near-tie may pick another vertex)."""
    _, cap, (jp, jf, jids), (tp, tf, tids) = _prepasses(setup)
    assert 0 < int(tp.n_valid) < tp.slot.shape[0]
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(jf.n_valid) == int(tf.n_valid) > 0
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    nv = int(tp.n_valid)
    assert (np.asarray(jids)[:nv] == tids.numpy()[:nv]).mean() > 0.99


@pytest.mark.parametrize("tile", [1024, TILE])
def test_render_rays_compact(setup, tile):
    """The global-compaction render over the fine pre-pass's body points;
    the pixels do not depend on the tail's tile size."""
    s = setup
    key, _, (jp, jf, jids), (tp, tf, tids) = _prepasses(s)
    cap = _round_up(int(tp.n_valid), tile)
    fcap = _round_up(int(tf.n_valid), tile)
    jout = jax.jit(lambda *r: j_render.render_rays_compact(
        s["model"], s["variables"], s["smpl"], s["inp"], s["inp"],
        s["latent"], *r, key, n_samples=N_SAMPLES, capacity=cap, tile=tile,
        fine_capacity=fcap, plan=jp, fine_plan=jf, fine_ids=jids,
    ))(*s["j_rays"])
    tout = t_render.render_rays_compact(
        s["t_model"], s["t_smpl"], s["t_inp"], s["t_inp"], s["t_latent"],
        *s["t_rays"], N_SAMPLES, capacity=cap, fine_capacity=fcap, plan=tp,
        fine_plan=tf, fine_ids=tids, tile=tile)
    assert int(jout[3]) == int(tout[3]) == 0
    for a, b in zip(jout[:3], tout[:3]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4)
    assert tout[2].max() > 0.01  # the body is visible


def test_render_rays_block(setup):
    """The block renderer (n_importance = 0) on 256 body-crossing rays,
    through the body-grid query branch."""
    s = setup
    sl = slice(256, 512)
    jr = [r[sl] for r in s["j_rays"]]
    tr = [r[sl] for r in s["t_rays"]]
    j = j_render.render_rays(
        s["model"], s["variables"], s["smpl"], s["inp"], s["inp"],
        s["latent"], *jr, jax.random.PRNGKey(0), N_SAMPLES, perturb=0.0)
    with torch.no_grad():
        t = t_render.render_rays(
            s["t_model"], s["t_smpl"], s["t_inp"], s["t_inp"], s["t_latent"],
            *tr, N_SAMPLES)
    np.testing.assert_array_equal(np.asarray(j.raw.pts_mask),
                                  t.raw.pts_mask.numpy())
    assert int(j.raw.n_dropped) == int(t.raw.n_dropped)
    for name in ("rgb_map", "acc_map", "depth_map"):
        np.testing.assert_allclose(np.asarray(getattr(j, name)),
                                   getattr(t, name).numpy(), atol=1e-4,
                                   err_msg=name)


def test_view_renderer_render_view(setup):
    """The slice's entry point: box cull, latent cache, plan pre-pass,
    fine pre-pass, render and the full-image scatter, against the JAX
    ViewRenderer (which pads rays and picks capacity buckets; the pixels
    do not depend on either)."""
    s = setup
    jr = JViewRenderer(s["model"], lambda g: s["smpl"], n_samples=N_SAMPLES,
                       tile=TILE)
    tr = TViewRenderer(s["t_model"], lambda g: s["t_smpl"],
                       n_samples=N_SAMPLES, tile=TILE, device="cpu")
    j = jr.render_view(s["variables"], s["item"], s["item"], VIEW)
    rgb = tr.render_view(s["t_item"], s["t_item"], VIEW)
    t = tr.last_view
    assert rgb.shape == (64 * 64, 3) and t.n_dropped == 0
    assert t.hit_rays == int(s["item"]["mask_at_box_all"][VIEW].sum())
    assert t.capacity % TILE == 0 and t.fine_capacity % TILE == 0
    assert t.n_candidates > t.n_body > 0
    np.testing.assert_allclose(j, rgb, atol=1e-4)
    # the latent is encoded once and cached on the source item
    cached = s["t_item"]["_latent_cache"]
    tr.render_view(s["t_item"], s["t_item"], VIEW)
    assert s["t_item"]["_latent_cache"] is cached
