"""The plain and smooth view-step gradients of two numpy-era models of the
port, ``correction_by_f3d_fagg`` (``CorrectionF3D`` with the windowed
aggregate, whose smooth step compares the correction fields' Jacobian
norms) and ``correction_by_uvh_agg`` (``CorrectionUvhAgg``), against
``jax.grad`` of the JAX package's loss on the CPU, with the scene and
weights of ``tests/test_torch_port_legacy.py`` (both correction fields'
output layers non-zero) and rays through the body (every ray's second
sample on a posed vertex), so that the 3D encoder's lookups read occupied
voxels and its gradient is held too.  The views are fused by their mean:
XLA's compile of the transformer's gradients would double the file's
time, and the transformer's gradients are held in
``tests/test_torch_port_train.py``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu.train import trainer as j_trainer

from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.train import trainer as t_trainer

from tests.test_torch_port_legacy import (  # noqa: F401 (fixture)
    CASES,
    NARROW,
    _cast,
    _f64,
    _pair,
    scene,
)
from tests.test_torch_port_variants import N_RAYS, N_SAMPLES, _np
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRAD_CASES = {
    "correction_by_f3d_fagg": ("CorrectionF3D", dict(
        NARROW, encoder_layers=1, use_agg=True, human_sample=True)),
    "correction_by_uvh_agg": CASES["correction_by_uvh_agg"],
}


def body_rays(item, k, seed=5):
    """``N_RAYS`` rays from view ``k``'s camera through posed vertices:
    ``(rays_o, rays_d, near, far, target_rgb, bkgd_msk)``, near 2 cm
    before the vertex and the samples 2 cm apart at perturb 0, so each
    ray's second sample sits on its vertex and the next ones in or near
    the body.  The targets are the view's own ray colours."""
    rng = np.random.default_rng(seed)
    o = np.asarray(item["ray_o_all"][k], np.float64)
    v = np.asarray(item["vertices"], np.float64)[
        rng.choice(len(item["vertices"]), N_RAYS, replace=False)]
    t = np.linalg.norm(v - o, axis=-1)
    near = t - 0.02
    return tuple(np.asarray(x, np.float32) for x in (
        o, (v - o) / t[:, None], near, near + 0.02 * (N_SAMPLES - 1),
        item["rgb_all"][k], item["bkgd_msk_all"][k]))


@pytest.mark.parametrize("name,smooth", [
    (n, s) for n in GRAD_CASES for s in (False, True)])
def test_view_step_gradients_match_jax(scene, name, smooth):
    """A plain and a smooth view-step (perturb 0, the JAX package's smooth
    delta) on rays through the body: loss terms at 1e-5, every
    parameter's gradient within 1e-4 of its tensor's max |grad|, the
    running statistics after the step at 1e-5 (the 3D encoder's move
    twice a query: the posed and the canonical grid).  Both correction
    fields and the 3D encoder get a gradient.

    ``CorrectionUvhAgg``'s step runs in float64 in both packages (JAX
    under ``enable_x64``): its fields and NeRF read PE10, whose top
    frequency (512 pi) turns fp32 rounding of the points into ReLU flips.
    Over five weight seeds they move the worst parameter's fp32 gradient
    from its float64 value by 6e-5 to 0.32 % of its max in JAX, 0.05 to
    1.6 % in the port, on different layers from seed to seed
    (``tests/torch_port_fp32_drift.py``)."""
    cls, kw = GRAD_CASES[name]
    model, variables, t_model = _pair(scene, cls, kw)
    f64 = cls == "CorrectionUvhAgg"
    dt = torch.float64 if f64 else torch.float32
    k = 1
    rays = body_rays(scene["items"][1], k)
    cfg = dict(n_samples=N_SAMPLES, perturb=0.0)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(f64):
        j_inp, j_smpl, j_vars = scene["j_inp"][1], scene["j_smpl"], variables
        if f64:
            j_inp, j_smpl, j_vars = _f64(j_inp), _f64(j_smpl), _f64(variables)
        j_rays = tuple(jnp.asarray(r, jnp.float64 if f64 else jnp.float32)
                       for r in rays)
        loss = j_trainer.make_loss_fn(model, j_trainer.TrainConfig(**cfg),
                                      smooth)
        grads, (terms, new_bs, _) = jax.jit(jax.grad(
            lambda p, bs: loss(p, bs, j_smpl, j_inp, j_inp, *j_rays, key),
            has_aux=True))(j_vars["params"], j_vars["batch_stats"])
        # the loss's own draw (its second key, in the points' dtype)
        delta = 0.01 * jax.random.normal(
            jax.random.split(key, 3)[1], (N_RAYS * N_SAMPLES, 3),
            jnp.float64 if f64 else jnp.float32)
        grads, new_bs, delta = _np(grads), _np(new_bs), np.asarray(delta)

    t_model.load_state_dict(from_jax(variables), strict=True)
    t_model.zero_grad(set_to_none=True)
    step_model = copy.deepcopy(t_model).to(dt) if f64 else t_model
    t_loss = t_trainer.make_loss_fn(step_model,
                                    t_trainer.TrainConfig(**cfg), smooth)
    t_inp = _cast(scene["t_inp"][1], dt)
    total, (t_terms, _) = t_loss(
        _cast(scene["t_smpl"], dt), t_inp, t_inp,
        *(torch.from_numpy(r).to(dt) for r in rays),
        delta=torch.from_numpy(np.array(delta)).to(dt))
    total.backward()
    for f in terms._fields:
        np.testing.assert_allclose(float(getattr(terms, f)),
                                   float(getattr(t_terms, f).detach()),
                                   atol=1e-5, err_msg=f)
    assert (float(t_terms.normal_smooth.detach()) > 0) == \
        (smooth and cls == "CorrectionF3D")
    want = from_jax({"params": grads,
                     "batch_stats": variables["batch_stats"]})
    for n, p in step_model.named_parameters():
        g = want[n].numpy().astype(np.float64)
        assert p.grad is not None, n
        err = np.abs(p.grad.double().numpy() - g).max() / max(
            np.abs(g).max(), 1e-30)
        assert err <= 1e-4, (n, err)
    for part in ("forward_deform", "backward_deform", "encoder_3d"):
        assert max(float(np.abs(want[n].numpy()).max()) for n in want
                   if n.startswith(part) and "running" not in n
                   and "num_batches" not in n) > 0, part
    stats = from_jax({"params": variables["params"],
                      "batch_stats": new_bs})
    for n, v in step_model.state_dict().items():
        if "running" in n:
            np.testing.assert_allclose(v.double().numpy(),
                                       stats[n].numpy().astype(np.float64),
                                       atol=1e-5, err_msg=n)
