"""The plain and smooth view-step gradients of three variants of the
port's ``MPSNeRF`` (the instance-style correction field, the skinning
field, the aggregate correction field in pair mode) against ``jax.grad``
of the JAX package's loss, on the CPU, with the scene and weights of
``tests/test_torch_port_variants.py``.  The smooth steps and the plain
steps of the last two variants fuse the views by their mean
(``use_transformer=False``): XLA's compile of the transformer's double
backward would triple the file's time, and the transformer's own
gradients are held in ``tests/test_torch_port_train.py``.  The instance
correction field's plain step keeps the transformer, so that the deform
fields' gradients are held as they flow through the fused features."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu.train import trainer as j_trainer

from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.train import trainer as t_trainer

from tests.test_torch_port_variants import (  # noqa: F401 (fixture)
    CASES,
    PAIR_CASE,
    N_RAYS,
    N_SAMPLES,
    _np,
    _pair,
    _sp_tp,
    scene,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


GRAD_CASES = ["correction_batch", "skinning_field", "pair_correction_field"]


@pytest.mark.parametrize("name,smooth,grad_tol", [
    (n, s, 1e-3 if s else 1e-4) for n in GRAD_CASES for s in (False, True)])
def test_view_step_gradients_match_jax(scene, name, smooth, grad_tol):
    """A plain and a smooth view-step (perturb 0, the JAX package's smooth
    delta; the pair case with its pose gate, the poses differing, so the
    image term is 0): loss terms at 1e-5, every parameter gradient within
    ``grad_tol`` of its tensor's max |grad| (as in
    ``tests/test_torch_port_train.py``), and the 2D and 3D encoders'
    running statistics after the step at 1e-5 (the 3D encoder's move once
    a query: twice in the smooth step, each query twice for the instance
    style)."""
    kw = dict(PAIR_CASE if name == "pair_correction_field" else CASES[name],
              use_transformer=name == "correction_batch" and not smooth)
    model, variables, t_model = _pair(scene, kw)
    pair = bool(kw.get("pair_mode"))
    j_sp, j_tp = _sp_tp(scene, kw, True)
    t_sp, t_tp = _sp_tp(scene, kw, False)
    cfg = dict(n_samples=N_SAMPLES, perturb=0.0, pair_mode=pair)
    key = jax.random.PRNGKey(5)
    k = 1
    rays = (j_tp["ray_o_all"][k], j_tp["ray_d_all"][k],
            j_tp["near_all"][k][:, 0], j_tp["far_all"][k][:, 0],
            j_tp["rgb_all"][k], j_tp["bkgd_msk_all"][k])
    loss = j_trainer.make_loss_fn(model, j_trainer.TrainConfig(**cfg), smooth)
    grads, (terms, new_bs, _) = jax.jit(jax.grad(
        lambda p, bs: loss(p, bs, scene["j_smpl"], j_sp, j_tp, *rays, key),
        has_aux=True))(variables["params"], variables["batch_stats"])
    delta = 0.01 * jax.random.normal(jax.random.split(key, 3)[1],
                                     (N_RAYS * N_SAMPLES, 3), jnp.float32)

    t_model.load_state_dict(from_jax(variables), strict=True)
    t_model.zero_grad(set_to_none=True)
    t_loss = t_trainer.make_loss_fn(t_model, t_trainer.TrainConfig(**cfg),
                                    smooth)
    total, (t_terms, _) = t_loss(
        scene["t_smpl"], t_sp, t_tp, *t_trainer.train_rays(t_tp, k, "cpu"),
        delta=torch.from_numpy(np.array(delta)))
    total.backward()
    for f in terms._fields:
        np.testing.assert_allclose(float(getattr(terms, f)),
                                   float(getattr(t_terms, f).detach()),
                                   atol=1e-5, err_msg=f)
    if pair:
        assert float(t_terms.img.detach()) == 0.0 < float(t_terms.img_raw.detach())
    assert (float(t_terms.smpl_normal.detach()) > 0) == smooth
    want = from_jax({"params": _np(grads),
                     "batch_stats": variables["batch_stats"]})
    fields = [n for n, _ in t_model.named_parameters()
              if n.split(".")[0] in ("forward_deform", "backward_correction",
                                     "backward_deform", "encoder_3d",
                                     "latent_codes")]
    assert fields
    for name_, p in t_model.named_parameters():
        g = want[name_].numpy()
        assert p.grad is not None, name_
        err = np.abs(p.grad.numpy() - g).max() / max(np.abs(g).max(), 1e-30)
        assert err <= grad_tol, (name_, err)
    assert any(float(np.abs(want[n].numpy()).max()) > 0 for n in fields)
    stats = from_jax({"params": variables["params"],
                      "batch_stats": _np(new_bs)})
    sd = t_model.state_dict()
    moved = 0
    for n_ in sd:
        if "running" in n_:
            np.testing.assert_allclose(sd[n_].numpy(), stats[n_].numpy(),
                                       atol=1e-5, err_msg=n_)
            moved += n_.startswith("encoder_3d") and not np.allclose(
                stats[n_].numpy(), from_jax(variables)[n_].numpy())
    assert moved == (10 if kw.get("correction_field") else 0)


