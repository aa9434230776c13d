"""How far fp32 rounding moves ``CorrectionUvhAgg``'s outputs and view-step
gradients in each package, on the scene of
``tests/test_torch_port_legacy_grads.py``, over several weight seeds.

For each seed and each package: the largest distance, over the query's
rgb, sigma and backward correction and over the parameters' gradients of
a plain view-step, of the fp32 value from the same package's float64
value (JAX under ``enable_x64``), each relative to the float64 tensor's
max |value|; and the two packages' float64 values against each other.
It shows whether the port's fp32 is any worse than the JAX package's.
Then the port's query again with one operation in float64, the LBS blend
of the 24 bone transforms (``smpl/lbs.py:_blend_A``, a K = 24 fp32
matrix product), and that product alone on random blends in torch and
in XLA against float64.

Run from the repository root on the CPU (about 2 minutes)::

    JAX_PLATFORMS=cpu python -m tests.torch_port_fp32_drift [--seeds 0 1 2 3 4]
"""

import argparse
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpsnerf_tpu.train import trainer as j_trainer

from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.models import correction_f3d as t_corr
from mpsnerf_torch.smpl import lbs as t_lbs
from mpsnerf_torch.train import trainer as t_trainer

from tests import test_torch_port_legacy as legacy
from tests.test_torch_port_legacy import _cast, _f64
from tests.test_torch_port_legacy_grads import GRAD_CASES, body_rays
from tests.test_torch_port_variants import N_RAYS, N_SAMPLES, _np

NAME = "correction_by_uvh_agg"
FIELDS = ("rgb", "sigma", "correction_")


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300))


def _jax_run(model, scene, variables, rays, x64):
    """JAX's query outputs and plain-step gradients (port names)."""
    j_inp, smpl = scene["j_inp"][1], scene["j_smpl"]
    dt = jnp.float64 if x64 else jnp.float32
    if x64:
        j_inp, smpl, variables = _f64(j_inp), _f64(smpl), _f64(variables)
    pts, vd = jnp.asarray(scene["pts"], dt), jnp.asarray(scene["vd"], dt)
    lat = model.apply(variables, j_inp["img_all"], method="encode")
    out = model.apply(variables, smpl, j_inp, j_inp, lat, pts, vd,
                      train=False, method="query")
    loss = j_trainer.make_loss_fn(
        model, j_trainer.TrainConfig(n_samples=N_SAMPLES, perturb=0.0),
        False)
    grads, _ = jax.jit(jax.grad(
        lambda p, bs: loss(p, bs, smpl, j_inp, j_inp,
                           *(jnp.asarray(r, dt) for r in rays),
                           jax.random.PRNGKey(5)),
        has_aux=True))(variables["params"], variables["batch_stats"])
    g = from_jax({"params": _np(grads),
                  "batch_stats": _np(variables["batch_stats"])})
    return ({f: np.asarray(getattr(out, f)) for f in FIELDS},
            {n: v.numpy() for n, v in g.items()})


def _port_run(t_model, scene, rays, dt):
    """The port's query outputs and plain-step gradients."""
    m = copy.deepcopy(t_model).to(dt)
    inp, smpl = _cast(scene["t_inp"][1], dt), _cast(scene["t_smpl"], dt)
    m.eval()
    with torch.no_grad():
        lat = m.encode(inp["img_all"])
        out = m.query(smpl, inp, inp, lat,
                      torch.from_numpy(scene["pts"]).to(dt),
                      torch.from_numpy(scene["vd"]).to(dt))
    outs = {f: getattr(out, f).double().numpy() for f in FIELDS}
    m.train()
    loss = t_trainer.make_loss_fn(
        m, t_trainer.TrainConfig(n_samples=N_SAMPLES, perturb=0.0), False)
    total, _ = loss(smpl, inp, inp, *(torch.from_numpy(r).to(dt)
                                      for r in rays))
    total.backward()
    return outs, {n: p.grad.double().numpy()
                  for n, p in m.named_parameters()}


@contextlib.contextmanager
def _blend_in_float64():
    """The port's blend of the bone transforms computed in float64."""
    orig = t_lbs._blend_A

    def blend(bweights, A):
        return orig(bweights.double(), A.double()).to(bweights.dtype)

    t_lbs._blend_A = blend
    try:
        yield
    finally:
        t_lbs._blend_A = orig


def _blend_product_errors(seed=0, n=4096):
    """Max |error| against float64 of (n, 24) blend weights x (24, 16) in
    fp32: torch's matmul and XLA's dot."""
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.full(24, 0.3), n).astype(np.float32)
    a = rng.normal(size=(24, 16)).astype(np.float32)
    ref = w.astype(np.float64) @ a.astype(np.float64)
    t = (torch.from_numpy(w) @ torch.from_numpy(a)).double().numpy()
    j = np.asarray(jax.jit(jnp.matmul)(w, a), np.float64)
    return float(np.abs(t - ref).max()), float(np.abs(j - ref).max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    seeds = ap.parse_args(argv).seeds
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    scene = legacy.scene._fixture_function()
    cls, kw = GRAD_CASES[NAME]
    model, _, _ = legacy._pair(scene, cls, kw)
    inp = scene["j_inp"][1]
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, scene["j_smpl"], inp, inp, jnp.zeros((8, 3)),
        jnp.ones((8, 3)), train=False), jax.random.PRNGKey(0))
    rays = body_rays(scene["items"][1], 1)
    assert rays[0].shape[0] == N_RAYS
    print(f"{NAME}: fp32 against the same package's float64, relative to "
          "the float64 tensor's max |value| (query: the max over "
          f"{', '.join(FIELDS)}; gradients: the max over parameters)")
    for seed in seeds:
        variables = legacy.legacy_variables(shapes, seed)
        t_model = getattr(t_corr, cls)(**kw)
        t_model.load_state_dict(from_jax(variables), strict=True)
        jq32, jg32 = _jax_run(model, scene, variables, rays, False)
        with jax.enable_x64(True):
            jq64, jg64 = _jax_run(model, scene, variables, rays, True)
        tq32, tg32 = _port_run(t_model, scene, rays, torch.float32)
        tq64, tg64 = _port_run(t_model, scene, rays, torch.float64)
        with _blend_in_float64():
            bq32, _ = _port_run(t_model, scene, rays, torch.float32)
        q = [max(_rel(a[f], b[f]) for f in FIELDS)
             for a, b in ((jq32, jq64), (tq32, tq64), (tq64, jq64),
                          (bq32, tq64))]
        g = {n: (_rel(jg32[n], jg64[n]), _rel(tg32[n], tg64[n]),
                 _rel(tg64[n], jg64[n])) for n in tg32}
        worst = [max(v[i] for v in g.values()) for i in range(3)]
        at = [max(g, key=lambda n, i=i: g[n][i]) for i in range(2)]
        print(f"seed {seed}: query JAX {q[0]:.3g}, port {q[1]:.3g}, port "
              f"with the blend in float64 {q[3]:.3g} (float64 port vs JAX "
              f"{q[2]:.3g}); gradients JAX "
              f"{worst[0]:.3g} ({at[0]}), port {worst[1]:.3g} ({at[1]}) "
              f"(float64 port vs JAX {worst[2]:.3g})", flush=True)
    t_err, j_err = _blend_product_errors()
    print(f"the blend product alone, (4096, 24) x (24, 16) fp32, max |error| "
          f"against float64: torch matmul {t_err:.3g}, XLA dot {j_err:.3g}")


if __name__ == "__main__":
    main()
