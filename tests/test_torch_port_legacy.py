"""Parity of the port's numpy-era models with the JAX package, on the CPU:
``CorrectionF3D`` and ``CorrectionUvhAgg`` (``query`` of the four
``correction_by_*`` models, the view renderer's chunked path),
``VanillaNeRF`` and ``get_embedder``, and the factory's four names.  (A
plain and a smooth view-step of two of them are in
``tests/test_torch_port_legacy_grads.py``.)

The scene is ``tests/test_torch_port_variants.py``'s (the JAX synthetic
rig at 500 vertices, 32^2, 2 input views), each package's items with the
posed and the canonical sparse-conv plans.  The models are cut to
``SMALL``'s widths where the JAX constructor takes them (the MLP 32 wide
x 3 deep; the 2D encoder's first stage, except with the transformer,
whose width the JAX class fixes at 128).  Weights: seeded arrays in the
JAX tree's shapes (``random_variables``), both correction fields' output
layers scaled to millimetre moves (non-zero: the zero init would compare
0 with 0), carried over by ``from_jax``."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu import factory as j_factory
from mpsnerf_tpu.config import parse_args as j_parse_args
from mpsnerf_tpu.data import attach_spconv_plan as j_attach_spconv_plan
from mpsnerf_tpu.models import correction_f3d as j_corr
from mpsnerf_tpu.models import vanilla_nerf as j_vanilla
from mpsnerf_tpu.train import trainer as j_trainer

from mpsnerf_torch import factory as t_factory
from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.config import parse_args as t_parse_args
from mpsnerf_torch.data import attach_spconv_plan, to_device_input
from mpsnerf_torch.models import correction_f3d as t_corr
from mpsnerf_torch.models import vanilla_nerf as t_vanilla
from mpsnerf_torch.smpl.model import synthetic_smpl

from tests.test_torch_port_variants import (
    N_SAMPLES,
    N_VERTS,
    _items,
    random_variables,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

NARROW = dict(nerf_width=32, nerf_depth=3, nerf_skips=(1,))
# name -> (class name, constructor flags)
CASES = {
    "correction_by_f3d": ("CorrectionF3D", dict(
        NARROW, encoder_layers=1, human_sample=True)),
    "correction_by_f3d_fagg": ("CorrectionF3D", dict(
        NARROW, use_agg=True, use_transformer=True, with_viewdirs=True,
        human_sample=True)),
    "correction_by_uvh_agg": ("CorrectionUvhAgg", dict(
        NARROW, encoder_layers=1)),
    "correction_by_uvh_agg_fagg": ("CorrectionUvhAgg", dict(
        NARROW, encoder_layers=1, use_agg=True)),
}
def legacy_variables(shapes, seed=0):
    """``random_variables``, with both correction fields' output layers
    at millimetre moves (it scales only ``forward_deform``'s here)."""
    v = random_variables(shapes, seed)
    out = v["params"]["backward_deform"]["out"]["Dense_0"]
    for k in out:
        out[k] = out[k] * np.float32(1e-2)
    return v


@pytest.fixture(scope="module")
def scene():
    j_smpl, items = _items()
    j_inp = [j_trainer.to_device_input(
        j_attach_spconv_plan(dict(it), canonical=True)) for it in items]
    t_inp = [to_device_input(attach_spconv_plan(dict(it), canonical=True),
                             "cpu", rays=True) for it in items]
    rng = np.random.default_rng(0)
    v = items[1]["vertices"]
    near = v[rng.integers(0, len(v), 384)] + rng.normal(size=(384, 3)) * 0.03
    far = rng.uniform(v.min(0) - 0.2, v.max(0) + 0.2, (128, 3))
    pts = np.concatenate([near, far]).astype(np.float32)
    vd = rng.normal(size=pts.shape).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return dict(j_smpl=j_smpl, j_inp=j_inp, t_inp=t_inp, pts=pts, vd=vd,
                items=items, models={},
                t_smpl=synthetic_smpl(n_verts=N_VERTS, seed=0, device="cpu"))


def _pair(scene, cls, kw):
    """(JAX model, variables, port model), built once per configuration."""
    key = (cls, tuple(sorted(kw.items())))
    if key not in scene["models"]:
        model = getattr(j_corr, cls)(**kw)
        inp = scene["j_inp"][1]
        shapes = jax.eval_shape(lambda k: model.init(
            {"params": k}, scene["j_smpl"], inp, inp, jnp.zeros((8, 3)),
            jnp.ones((8, 3)), train=False), jax.random.PRNGKey(0))
        variables = legacy_variables(shapes)
        t_model = getattr(t_corr, cls)(**kw)
        t_model.load_state_dict(from_jax(variables), strict=True)
        scene["models"][key] = (model, variables, t_model)
    return scene["models"][key]


def _cast(x, dtype):
    """The floating tensors of an item, plan or rig in ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cast(v, dtype) for v in x))
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _cast(getattr(x, f.name), dtype)
            for f in dataclasses.fields(x)})
    return x


def _f64(tree):
    """The floating arrays of a JAX tree in float64 (under ``enable_x64``)."""
    return jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def _close(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(a).max()), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, \
        (what, float(np.abs(a - b).max()), scale)


QUERY_FIELDS = ("rgb", "sigma", "correction", "correction_",
                "smpl_query_pts", "smpl_src_pts", "world_src_pts", "bweights",
                "occ_normal", "nearest_smpl_normal")


def _queries(scene, model, variables, t_model, dtype):
    """Both packages' eval-mode ``query`` with ``compute_normals`` in
    ``dtype`` (JAX's float64 under ``enable_x64``)."""
    x64 = dtype == torch.float64
    j_inp, j_smpl, j_vars = scene["j_inp"][1], scene["j_smpl"], variables
    t_inp, t_smpl, t_mod = scene["t_inp"][1], scene["t_smpl"], t_model
    if x64:
        j_inp, j_smpl, j_vars = _f64(j_inp), _f64(j_smpl), _f64(variables)
        t_inp, t_smpl = _cast(t_inp, dtype), _cast(t_smpl, dtype)
        t_mod = copy.deepcopy(t_model).to(dtype)

    @jax.jit
    def run(v, inp, smpl, p, d):
        lat = model.apply(v, inp["img_all"], method="encode")
        return model.apply(v, smpl, inp, inp, lat, p, d, train=False,
                           compute_normals=True, method="query")

    jdt = jnp.float64 if x64 else jnp.float32
    j = run(j_vars, j_inp, j_smpl, jnp.asarray(scene["pts"], jdt),
            jnp.asarray(scene["vd"], jdt))
    t_mod.eval()
    with torch.no_grad():
        lat = t_mod.encode(t_inp["img_all"])
        t = t_mod.query(t_smpl, t_inp, t_inp, lat,
                        torch.from_numpy(scene["pts"]).to(dtype),
                        torch.from_numpy(scene["vd"]).to(dtype),
                        compute_normals=True)
    return j, t


@pytest.mark.parametrize("name", list(CASES))
def test_query_matches_jax(scene, name):
    """``query`` in eval mode with ``compute_normals``: pts_mask exact;
    rgb, sigma, both corrections, the query and source-pose points, the
    world source points, the blend weights and the Jacobian norms (zeros
    for ``CorrectionUvhAgg``) within 1e-5 of each output's max |value|.

    ``CorrectionUvhAgg``'s NeRF and backward field read PE10 of the
    canonical points, whose top frequency (512 pi) turns fp32 rounding of
    those points into ~1e-4 changes of the encoding; its query is held in
    float64 in both packages (JAX under ``enable_x64``) at 1e-5, and in
    fp32 at 1e-4 for rgb, sigma and the backward correction (each
    package's fp32 is 2e-5 to 1e-4 from its own float64 there:
    ``tests/torch_port_fp32_drift.py``)."""
    cls, kw = CASES[name]
    model, variables, t_model = _pair(scene, cls, kw)
    j, t = _queries(scene, model, variables, t_model, torch.float32)
    np.testing.assert_array_equal(np.asarray(j.pts_mask), t.pts_mask.numpy())
    mask = t.pts_mask.numpy() > 0
    assert (0.3 < mask.mean() < 0.95) if kw.get("human_sample") \
        else mask.all()
    for f in QUERY_FIELDS:
        pe10 = cls == "CorrectionUvhAgg" and f in ("rgb", "sigma",
                                                   "correction_")
        _close(getattr(j, f), getattr(t, f).numpy(), 1e-4 if pe10 else 1e-5,
               f)
    for f in ("correction", "correction_"):
        assert float(np.abs(getattr(t, f).numpy()).max()) > 1e-5, f
    norms = [float(np.abs(getattr(t, f).numpy()).max())
             for f in ("occ_normal", "nearest_smpl_normal")]
    assert (min(norms) > 0) if cls == "CorrectionF3D" else max(norms) == 0
    if cls == "CorrectionUvhAgg":
        with jax.enable_x64(True):
            j, t = _queries(scene, model, variables, t_model, torch.float64)
            j = jax.tree.map(np.asarray, j)
        assert t.rgb.dtype == torch.float64 and j.rgb.dtype == np.float64
        for f in QUERY_FIELDS:
            _close(getattr(j, f), getattr(t, f).numpy(), 1e-5, f)


@pytest.mark.parametrize("use_viewdirs", [False, True])
def test_vanilla_nerf_matches_jax(use_viewdirs):
    """``get_embedder`` (10 and 4 frequencies, and the identity) and
    ``VanillaNeRF`` on the embedded points [and view directions] to
    1e-6."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    outs = []
    for m, i in ((10, 0), (4, 0), (5, -1)):
        jf, jdim = j_vanilla.get_embedder(m, i)
        tf, tdim = t_vanilla.get_embedder(m, i)
        assert jdim == tdim
        np.testing.assert_allclose(np.asarray(jf(jnp.asarray(x))),
                                   tf(torch.from_numpy(x)).numpy(),
                                   atol=1e-6)
        outs.append(np.asarray(jf(jnp.asarray(x if len(outs) != 1 else d))))
    inp = np.concatenate(outs[:2] if use_viewdirs else outs[:1], axis=-1)
    kw = dict(input_ch=63, input_ch_views=27 if use_viewdirs else 3,
              use_viewdirs=use_viewdirs, output_ch=5)
    j_model = j_vanilla.VanillaNeRF(**kw)
    shapes = jax.eval_shape(lambda k: j_model.init(k, jnp.asarray(inp)),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=1)
    t_model = t_vanilla.VanillaNeRF(**kw)
    t_model.load_state_dict(from_jax(variables), strict=True)
    j = np.asarray(j_model.apply(variables, jnp.asarray(inp)))
    with torch.no_grad():
        t = t_model(torch.from_numpy(inp)).numpy()
    assert j.shape == t.shape == (64, 4 if use_viewdirs else 5)
    np.testing.assert_allclose(j, t, atol=1e-6)


@pytest.mark.parametrize("name,over", [
    ("correction_by_f3d", {}),
    ("correction_by_f3d_fagg", {"use_f2d": 1, "use_trans": 1,
                                "with_viewdirs": 1, "human_sample": 1}),
    ("correction_by_uvh_agg", {}),
    ("correction_by_uvh_agg_fagg", {"use_f2d": 1}),
])
def test_factory_builds_the_legacy_models(scene, name, over):
    """The factory's four names: the JAX factory's class with its flags,
    and a state dict in the shapes of the JAX init at full width
    (``jax.eval_shape``: nothing compiles) through ``from_jax``."""
    def args_of(parse):
        args = parse(["--model", name])
        for k, v in over.items():
            setattr(args, k, v)
        return args

    t = t_factory.return_model(args_of(t_parse_args))
    j = j_factory.return_model(args_of(j_parse_args))
    assert type(t).__name__ == type(j).__name__
    for f in ("use_agg", "use_f2d", "with_viewdirs", "human_sample",
              "use_transformer", "correction_field", "canonical_grid",
              "compact_fraction"):
        assert getattr(t, f, None) == getattr(j, f, None), f
    inp = scene["j_inp"][1]
    shapes = jax.eval_shape(lambda k: j.init(
        {"params": k}, scene["j_smpl"], inp, inp, jnp.zeros((8, 3)),
        jnp.ones((8, 3)), train=False), jax.random.PRNGKey(0))
    want = from_jax(legacy_variables(shapes))
    sd = t.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(tuple(sd[k].shape) == tuple(want[k].shape) for k in sd)


@pytest.mark.parametrize("name", ["correction_by_f3d",
                                  "correction_by_uvh_agg_fagg"])
def test_view_renderer_takes_the_chunked_path(scene, name):
    """A 32^2 view of each class through both ``ViewRenderer``s at 8
    samples: the port takes the chunked path (no global compaction, no
    box cull) although ``CorrectionF3D`` has the human mask, attaches the
    canonical plans itself, and its pixels equal a direct ``render_rays``
    of the first chunk's rays and the JAX renderer's view, to 1e-5."""
    from mpsnerf_tpu.eval import runner as j_runner

    from mpsnerf_torch.eval import runner as t_runner
    from mpsnerf_torch.renderer.render import render_rays

    cls, kw = CASES[name]
    model, variables, t_model = _pair(scene, cls, kw)
    item = _items(split="test")[1][1]
    opts = dict(chunk=256, n_samples=N_SAMPLES, shuffle_rays=False)
    j_item = dict(item)
    j = j_runner.ViewRenderer(model, lambda g: scene["j_smpl"],
                              **opts).render_view(variables, j_item, j_item,
                                                  1)
    r = t_runner.ViewRenderer(t_model, lambda g: scene["t_smpl"],
                              device="cpu", **opts)
    t_item = dict(item)
    t = r.render_view(t_item, t_item, 1)
    assert not r.global_compact and not r.box_cull
    assert "t_spconv_plan" in t_item and "t_spconv_plan" in j_item
    assert r.last_view.hit_rays == 32 * 32 and r.last_view.n_dropped == 0
    assert np.isfinite(t).all() and float(np.abs(t).max()) > 0
    np.testing.assert_allclose(np.asarray(j), t, atol=1e-5)

    tp = to_device_input(t_item, "cpu", rays=True)
    rays = [torch.as_tensor(np.asarray(t_item[key][1], np.float32)
                            ).reshape(-1, *shape)[:256]
            for key, shape in (("ray_o_all", (3,)), ("ray_d_all", (3,)),
                               ("near_all", ()), ("far_all", ()))]
    with torch.no_grad():
        ref = render_rays(t_model, scene["t_smpl"], tp, tp,
                          t_model.encode(tp["img_all"]), *rays, N_SAMPLES,
                          perturb=0.0, train=False)
    np.testing.assert_allclose(t[:256], ref.rgb_map.numpy(), atol=1e-5)
