"""Parity of every option and variant of the port's ``MPSNeRF`` with the
JAX package, on the CPU: the factory's model strings and flags, ``query``
for each variant of the chip run's list (fp32 at 1e-5 of each output's
max; bf16 at ``tests/test_bf16.py``'s raw bound), and ``ViewRenderer``'s
pixels without the human mask and with the correction field.  (The view-
step gradients are in ``tests/test_torch_port_variant_grads.py``.)

The scene: the JAX synthetic rig at 500 vertices, 32^2, 2 input views, its
items fed to both packages; a source and a target pose for pair mode.  The
model is cut to the 2D encoder's first stage and a 32-wide, 3-deep MLP
(``SMALL``); the deform fields and the 3D encoder keep the JAX package's
fixed widths.  Weights: seeded
random arrays in the JAX tree's shapes (``jax.eval_shape`` of the init:
no compile), the correction fields' output layers scaled to move points
by millimetres, the BatchNorm statistics non-trivial; they cross over
through ``mpsnerf_torch.compat.from_jax``.  Each variant's JAX query is
compiled once (module fixture cache)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu import factory as j_factory
from mpsnerf_tpu.config import parse_args as j_parse_args
from mpsnerf_tpu.data import attach_spconv_plan as j_attach_spconv_plan
from mpsnerf_tpu.data.synthetic import SyntheticHumanDataset as JDataset
from mpsnerf_tpu.models.mps_nerf import MPSNeRF as JMPSNeRF
from mpsnerf_tpu.train import trainer as j_trainer

from mpsnerf_torch import factory as t_factory
from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.config import parse_args as t_parse_args
from mpsnerf_torch.data import attach_spconv_plan, to_device_input
from mpsnerf_torch.models.mps_nerf import MPSNeRF as TMPSNeRF
from mpsnerf_torch.smpl.model import synthetic_smpl
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


N_VERTS = 500
N_RAYS, N_SAMPLES = 16, 8
# narrow and shallow: the 2D encoder's first stage only, 2 input views
# (fewer ops for XLA to compile), the MLP 32 wide x 3 deep, a skip
SMALL = dict(num_instances=3, nerf_width=32, nerf_depth=3, nerf_skips=(1,),
             encoder_layers=1, n_input_views=2)

# the chip run's list of variants and flags (model strings as the factory
# maps them over the default flags)
CASES = {
    "coarse_batch": {},
    "direct_deform": dict(pe_condition=False),
    "correction_batch": dict(correction_field=True,
                             correction_style="instance"),
    "correction_batch_blend": dict(blend_rgb=True),
    "correction_field": dict(correction_field=True),
    "skinning_field": dict(skinning_field=True),
    "with_viewdirs": dict(with_viewdirs=True),
    "human_sample_0": dict(human_sample=False),
    "mean_shape": dict(mean_shape=True),
    "use_trans_0": dict(use_transformer=False),
    "append_rgb_0": dict(append_rgb=False),
    "encoder_layers_3": dict(encoder_layers=3),  # over SMALL's 1
    "bfloat16": dict(compute_dtype="bfloat16"),
}
# pair mode's query is held in tests/test_torch_port_variant_grads.py
PAIR_CASE = dict(correction_field=True, pair_mode=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def random_variables(shapes, seed=0):
    """Seeded arrays in the shapes of a JAX variables tree: Dense and conv
    kernels U(+-1/sqrt(fan_in)), biases U(+-0.1), BatchNorm scales and
    variances U(0.8, 1.2), means U(+-0.05), embeddings N(0, 0.1); the
    correction fields' output layers x 1e-2 (millimetre moves)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        names = [getattr(p, "key", "") for p in path]
        name, shape = names[-1], x.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
            if "out" in names and any(n in names for n in (
                    "forward_deform", "backward_correction")):
                v = v * 1e-2
        elif name == "bias":
            v = rng.uniform(-0.1, 0.1, shape)
            if "out" in names and any(n in names for n in (
                    "forward_deform", "backward_correction")):
                v = v * 1e-2
        elif name in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            v = rng.uniform(-0.05, 0.05, shape)
        elif name == "embedding":
            v = rng.normal(0, 0.1, shape)
        else:
            raise AssertionError(names)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _items(n_poses=2, split="train", input_views=(0, 2)):
    ds = JDataset(n_poses=n_poses, n_cameras=4, input_views=list(input_views),
                  image_size=32, n_rays=N_RAYS, n_verts=N_VERTS,
                  num_instances=1, split=split)
    items = []
    for p in range(n_poses):
        it = ds.get_item(p, instance_idx=0)
        it["instance_idx"] = np.int32(2 - p)  # another code per pose
        items.append(it)
    return ds.smpl_for(0), items


def _inputs(items):
    """Each package's device items, with its own sparse-conv plan."""
    j_inp = [j_trainer.to_device_input(j_attach_spconv_plan(dict(it)))
             for it in items]
    t_inp = [to_device_input(attach_spconv_plan(dict(it)), "cpu", rays=True)
             for it in items]
    return j_inp, t_inp


@pytest.fixture(scope="module")
def scene():
    j_smpl, items = _items()
    j_inp, t_inp = _inputs(items)
    rng = np.random.default_rng(0)
    v = items[1]["vertices"]
    near = v[rng.integers(0, len(v), 384)] + rng.normal(size=(384, 3)) * 0.03
    far = rng.uniform(v.min(0) - 0.2, v.max(0) + 0.2, (128, 3))
    pts = np.concatenate([near, far]).astype(np.float32)
    vd = rng.normal(size=pts.shape).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return dict(j_smpl=j_smpl, j_inp=j_inp, t_inp=t_inp, pts=pts, vd=vd,
                t_smpl=synthetic_smpl(n_verts=N_VERTS, seed=0, device="cpu"),
                models={})


def _pair(scene, kw):
    """(JAX model, variables, port model) of a variant, built once."""
    key = tuple(sorted(kw.items()))
    if key not in scene["models"]:
        kw = dict(SMALL, **kw)
        model = JMPSNeRF(**kw)
        inp = scene["j_inp"][0]
        shapes = jax.eval_shape(lambda k: model.init(
            {"params": k}, scene["j_smpl"], inp, inp, jnp.zeros((8, 3)),
            jnp.ones((8, 3)), train=False), jax.random.PRNGKey(0))
        variables = random_variables(shapes)
        t_model = TMPSNeRF(**kw)
        t_model.load_state_dict(from_jax(variables), strict=True)
        scene["models"][key] = (model, variables, t_model)
    return scene["models"][key]


def _sp_tp(scene, kw, jax_side):
    inp = scene["j_inp"] if jax_side else scene["t_inp"]
    return (inp[0], inp[1]) if kw.get("pair_mode") else (inp[1], inp[1])


@pytest.mark.parametrize("name", list(CASES))
def test_query_matches_jax(scene, name):
    """``query`` in eval mode: pts_mask and n_dropped exact; rgb, sigma,
    the source-pose points, the corrections and the blend weights within
    1e-5 of each output's max |value| (fp32), or the raw bound 0.05 of
    ``tests/test_bf16.py`` on in-body rgb and sigma (bf16: XLA's CPU and
    torch's accumulate bf16 products differently)."""
    kw = CASES[name]
    model, variables, t_model = _pair(scene, kw)
    j_sp, j_tp = _sp_tp(scene, kw, True)
    t_sp, t_tp = _sp_tp(scene, kw, False)
    pts, vd = scene["pts"], scene["vd"]

    @jax.jit
    def run(v, p, d):
        lat = model.apply(v, j_sp["img_all"], method="encode")
        return model.apply(v, scene["j_smpl"], j_sp, j_tp, lat, p, d,
                           train=False, method="query")

    j = run(variables, jnp.asarray(pts), jnp.asarray(vd))
    t_model.eval()
    with torch.no_grad():
        lat = t_model.encode(t_sp["img_all"])
        t = t_model.query(scene["t_smpl"], t_sp, t_tp, lat,
                          torch.from_numpy(pts), torch.from_numpy(vd))
    np.testing.assert_array_equal(np.asarray(j.pts_mask), t.pts_mask.numpy())
    assert int(j.n_dropped) == int(t.n_dropped) == 0
    mask = t.pts_mask.numpy() > 0
    if kw.get("human_sample") is False:
        assert mask.all()
    else:
        assert 0.3 < mask.mean() < 0.95
    if kw.get("compute_dtype") == "bfloat16":
        assert t.rgb.dtype == torch.float32
        for f in ("rgb", "sigma"):
            np.testing.assert_allclose(
                np.asarray(getattr(j, f))[mask],
                getattr(t, f).numpy()[mask], atol=0.05, err_msg=f)
        return
    for f in ("rgb", "sigma", "smpl_src_pts", "world_src_pts", "bweights",
              "correction", "correction_"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        scale = max(float(np.abs(a).max()), 1e-30)
        assert np.abs(a - b).max() <= 1e-5 * scale, \
            (f, float(np.abs(a - b).max()), scale)
    moved = {f: float(np.abs(getattr(t, f).numpy()).max())
             for f in ("correction", "correction_")}
    if kw.get("correction_field"):
        assert moved["correction"] > 1e-5
        assert (moved["correction_"] > 1e-5) == \
            (kw.get("correction_style") == "instance")
    else:
        assert moved == {"correction": 0.0, "correction_": 0.0}


@functools.lru_cache(maxsize=None)
def _factory_scene():
    j_smpl, items = _items(1, input_views=(0, 1, 2))  # the config's 3
    return j_smpl, _inputs(items)[0][0]


def _flag_args(parse, model, **over):
    args = parse(["--model", model, "--num_instance", "2"])
    for k, v in over.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("model,over", [
    (m, {}) for m in ("skinning_batch", "coarse_batch", "correction_batch",
                      "direct_deform", "correction_batch_blend")] + [
    ("skinning_batch", {flag: 1}) for flag in (
        "correction_field", "skinning_field", "with_viewdirs",
        "mean_shape")] + [
    ("skinning_batch", {flag: 0}) for flag in (
        "use_trans", "append_rgb", "human_sample")] + [
    ("skinning_batch", {"compute_dtype": "bfloat16"}),
    ("correction_batch", {"data_set_type": "H36M_P"}),
])
def test_factory_builds_what_jax_builds(model, over):
    """Every model string of JAX's ``_MODEL_VARIANTS`` and every flag: the
    same field values as the JAX factory's model, and a state dict in the
    shapes of the JAX init (through ``from_jax``)."""
    t = t_factory.return_model(_flag_args(t_parse_args, model, **over))
    j = j_factory.return_model(_flag_args(j_parse_args, model, **over))
    for f in ("num_instances", "use_transformer", "append_rgb",
              "with_viewdirs", "human_sample", "mean_shape",
              "correction_field", "skinning_field", "correction_style",
              "pe_condition", "compute_dtype", "pair_mode", "blend_rgb",
              "n_input_views", "compact_fraction"):
        assert getattr(t, f) == getattr(j, f), f
    j_smpl, inp = _factory_scene()
    shapes = jax.eval_shape(lambda k: j.init(
        {"params": k}, j_smpl, inp, inp, jnp.zeros((8, 3)),
        jnp.ones((8, 3)), train=False), jax.random.PRNGKey(0))
    want = from_jax(random_variables(shapes))
    sd = t.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(tuple(sd[k].shape) == tuple(want[k].shape) for k in sd)


@pytest.mark.parametrize("name", ["correction_by_f3d",
                                  "correction_by_uvh_agg_fagg", "nope"])
def test_factory_refuses_what_is_not_ported(name):
    """Only a name outside the JAX factory's is refused; the numpy-era
    models, refused until they were ported, build (their parity is in
    ``tests/test_torch_port_legacy.py``)."""
    args = t_parse_args(["--model", name])
    if name == "nope":
        with pytest.raises(NotImplementedError, match="not available"):
            t_factory.return_model(args)
        return
    want = ("CorrectionF3D" if name.startswith("correction_by_f3d")
            else "CorrectionUvhAgg")
    assert type(t_factory.return_model(args)).__name__ == want


def test_bn_axis_name_raises():
    """``bn_axis_name`` builds (cross-replica BatchNorm, trained under a
    mesh in ``tests/test_torch_port_parallel.py``); a train-mode encode
    outside a bound mesh raises, an eval-mode one runs."""
    model = TMPSNeRF(bn_axis_name="batch", **SMALL)
    imgs = torch.rand(2, 3, 16, 16)
    with pytest.raises(RuntimeError, match="'batch' is not bound"):
        model.train().encode(imgs)
    assert model.eval().encode(imgs).shape == (2, 64, 4, 4)


@pytest.mark.parametrize("name", ["human_sample_0", "correction_batch"])
def test_view_renderer_pixels_match_jax(scene, name):
    """A 32^2 view through both ``ViewRenderer``s at 8 samples: without the
    human mask both take the chunked path over every ray, uncompacted (no
    box cull); the correction field takes the global path with the fine
    pre-pass, its plans attached by the renderer.  Pixels at 1e-4 (the
    fp32 tail), the rays run equal."""
    from mpsnerf_tpu.eval import runner as j_runner

    from mpsnerf_torch.eval import runner as t_runner

    kw = CASES[name]
    model, variables, t_model = _pair(scene, kw)
    item = _items(split="test")[1][1]
    opts = dict(chunk=256, n_samples=N_SAMPLES, eval_compact_fraction=0.5)
    j_r = j_runner.ViewRenderer(model, lambda g: scene["j_smpl"], **opts)
    j_item = dict(item)
    j = j_r.render_view(variables, j_item, j_item, 2)
    t_r = t_runner.ViewRenderer(t_model, lambda g: scene["t_smpl"],
                                device="cpu", **opts)
    t_item = dict(item)
    t = t_r.render_view(t_item, t_item, 2)
    stats = t_r.last_view
    assert t_r.global_compact == (name == "correction_batch")
    assert "spconv_plan" in t_item if name == "correction_batch" else \
        stats.hit_rays == 32 * 32
    assert stats.n_dropped == 0 and np.isfinite(t).all()
    assert t.shape == (32 * 32, 3) and float(np.abs(t).max()) > 0
    np.testing.assert_allclose(np.asarray(j), t, atol=1e-4)
