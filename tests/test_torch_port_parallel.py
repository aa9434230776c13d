"""Parity of the port's multi-device training and render
(``mpsnerf_torch/parallel``) with the JAX package, on CPU gloo ranks.

One module fixture starts 4 ranks (``tests/torch_mesh_workers.py:
mesh_rank``, spawned, one torch thread each) as a (data 2, ray 2) mesh and,
while they run, computes the JAX references in this process.  The scene:
the JAX synthetic rig at 400 vertices, 32^2, 2 input views, two items
(poses 0 and 1, one a data row) of 32 train rays, 8 samples, perturb 0;
the ``SMALL`` widths of ``tests/test_torch_port_variants.py`` with its
seeded random weights through ``compat.from_jax``; the port's model with
``bn_axis_name="ray"`` (a row's ranks encode one item's images, so the
cross-replica statistics equal each rank's own).  The port shards an
item's rays by stride (ray index s takes rays s, s + 2, ...), and the
references slice them so; the loader's body-first order stays as it is.

* the plain mesh step against JAX: loss terms within 1e-5 of the mean of
  ``make_loss_fn`` over the 2 items x 2 strided ray shards, every
  reduced gradient within 1e-4 of its tensor's max |grad| (the
  single-device parity tolerance) of the mean of ``jax.grad``, the
  averaged BatchNorm statistics at 1e-5;
* the smooth mesh step (the ranks' deltas injected) against the port's
  single-process per-shard mean on the weights after the plain step:
  terms at 1e-5, gradients at 1e-5 of each tensor's max;
* parameters bit-equal across the ranks after each of the two steps;
* cross-replica ``BatchNorm2d`` on the ray axis (2 ranks) against flax's
  ``nn.BatchNorm(axis_name=...)`` under ``shard_map`` on 2 virtual
  devices: output, running statistics, input gradient (of the summed
  losses of both devices);
* ``make_sharded_render`` on the 4 ranks against JAX's on 4 virtual
  devices, plain and compact (and the port's chunked path against JAX's
  plain one): pixels within 1e-4 (the fp32 tail), each rank's
  ``n_dropped`` 0;
* ``dryrun_multichip(4)`` (on a thread of the fixture, while the JAX
  references compile) prints its OK line.
"""

import contextlib
import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from mpsnerf_tpu.data import attach_body_grid as j_attach_body_grid
from mpsnerf_tpu.data.synthetic import SyntheticHumanDataset as JDataset
from mpsnerf_tpu.models.mps_nerf import MPSNeRF as JMPSNeRF
from mpsnerf_tpu.parallel.mesh import make_mesh as j_make_mesh
from mpsnerf_tpu.parallel.mesh import make_sharded_render as j_sharded_render
from mpsnerf_tpu.parallel.mesh import replicate_to_mesh as j_replicate
from mpsnerf_tpu.train import trainer as j_trainer

from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.data import to_device_input
from mpsnerf_torch.models.mps_nerf import MPSNeRF as TMPSNeRF
from mpsnerf_torch.parallel import collectives
from mpsnerf_torch.parallel.dryrun import dryrun_multichip
from mpsnerf_torch.parallel.launch import Ranks
from mpsnerf_torch.smpl.model import synthetic_smpl
from mpsnerf_torch.train import trainer as t_trainer
from tests.test_torch_port_variants import SMALL, random_variables
from tests.torch_mesh_workers import mesh_rank
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_VERTS, N_RAYS, N_SAMPLES = 400, 32, 8
SHARD = N_RAYS // 2
CFG = dict(n_samples=N_SAMPLES, perturb=0.0)
RENDER_TILE = 256  # the render's per-rank capacity: 32 rays x 8 samples


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bn_case():
    """Two devices' NCHW inputs and loss weights, flax's BatchNorm
    variables (non-trivial running statistics) and the port's state."""
    rng = np.random.default_rng(7)
    x = rng.normal(1.0, 2.0, (2, 3, 4, 5, 5)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    c = x.shape[2]
    v = {k: rng.uniform(lo, hi, c).astype(np.float32) for k, lo, hi in (
        ("scale", 0.8, 1.2), ("bias", -0.1, 0.1), ("mean", -0.05, 0.05),
        ("var", 0.8, 1.2))}
    state = {"weight": v["scale"], "bias": v["bias"],
             "running_mean": v["mean"], "running_var": v["var"]}
    return x, w, v, state


def _flax_bn(x, w, v):
    """flax's cross-replica BatchNorm under ``shard_map`` on 2 devices:
    ``(y, new mean, new var, d(sum of both devices' losses)/dx)``."""
    mesh = JMesh(np.asarray(jax.devices()[:2]), ("ray",))
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      epsilon=1e-5, axis_name="ray")
    variables = {"params": {"scale": v["scale"], "bias": v["bias"]},
                 "batch_stats": {"mean": v["mean"], "var": v["var"]}}

    def local(xs, ws):  # one device's (1, N, C, H, W)
        xl = jnp.transpose(xs[0], (0, 2, 3, 1))
        y, upd = bn.apply(variables, xl, mutable=["batch_stats"])
        y = jnp.transpose(y, (0, 3, 1, 2))
        return (y[None], upd["batch_stats"]["mean"][None],
                upd["batch_stats"]["var"][None], jnp.sum(y * ws[0])[None])

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P("ray"), P("ray")),
                       out_specs=(P("ray"),) * 4, check_vma=False)
    y, mean, var, _ = fn(x, w)
    grad = jax.grad(lambda xx: jnp.sum(fn(xx, w)[3]))(jnp.asarray(x))
    return np.asarray(y), np.asarray(mean), np.asarray(var), np.asarray(grad)


def _dryrun_in_thread():
    """``dryrun_multichip(4)`` on a thread, its printed lines kept: its
    ranks and references overlap the JAX references' compiles."""
    out = {}

    def body():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                out["result"] = dryrun_multichip(4, timeout_s=300)
            finally:
                out["text"] = buf.getvalue()

    thread = threading.Thread(target=body)
    thread.start()
    return thread, out


@pytest.fixture(scope="module")
def run():
    dryrun = _dryrun_in_thread()
    ds = JDataset(n_poses=2, n_cameras=4, input_views=[0, 2], image_size=32,
                  n_rays=N_RAYS, n_verts=N_VERTS, num_instances=1,
                  split="train")
    items = [ds.get_item(p, instance_idx=0) for p in (0, 1)]
    rng = np.random.default_rng(3)
    j_smpl = ds.smpl_for(0)
    j_inp = [j_trainer.to_device_input(it) for it in items]
    model = JMPSNeRF(**SMALL)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, j_smpl, j_inp[0], j_inp[0], jnp.zeros((8, 3)),
        jnp.ones((8, 3)), train=False), jax.random.PRNGKey(0))
    # the density head's bias at +4: the body renders opaque
    def opaque(path, x):
        names = [getattr(k, "key", "") for k in path]
        return x + 4.0 if "alpha_linear" in names and names[-1] == "bias" \
            else x

    variables = jax.tree_util.tree_map_with_path(opaque,
                                                 random_variables(shapes))
    state = {k: v.numpy() for k, v in from_jax(variables).items()}
    deltas = [(0.01 * rng.normal(size=(SHARD * N_SAMPLES, 3)))
              .astype(np.float32) for _ in range(4)]
    x, w, bn_v, bn_state = _bn_case()
    # the render: item 1's 4 views (128 rays)
    ro, rd, nr, fr = (np.concatenate(list(items[1][k])) for k in
                      ("ray_o_all", "ray_d_all", "near_all", "far_all"))
    nr, fr = nr[:, 0], fr[:, 0]
    ranks = Ranks(mesh_rank, 4, (
        state, SMALL, items, N_VERTS, CFG, deltas, (x, w, bn_state),
        (ro, rd, nr, fr, N_SAMPLES, RENDER_TILE, RENDER_TILE)),
        device="cpu", timeout_s=300, threads=1)

    # the JAX references, meanwhile: each item and ray shard's loss and
    # gradient (one compile), the sharded renders, flax's BatchNorm
    cfg = j_trainer.TrainConfig(**CFG)
    loss = j_trainer.make_loss_fn(model, cfg, False)
    grad_fn = jax.jit(jax.grad(
        lambda p, inp, *r: loss(p, variables["batch_stats"], j_smpl, inp,
                                inp, *r, jax.random.PRNGKey(0)),
        has_aux=True))
    shard_refs = []
    for inp in j_inp:
        for s in range(2):
            sl = slice(s, None, 2)
            r = (inp["ray_o_all"][0][sl], inp["ray_d_all"][0][sl],
                 inp["near_all"][0][sl, 0], inp["far_all"][0][sl, 0],
                 inp["rgb_all"][0][sl], inp["bkgd_msk_all"][0][sl])
            grads, (terms, new_bs, _) = grad_fn(variables["params"], inp, *r)
            shard_refs.append((_np(terms), _np(grads), _np(new_bs)))
    j_mesh = j_make_mesh(jax.devices()[:4])
    item = j_attach_body_grid(dict(items[1]))
    tp = j_trainer.to_device_input(item)
    latent = model.apply(variables, tp["img_all"], method="encode")
    rep = [j_replicate(a, j_mesh) for a in (variables, j_smpl, tp, tp,
                                            latent)]
    key = j_replicate(jax.random.PRNGKey(0), j_mesh)
    rays = [jnp.asarray(a) for a in (ro, rd, nr, fr)]
    renders = {
        "plain": j_sharded_render(model, j_mesh, N_SAMPLES)(
            *rep, *rays, key),
        "compact": j_sharded_render(model, j_mesh, N_SAMPLES,
                                    capacity=RENDER_TILE, tile=RENDER_TILE)(
            *rep, *rays, key)}
    bn_ref = _flax_bn(x, w, bn_v)
    results = ranks.wait(300)
    dryrun[0].join(300)
    return dict(results=results, dryrun=dryrun[1], shard_refs=shard_refs, variables=variables,
                renders={k: [np.asarray(t) for t in v]
                         for k, v in renders.items()},
                bn=bn_ref, items=items, deltas=deltas, state=state)


def _mean(trees):
    return jax.tree.map(lambda *xs: np.mean(np.stack(xs), axis=0), *trees)


def test_plain_mesh_step_matches_jax_item_and_shard_mean(run):
    terms = _mean([t for t, _, _ in run["shard_refs"]])
    grads = _mean([g for _, g, _ in run["shard_refs"]])
    stats = _mean([b for _, _, b in run["shard_refs"]])
    for r in run["results"]:
        assert r["steps"] == 2
        np.testing.assert_allclose(r["plain_terms"], [
            float(getattr(terms, f)) for f in terms._fields], atol=1e-5)
    r = run["results"][0]
    assert r["plain_terms"][-1] == 0  # n_dropped: no shard overflowed
    want = from_jax({"params": grads,
                     "batch_stats": _np(run["variables"]["batch_stats"])})
    for name, g in r["grads"].items():
        ref = want[name].numpy()
        err = np.abs(g - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= 1e-4, (name, err)
    want = from_jax({"params": _np(run["variables"]["params"]),
                     "batch_stats": stats})
    moved = 0
    for name, v in r["state_after_plain"].items():
        if "running" in name:
            np.testing.assert_allclose(v, want[name].numpy(), atol=1e-5,
                                       err_msg=name)
            moved += not np.allclose(v, run["state"][name])
    assert moved > 0


def test_smooth_mesh_step_matches_single_process_shard_mean(run):
    """The port's single-process loss and gradient of each (item, shard)
    with that rank's delta, on the weights after the plain step, averaged
    over the 4 shards."""
    model = TMPSNeRF(**SMALL)
    smpl = synthetic_smpl(n_verts=N_VERTS, seed=0, device="cpu")
    after = run["results"][0]["state_after_plain"]
    loss = t_trainer.make_loss_fn(model, t_trainer.TrainConfig(**CFG), True)
    terms, grads = [], []
    for d, item in enumerate(run["items"]):
        inp = to_device_input(item, "cpu", rays=True)
        rays = t_trainer.train_rays(inp, 0, "cpu")
        for s in range(2):
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in after.items()})
            model.zero_grad(set_to_none=True)
            sl = slice(s, None, 2)
            total, (t, _) = loss(smpl, inp, inp, *(x[sl] for x in rays),
                                 delta=torch.from_numpy(
                                     run["deltas"][2 * d + s]))
            total.backward(inputs=list(model.parameters()))
            terms.append([float(x.detach()) for x in t])
            grads.append({n: p.grad.numpy().copy()
                          for n, p in model.named_parameters()})
    want = np.mean(terms, axis=0)
    assert want[t._fields.index("smpl_normal")] > 0
    for r in run["results"]:
        np.testing.assert_allclose(r["smooth_terms"], want, atol=1e-5)
    for name, g in run["results"][0]["smooth_grads"].items():
        ref = np.mean([gr[name] for gr in grads], axis=0)
        err = np.abs(g - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= 1e-5, (name, err)


def test_parameters_bit_equal_across_ranks_after_two_steps(run):
    digests = [r["digests"] for r in run["results"]]
    assert all(d == digests[0] for d in digests)
    assert digests[0][0] != digests[0][1]
    assert [r["data_index"] for r in run["results"]] == [0, 0, 1, 1]


def test_cross_replica_batchnorm_matches_flax_shard_map(run):
    y, mean, var, grad = run["bn"]
    for r in run["results"]:
        i = r["rank"] % 2
        bn = r["bn"]
        np.testing.assert_allclose(bn["y"], y[i], atol=1e-5)
        np.testing.assert_allclose(bn["running_mean"], mean[i], atol=1e-6)
        np.testing.assert_allclose(bn["running_var"], var[i], atol=1e-6)
        np.testing.assert_allclose(bn["x_grad"], grad[i], atol=1e-5)


def test_bn_axis_outside_a_mesh_raises():
    from mpsnerf_torch.models.resnet import BatchNorm2d

    bn = BatchNorm2d(4, axis_name="ray").train()
    with pytest.raises(RuntimeError, match="not bound"):
        bn(torch.ones(2, 4, 3, 3))
    bn.eval()
    assert bn(torch.ones(2, 4, 3, 3)).shape == (2, 4, 3, 3)
    with pytest.raises(RuntimeError, match="not bound"):
        collectives.pmean(torch.ones(3), ("data", "ray"))


@pytest.mark.parametrize("mode", ["plain", "compact", "chunked"])
def test_sharded_render_matches_jax(run, mode):
    """The chunked render (``chunk`` 16: two chunks a rank) against JAX's
    plain one: the same pixels in other blocks."""
    want = run["renders"]["plain" if mode == "chunked" else mode]
    for r in run["results"]:
        got = r["render"][mode]
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a, b, atol=1e-4)
        assert (got[2] > 0.5).any()
        if mode == "compact":
            assert got[3].tolist() == [0.0] * 4
            assert want[3].tolist() == [0] * 4


def test_ray_shards_take_the_items_body_share():
    """The loaders put an item's body rays first (``bkgd_msk`` 1): each
    ray index's shard holds the item's share of them within one ray, so no
    shard overflows the tail's compaction capacity where the item fits."""
    import types

    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.parallel.mesh import shard_rays_to_mesh

    ds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=32,
                               n_rays=N_RAYS, n_verts=N_VERTS, split="train")
    body = torch.from_numpy(ds.get_item(0, instance_idx=0)
                            ["bkgd_msk_all"][0, :, 0])
    assert body[:N_RAYS // 2].all() and not body.all()  # body-first
    for k in (2, 4):
        shards = [shard_rays_to_mesh(body, types.SimpleNamespace(
            ray_size=k, ray_index=r)) for r in range(k)]
        assert torch.equal(torch.sort(torch.cat(shards)).values,
                           torch.sort(body).values)
        for shard in shards:
            assert abs(float(shard.mean()) - float(body.mean())) \
                <= 1 / shard.shape[0]


def test_dryrun_multichip_prints_ok(run):
    text, out = run["dryrun"]["text"], run["dryrun"]["result"]
    assert "dryrun_multichip OK: 4 ranks (data=2, ray=2)" in text
    assert out["plain"]["gap"] <= 1e-5 and out["smooth"]["gap"] <= 1e-5
