"""Rank functions of the port's mesh tests (``test_torch_port_parallel*``),
run by ``mpsnerf_torch.parallel.launch`` in spawned CPU ranks.  This module
imports torch and the port only, never JAX: the ranks are children that
import it, and the JAX references are computed in the pytest process."""

import copy
import hashlib

import numpy as np
import torch


def params_digest(model) -> str:
    """A digest of every parameter's bytes (bit-equality across ranks)."""
    h = hashlib.sha1()
    for p in model.parameters():
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def _np(t):
    return t.detach().numpy().copy()


def mesh_rank(state, model_kw, items, n_verts, cfg_kw, deltas, bn_case,
              render_case):
    """One rank of a (2, 2) mesh: (a) a plain and then a smooth step of
    ``make_batched_train_step``'s trainer on its row's item (the model's
    2D-encoder BatchNorm averaged over the ``ray`` axis), (b) a
    cross-replica ``BatchNorm2d`` over the ``ray`` axis, (c) the sharded
    render on a 1-D mesh of the 4 ranks, plain, compact and in chunks of
    16 rays, from the initial weights."""
    from mpsnerf_torch.data import attach_body_grid, to_device_input
    from mpsnerf_torch.models.mps_nerf import MPSNeRF
    from mpsnerf_torch.models.resnet import BatchNorm2d
    from mpsnerf_torch.parallel.mesh import (
        RAY_AXIS, make_2d_mesh, make_batched_train_step, make_mesh,
        make_sharded_render,
    )
    from mpsnerf_torch.smpl.model import synthetic_smpl
    from mpsnerf_torch.train.trainer import TrainConfig, train_rays

    mesh = make_2d_mesh(2, 2)
    out = {"rank": mesh.rank, "data_index": mesh.data_index}
    smpl = synthetic_smpl(n_verts=n_verts, seed=0, device="cpu")
    model = MPSNeRF(bn_axis_name=RAY_AXIS, **model_kw)
    init = {k: torch.from_numpy(v) for k, v in state.items()}
    model.load_state_dict(init)
    inp = to_device_input(items[mesh.data_index], "cpu", rays=True)
    rays = train_rays(inp, 0, "cpu")

    # (a) the plain step, then the smooth step on its weights
    step = make_batched_train_step(model, TrainConfig(**cfg_kw), mesh)
    trainer = step.trainer
    terms, _ = step(smpl, inp, inp, *rays)
    out["plain_terms"] = [float(t) for t in terms]
    out["grads"] = {n: _np(p.grad) for n, p in model.named_parameters()}
    out["state_after_plain"] = {k: _np(v) for k, v in
                                model.state_dict().items()}
    out["digests"] = [params_digest(model)]
    terms, _ = trainer.rays_step(smpl, inp, inp, rays, True,
                                 delta=torch.from_numpy(deltas[mesh.rank]))
    out["smooth_terms"] = [float(t) for t in terms]
    out["smooth_grads"] = {n: _np(p.grad) for n, p in
                           model.named_parameters()}
    out["digests"].append(params_digest(model))
    out["steps"] = trainer.global_step

    # (b) cross-replica BatchNorm: ray index i takes slice i
    x_all, w_all, bn_state = bn_case
    bn = BatchNorm2d(x_all.shape[2], eps=1e-5, momentum=0.1,
                     axis_name=RAY_AXIS)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in bn_state.items()},
                       strict=False)
    bn.train()
    x = torch.from_numpy(x_all[mesh.ray_index]).requires_grad_(True)
    with mesh.bound():
        y = bn(x)
        (y * torch.from_numpy(w_all[mesh.ray_index])).sum().backward()
    out["bn"] = dict(y=_np(y), x_grad=_np(x.grad),
                     running_mean=_np(bn.running_mean),
                     running_var=_np(bn.running_var))

    # (c) the sharded render over all 4 ranks (the ray axis of a 1-D mesh)
    ro, rd, nr, fr, n_samples, cap, tile = render_case
    model.load_state_dict(init)
    model.eval()
    flat = make_mesh(RAY_AXIS)
    item = attach_body_grid(copy.copy(items[1]))
    tp = to_device_input(item, "cpu")
    with torch.no_grad():
        latent = model.encode(tp["img_all"])
    rays = [torch.from_numpy(a) for a in (ro, rd, nr, fr)]
    plain = make_sharded_render(model, flat, n_samples)(
        smpl, tp, tp, latent, *rays)
    compact = make_sharded_render(model, flat, n_samples, capacity=cap,
                                  tile=tile)(smpl, tp, tp, latent, *rays)
    chunked = make_sharded_render(model, flat, n_samples, chunk=16)(
        smpl, tp, tp, latent, *rays)
    out["render"] = dict(plain=[_np(t) for t in plain],
                         compact=[_np(t) for t in compact],
                         chunked=[_np(t) for t in chunked])
    return out


def item_checksum(item) -> str:
    """A short digest of a loader item's pose and target rays: which item
    and which ray draw a rank trained on.  (Not of its colours: a
    rendered item's pixels round with the host's thread count.)"""
    it = item.get("tp_input", item)
    h = hashlib.sha1(np.int64(it.get("pose_index", -1)).tobytes())
    for key in ("ray_o_all", "ray_d_all"):
        h.update(np.ascontiguousarray(it[key]).tobytes())
    return h.hexdigest()[:16]


def cli_rank(argv):
    """One rank of ``run_nerf_batch_torch.main(argv)`` in the group that
    the launch made (the CLI joins it, as under torchrun), with spies on
    the item each rank receives (its checksum) and on the checkpoints it
    writes.  TensorBoard's import is blocked (it pulls in TensorFlow,
    ~14 s on this host; the tests read ``scalars.jsonl``)."""
    import sys

    import run_nerf_batch_torch
    from mpsnerf_torch.parallel import mesh
    from mpsnerf_torch.train import checkpoint

    sys.modules["torch.utils.tensorboard"] = None
    items, saved = [], []
    scatter, save = mesh.scatter_to_rows, checkpoint.save_checkpoint

    def scatter_spy(*a, **k):
        item = scatter(*a, **k)
        items.append(item_checksum(item))
        return item

    def save_spy(*a, **k):
        saved.append(save(*a, **k))
        return saved[-1]

    mesh.scatter_to_rows, checkpoint.save_checkpoint = scatter_spy, save_spy
    run = run_nerf_batch_torch.main(argv)
    m = run.trainer.mesh
    return dict(rank=m.rank, data_index=m.data_index, ray_index=m.ray_index,
                global_step=run.trainer.global_step, logs=run.logs,
                items=items, saved=saved)


def fail_on_rank(bad):
    """Rank ``bad`` raises; the others wait in a barrier for it."""
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    dist.barrier()
    return dist.get_rank()
