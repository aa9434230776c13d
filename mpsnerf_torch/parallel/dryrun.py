"""The multi-device dry run on CPU ranks (the counterpart of
``__graft_entry__.py:dryrun_multichip``).

    python -m mpsnerf_torch.parallel.dryrun 4

Starts ``n`` gloo ranks on this host's CPU as a (data = 2, ray = n / 2)
mesh and runs the full training step of the flagship model
(``MPSNeRF(num_instances=1)``, seed 0) through
:func:`~mpsnerf_torch.parallel.mesh.make_batched_train_step`, both data
rows on the same item of the 6890-vertex synthetic rig at 64^2 (train
split, view 0), perturb 0:

1. a plain step at 64 samples and 128 rays a rank: its loss (the mean
   over the mesh) equals the single-process loss on the item's whole rays
   to 1e-5, and its PSNR to 1e-3;
2. a smooth step (the double backward) at 16 samples from the same
   weights, each rank's smooth delta drawn from numpy seeded by its rank:
   its loss equals the mean of the single-process losses of the ray
   shards with those deltas to 1e-5 (the smooth terms are means over each
   shard's points, so the shard mean is the exact reference).

The single-process references run in this process while the ranks work.
Progress lines print as each stage lands, then one OK line with both
gaps; a gap above 1e-5 raises.
"""

from __future__ import annotations

import sys
import time

import numpy as np

N_VERTS, SIZE = 6890, 64
PLAIN_SAMPLES, SMOOTH_SAMPLES, RAYS_PER_RANK = 64, 16, 128
TOL = 1e-5


def _scene(n_rays, device="cpu"):
    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset

    ds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=SIZE,
                               n_rays=n_rays, n_verts=N_VERTS,
                               num_instances=1, split="train")
    item = ds.get_item(0, instance_idx=0)
    return ds.smpl_for(0, device=device), to_device_input(item, device,
                                                          rays=True)


def _model():
    import torch

    from mpsnerf_torch.models.mps_nerf import MPSNeRF

    torch.manual_seed(0)
    return MPSNeRF(num_instances=1)


def _cfgs():
    from mpsnerf_torch.train.trainer import TrainConfig

    common = dict(perturb=0.0, smooth_loss=True, smooth_interval=1,
                  acc_loss=True)
    return (TrainConfig(n_samples=PLAIN_SAMPLES, **common),
            TrainConfig(n_samples=SMOOTH_SAMPLES, **common))


def _delta(rank):
    import torch

    rng = np.random.default_rng(rank)
    return torch.from_numpy(
        (0.01 * rng.normal(size=(RAYS_PER_RANK * SMOOTH_SAMPLES, 3)))
        .astype(np.float32))


def _rank(data, ray):
    """One rank: the plain mesh step, then the smooth one from the same
    weights.  Returns each step's loss and PSNR."""
    import copy

    from mpsnerf_torch.parallel.mesh import (
        make_2d_mesh, make_batched_train_step,
    )
    from mpsnerf_torch.train.trainer import train_rays

    mesh = make_2d_mesh(data, ray)
    smpl, inp = _scene(RAYS_PER_RANK * ray)
    rays = train_rays(inp, 0, "cpu")
    cfg, cfg2 = _cfgs()
    model = _model()
    init = copy.deepcopy(model.state_dict())
    out = {}
    for name, c, smooth in (("plain", cfg, False), ("smooth", cfg2, True)):
        model.load_state_dict(init)
        step = make_batched_train_step(model, c, mesh, smooth=smooth)
        terms, psnr = step(smpl, inp, inp, *rays,
                           delta=_delta(mesh.rank) if smooth else None)
        out[name] = (float(terms.total), float(psnr),
                     step.trainer.global_step)
    return out


def _references(data, ray):
    """The single-process losses: the whole item (plain) and the mean over
    the ray shards with each rank's delta (smooth)."""
    import torch

    from mpsnerf_torch.train.losses import mse2psnr
    from mpsnerf_torch.train.trainer import make_loss_fn, train_rays

    smpl, inp = _scene(RAYS_PER_RANK * ray)
    rays = train_rays(inp, 0, "cpu")
    cfg, cfg2 = _cfgs()
    model = _model()
    with torch.no_grad():
        total, (terms, _) = make_loss_fn(model, cfg, False)(
            smpl, inp, inp, *rays)
    plain = (float(total), float(mse2psnr(terms.img_raw.clamp(min=1e-10))))
    losses, img = [], []
    for d in range(data):
        for s in range(ray):
            sl = slice(s, None, ray)  # ray index s's strided shard
            total, (terms, _) = make_loss_fn(model, cfg2, True)(
                smpl, inp, inp, *(r[sl] for r in rays),
                delta=_delta(d * ray + s))
            losses.append(float(total.detach()))
            img.append(float(terms.img_raw.detach()))
    smooth = (float(np.mean(losses)), float(mse2psnr(
        torch.tensor(max(float(np.mean(img)), 1e-10)))))
    return {"plain": plain, "smooth": smooth}


def dryrun_multichip(n_devices: int = 4, timeout_s: float = 600.0) -> dict:
    """Run the dry run on ``n_devices`` CPU ranks; returns both stages'
    mesh and single-process losses and their gaps.  Raises on a gap above
    1e-5 or a rank's failure."""
    from mpsnerf_torch.parallel.launch import Ranks

    t0 = time.perf_counter()

    def progress(msg):
        print(f"dryrun_multichip [{time.perf_counter() - t0:6.1f}s] {msg}",
              flush=True)

    data = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    ray = n_devices // data
    ranks = Ranks(_rank, n_devices, (data, ray), device="cpu",
                  timeout_s=timeout_s)
    progress(f"{n_devices} gloo ranks started: mesh (data={data}, ray={ray})"
             f", {N_VERTS} verts, {RAYS_PER_RANK * ray} rays an item")
    ref = _references(data, ray)
    progress(f"single-process references: plain {ref['plain'][0]:.6f}, "
             f"smooth shard mean {ref['smooth'][0]:.6f}")
    results = ranks.wait(timeout_s)
    out = {}
    for name, n_s in (("plain", PLAIN_SAMPLES), ("smooth", SMOOTH_SAMPLES)):
        losses = {r[name][0] for r in results}
        if len(losses) != 1 or any(r[name][2] != 1 for r in results):
            raise AssertionError(f"{name}: the ranks disagree: {results}")
        loss, psnr, _ = results[0][name]
        gap = abs(loss - ref[name][0])
        if not np.isfinite(loss) or gap > TOL + TOL * abs(ref[name][0]):
            raise AssertionError(f"{name} mesh loss {loss} != single-process "
                                 f"{ref[name][0]} (gap {gap:.3g})")
        if name == "plain" and abs(psnr - ref[name][1]) > 1e-3:
            raise AssertionError(f"mesh psnr {psnr} != {ref[name][1]}")
        out[name] = dict(mesh=loss, single=ref[name][0], gap=gap, psnr=psnr)
        progress(f"{name} MESH step OK ({N_VERTS} verts, "
                 f"{RAYS_PER_RANK * ray} rays x {n_s} samples): "
                 f"|{loss:.6f} - {ref[name][0]:.6f}| = {gap:.3g} <= {TOL:g}")
    p, s = out["plain"], out["smooth"]
    print(f"dryrun_multichip OK: {n_devices} ranks (data={data}, ray={ray});"
          f" plain parity at {N_VERTS} verts, {RAYS_PER_RANK * ray} rays x "
          f"{PLAIN_SAMPLES} samples |{p['mesh']:.6f} - {p['single']:.6f}| = "
          f"{p['gap']:.3g} <= {TOL:g}; smooth parity at {N_VERTS} verts, "
          f"{RAYS_PER_RANK * ray} rays x {SMOOTH_SAMPLES} samples "
          f"|{s['mesh']:.6f} - {s['single']:.6f}| = {s['gap']:.3g} <= "
          f"{TOL:g}, psnr={s['psnr']:.2f}", flush=True)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
