"""Learning proof of the port (port of ``tools/train_proof.py``): train the
flagship model on the synthetic subject and record the PSNR progression
and the held-out views' metrics.

The JAX script's setup: ``SyntheticHumanDataset(n_poses=2, n_cameras=6,
image_size=256, n_rays=512, n_verts=6890, num_instances=1,
input_views=[0, 2, 4], seed=3)``, its two train items built once;
``MPSNeRF(num_instances=1, compact_fraction=0.5)``; ``TrainConfig(
n_samples=64, smooth_loss=True, smooth_interval=4, decay_steps=30000)``;
400 items (2400 view-steps), a history record every 20; then
``ViewRenderer(chunk=4096, n_samples=64)`` on views 1, 3 and 5 of both
test poses, PSNR and SSIM inside the body box::

    python -m mpsnerf_torch.tools.train_proof [--device cuda] [--out artifacts]

writes ``<out>/torch_synthetic_training_proof.json`` (the JAX proof's keys;
``setup`` names the card and its power limit) and
``<out>/torch_synthetic_novel_view.png`` (pose 0, view 1: pred | gt).
Randomness: the model's initialisers from seed 0, the trainer's generator
from seed 42.  ``--items``, ``--size`` and ``--n_verts`` shrink it.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

HELD_OUT_VIEWS = (1, 3, 5)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train, evaluate and write the proof; returns its summary."""
    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.eval.runner import ViewRenderer
    from mpsnerf_torch.models.mps_nerf import MPSNeRF
    from mpsnerf_torch.tools import proof_common as pc
    from mpsnerf_torch.train.trainer import TrainConfig, Trainer

    args = pc.parser(__doc__, items=400, size=256).parse_args(argv)
    dev = pc.device_of(args.device)
    size, every = args.size, 20
    rig = dict(n_poses=2, n_cameras=6, image_size=size, n_verts=args.n_verts,
               num_instances=1, input_views=[0, 2, 4], seed=3)
    ds = SyntheticHumanDataset(split="train", n_rays=pc.N_RAYS, **rig)
    test_ds = SyntheticHumanDataset(split="test", n_rays=64, **rig)
    smpl = ds.smpl_for(0, device=dev)
    items = [to_device_input(ds.get_item(i, instance_idx=0), dev, rays=True)
             for i in range(2)]
    model = pc.seeded(lambda: MPSNeRF(num_instances=1, compact_fraction=0.5))
    cfg = TrainConfig(n_samples=pc.N_SAMPLES, smooth_loss=True,
                      smooth_interval=4, decay_steps=30000)
    trainer = Trainer(model, cfg, device=dev, seed=42)

    history = []
    t0 = time.time()
    for it in range(args.items):
        logs = trainer.train_item(smpl, items[it % 2], items[it % 2])
        if it % every == 0 or it == args.items - 1:
            history.append(pc.history_record(it, trainer.global_step, logs,
                                             time.time() - t0, False))
            print(history[-1], flush=True)
    pc.synchronize(dev)
    train_s = time.time() - t0
    pc.check_finite(history)

    renderer = ViewRenderer(trainer.model, lambda g: smpl, chunk=4096,
                            n_samples=pc.N_SAMPLES, tile=pc.TILE,
                            device=dev)
    results = []
    for pi in range(2):
        results += pc.view_metrics(
            renderer, test_ds.get_item(pi, instance_idx=0), HELD_OUT_VIEWS,
            size, pi)
    for r in pc.public(results):
        print(r, flush=True)
    pc.write_side_by_side(pc.out_path(args.out,
                                      "torch_synthetic_novel_view.png"),
                          *results[0]["images"])
    summary = {
        "setup": f"synthetic subject, 3 input views @{size}, "
                 f"{pc.N_SAMPLES} samples, {trainer.global_step} "
                 f"view-steps on {pc.where(dev)} (PyTorch port)",
        "train_minutes": round(train_s / 60, 1),
        "history": history,
        "heldout_view_metrics": pc.public(results),
        "mean_heldout_psnr": pc.mean_of(results, "psnr", 3),
        "mean_heldout_ssim": pc.mean_of(results, "ssim", 4),
    }
    with open(pc.out_path(args.out, "torch_synthetic_training_proof.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    print("DONE", summary["mean_heldout_psnr"], summary["mean_heldout_ssim"])
    return summary


if __name__ == "__main__":
    main()
