"""Pair-mode training proof of the port (port of
``tools/pair_train_proof.py``): the flagship model in pair mode on the
synthetic scene, the source pose differing from the target half the time
(the Pair data sets' 50 % same-pose draws), with the correction field on,
and the PSNR progression of same-pose and cross-pose items.

What it drives: the image loss gated on pose equality
(``extended_img2mse``) and the pair-mode aggregation of the correction
field (features sampled at the coarse source-warped points).  The logged
PSNR is the true image MSE on every item, so cross-pose items report
cross-pose PSNR.

The JAX script's setup: ``SyntheticHumanDataset(n_poses=2, n_cameras=6,
image_size=256, n_rays=512, n_verts=6890, num_instances=1,
input_views=[0, 2, 4], seed=3)``, the two items with their sparse-conv
plans built once; ``MPSNeRF(num_instances=1, compact_fraction=0.5,
pair_mode=True, correction_field=True)``; ``TrainConfig(n_samples=64,
smooth_loss=False, decay_steps=30000, pair_mode=True,
correction_loss=True)``; 60 items, the pairs drawn by
``np.random.default_rng(0)``::

    python -m mpsnerf_torch.tools.pair_train_proof [--device cuda]

writes ``<out>/torch_pair_train_proof.json`` (the JAX proof's keys, and
``setup`` naming the card and its power limit) and, with ``--check 1``
(the default), fails unless the same-pose PSNR's last quarter beats its
first by 1 dB and the cross-pose PSNR improves, as the JAX script does.
Randomness: the initialisers from seed 0, the trainer's generator from
seed 1.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np


def _quarter_mean(history: List[Dict], last: bool) -> float:
    q = max(3, len(history) // 4)
    part = history[-q:] if last else history[:q]
    return float(np.mean([h["psnr"] for h in part])) if part else float("nan")


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train in pair mode and write the proof; returns its summary."""
    from mpsnerf_torch.data import attach_spconv_plan, to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.models.mps_nerf import MPSNeRF
    from mpsnerf_torch.tools import proof_common as pc
    from mpsnerf_torch.train.trainer import TrainConfig, Trainer

    p = pc.parser(__doc__, items=60, size=256)
    p.add_argument("--check", type=int, default=1,
                   help="fail unless PSNR improved as the JAX proof asks")
    args = p.parse_args(argv)
    dev = pc.device_of(args.device)
    ds = SyntheticHumanDataset(
        n_poses=2, n_cameras=6, image_size=args.size, n_rays=pc.N_RAYS,
        n_verts=args.n_verts, num_instances=1, input_views=[0, 2, 4],
        split="train", seed=3)
    smpl = ds.smpl_for(0, device=dev)
    items = [to_device_input(attach_spconv_plan(ds.get_item(
        i, instance_idx=0)), dev, rays=True) for i in range(2)]
    model = pc.seeded(lambda: MPSNeRF(
        num_instances=1, compact_fraction=0.5, pair_mode=True,
        correction_field=True))
    cfg = TrainConfig(n_samples=pc.N_SAMPLES, smooth_loss=False,
                      decay_steps=30000, pair_mode=True,
                      correction_loss=True)
    trainer = Trainer(model, cfg, device=dev, seed=1)

    rng = np.random.default_rng(0)
    history = []
    t0 = time.time()
    for i in range(args.items):
        # 50 % same-pose pairs, like the Pair data sets
        sp_idx = int(rng.integers(2))
        tp_idx = sp_idx if rng.random() < 0.5 else 1 - sp_idx
        logs = trainer.train_item(smpl, items[sp_idx], items[tp_idx])
        same = sp_idx == tp_idx
        history.append({"item": i, "same_pose": same, "loss": logs["loss"],
                        "psnr": logs["psnr"]})
        if i % 10 == 0:
            print(f"item {i:3d} same_pose={same} loss={logs['loss']:.4f} "
                  f"psnr={logs['psnr']:.2f}", flush=True)
    pc.synchronize(dev)
    wall = time.time() - t0
    pc.check_finite(history)

    same = [h for h in history if h["same_pose"]]
    cross = [h for h in history if not h["same_pose"]]
    first, last = _quarter_mean(same, False), _quarter_mean(same, True)
    cross_first = _quarter_mean(cross, False)
    cross_last = _quarter_mean(cross, True)
    out = {
        "mode": "pair (sp != tp half the time), correction_field on",
        "setup": f"synthetic subject, 3 input views @{args.size}, "
                 f"{pc.N_SAMPLES} samples on {pc.where(dev)} (PyTorch "
                 "port)",
        "items": args.items,
        "view_steps": trainer.global_step,
        "wall_s": round(wall, 1),
        "same_pose_psnr_first_quarter": round(first, 3),
        "same_pose_psnr_last_quarter": round(last, 3),
        "cross_pose_items": len(cross),
        "cross_pose_psnr_first_quarter": round(cross_first, 3),
        "cross_pose_psnr_last_quarter": round(cross_last, 3),
        "cross_pose_loss_last": (round(float(cross[-1]["loss"]), 4)
                                 if cross else float("nan")),
        "history": history,
    }
    with open(pc.out_path(args.out, "torch_pair_train_proof.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "history"},
                     indent=1))
    if args.check:
        if not last > first + 1.0:
            raise SystemExit("pair training did not improve PSNR")
        if not cross_last > cross_first:
            raise SystemExit("cross-pose PSNR did not improve: pair "
                             "supervision is not generalizing across poses")
        print("pair-mode training proof OK")
    return out


if __name__ == "__main__":
    main()
