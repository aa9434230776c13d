"""Cross-subject generalization proof of the port (port of
``tools/generalization_proof.py``): train on subjects 0-1 and render the
held-out subject 2, never trained on, from its own 3 input views (the
defining capability of MPS-NeRF: novel subjects, no per-subject fitting).

The JAX script's setup: ``SyntheticHumanDataset(n_poses=2, n_cameras=6,
image_size=256, n_rays=512, n_verts=6890, num_instances=3,
input_views=[0, 2, 4], seed=11)``; 400 items alternating over subjects 0
and 1 (each subject's two train items built once); ``MPSNeRF(
num_instances=3, compact_fraction=0.5)``; ``TrainConfig(n_samples=64,
smooth_loss=True, smooth_interval=4)``; a history record every 40 items;
then ``ViewRenderer(chunk=4096, n_samples=64)`` on views 1 and 3 of 2
poses of the held-out subject 2 and of the seen subject 0::

    python -m mpsnerf_torch.tools.generalization_proof [--device cuda]

writes ``<out>/torch_generalization_proof.json`` (the JAX proof's keys;
``setup`` names the card and its power limit) and
``<out>/torch_generalization_heldout_subject.png`` (subject 2, pose 0,
view 1: pred | gt).  Randomness: the initialisers from seed 0, the
trainer's generator from seed 1.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

N_TRAIN_SUBJECTS = 2
EVAL_VIEWS = (1, 3)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train, evaluate both subjects and write the proof; returns its
    summary."""
    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.eval.runner import ViewRenderer
    from mpsnerf_torch.models.mps_nerf import MPSNeRF
    from mpsnerf_torch.tools import proof_common as pc
    from mpsnerf_torch.train.trainer import TrainConfig, Trainer

    args = pc.parser(__doc__, items=400, size=256).parse_args(argv)
    dev = pc.device_of(args.device)
    size, every = args.size, 40
    rig = dict(n_poses=2, n_cameras=6, image_size=size, n_verts=args.n_verts,
               num_instances=3, input_views=[0, 2, 4], seed=11)
    ds = SyntheticHumanDataset(split="train", n_rays=pc.N_RAYS, **rig)
    test_ds = SyntheticHumanDataset(split="test", n_rays=64, **rig)
    train_items = {
        s: [to_device_input(ds.get_item(i, instance_idx=s), dev, rays=True)
            for i in range(2)] for s in range(N_TRAIN_SUBJECTS)}
    smpls = {s: ds.smpl_for(s, device=dev) for s in range(3)}
    model = pc.seeded(lambda: MPSNeRF(num_instances=3, compact_fraction=0.5))
    cfg = TrainConfig(n_samples=pc.N_SAMPLES, smooth_loss=True,
                      smooth_interval=4)
    trainer = Trainer(model, cfg, device=dev, seed=1)

    history = []
    t0 = time.time()
    for it in range(args.items):
        s = it % N_TRAIN_SUBJECTS
        item = train_items[s][(it // N_TRAIN_SUBJECTS) % 2]
        logs = trainer.train_item(smpls[s], item, item)
        if it % every == 0 or it == args.items - 1:
            history.append(pc.history_record(it, trainer.global_step, logs,
                                             time.time() - t0, True))
            print(history[-1], flush=True)
    pc.synchronize(dev)
    train_s = time.time() - t0
    pc.check_finite(history)

    renderer = ViewRenderer(trainer.model, None, chunk=4096,
                            n_samples=pc.N_SAMPLES, tile=pc.TILE,
                            device=dev)
    results = {}
    for subject, tag in ((2, "heldout"), (0, "seen")):
        renderer.smpl_selector = lambda g, s=subject: smpls[s]
        per_view = []
        for pi in range(2):
            per_view += pc.view_metrics(
                renderer, test_ds.get_item(pi, instance_idx=subject),
                EVAL_VIEWS, size, pi)
        for r in pc.public(per_view):
            print(tag, r, flush=True)
        if subject == 2:
            pc.write_side_by_side(
                pc.out_path(args.out,
                            "torch_generalization_heldout_subject.png"),
                *per_view[0]["images"])
        results[tag] = {"per_view": pc.public(per_view),
                        "mean_psnr": pc.mean_of(per_view, "psnr", 3),
                        "mean_ssim": pc.mean_of(per_view, "ssim", 4)}

    summary = {
        "setup": f"train on subjects 0-1 ({trainer.global_step} view-steps, "
                 f"{round(train_s / 60, 1)} min, {pc.where(dev)}, PyTorch "
                 "port); subject 2 never trained on, rendered from its own "
                 "3 input views only",
        "history": history,
        "results": results,
    }
    with open(pc.out_path(args.out, "torch_generalization_proof.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    print("DONE heldout:", results["heldout"]["mean_psnr"],
          "seen:", results["seen"]["mean_psnr"])
    return summary


if __name__ == "__main__":
    main()
