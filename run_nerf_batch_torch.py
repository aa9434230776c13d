#!/usr/bin/env python
"""Training / evaluation CLI of the PyTorch port (``mpsnerf_torch``),
step for step the JAX package's ``run_nerf_batch.py``.

    python run_nerf_batch_torch.py --config configs/canonical_transformer.txt --batch_size 1
    python run_nerf_batch_torch.py --config configs/h36m.txt --batch_size 1
    python run_nerf_batch_torch.py --config configs/synthetic_smoke.txt --device cpu
    python run_nerf_batch_torch.py --config ... --save_weights 0   # eval only

One optimizer step per output view of each loader item; a checkpoint when
the view-step counter crosses a multiple of ``i_weights``, scalars at
``i_print``, the eval protocol at ``i_testset``; eval only when
``save_weights == 0``.  The newest checkpoint under
``<basedir>/<expname>/checkpoints`` is reloaded unless ``--no_reload``
(Adam restarts fresh unless ``--resume_optimizer 1``).  ``args.txt`` and
``config.txt`` go to ``<basedir>/<expname>``, scalars to
``<basedir>/summaries/<expname>/scalars.jsonl``, eval files to
``<basedir>/<expname>/testset_<step>``.  ``MPSNERF_PROFILE_DIR`` writes a
``torch.profiler`` trace of the second item there.

Every model string of ``mpsnerf_torch/factory.py`` (the numpy-era
``correction_by_*`` models too) and every model flag trains.  A pair data
set (``H36M_P``, ``THuman_P``) gives each item as a source and a target;
the target's rays drive the step and its image term counts only where the
two poses match.  With a correction field each item gets its sparse-conv
plan (and its canonical grid's, for the numpy-era models).  The eval is
the synthetic, THuman or H36M protocol, and for every other data set
(``THuman_B_R``, ``THuman_P``, ``H36M_B_All``) the reference's inline
test (``run_legacy_test``: poses 13 and 14 of the test split, every 12th
view, side-by-side PNGs and the sweep videos).

``--device`` (default ``cuda``) picks the device; there is no fallback to
the CPU.  One item at a time on one device: ``--batch_size`` > 1 and
``--mesh_devices`` raise.
"""

from __future__ import annotations

import contextlib
import os
import time
import types

import numpy as np


def _parser():
    from mpsnerf_torch.config import config_parser

    p = config_parser()
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cpu for the CPU)")
    return p


@contextlib.contextmanager
def _profile(trace_dir, step: int, device):
    """A ``torch.profiler`` trace of the block into ``trace_dir`` (no-op
    for None)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(trace_dir, f"item_step{step:06d}.json")
    prof.export_chrome_trace(path)
    print("Wrote profile", path)


def main(argv=None):
    """Run the CLI; returns the run's state (``trainer``, ``start_step``,
    ``logs`` of each item, ``dataset``, ``args``) for callers that drive
    it from Python."""
    from mpsnerf_torch.config import dump_args, parse_args, print_args

    args = parse_args(argv, _parser())

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                           "pass --device cpu to run on the CPU")
    if args.batch_size > 1 or args.mesh_devices:
        raise NotImplementedError(
            f"--batch_size {args.batch_size} / --mesh_devices "
            f"{args.mesh_devices}: the batched and sharded trainers are not "
            "ported (ROADMAP.md item 8); run with --batch_size 1")
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    print_args(args)
    basedir, expname = args.basedir, args.expname or "exp"
    dump_args(args, basedir, expname)

    from mpsnerf_torch.data import attach_spconv_plan, to_device_input
    from mpsnerf_torch.data.prefetch import PrefetchLoader
    from mpsnerf_torch.factory import (
        PAIR_DATA_SETS, return_dataset, return_model,
    )
    from mpsnerf_torch.smpl.assets import load_smpl_models
    from mpsnerf_torch.train.checkpoint import restore_latest, save_checkpoint
    from mpsnerf_torch.train.metrics import MetricWriter
    from mpsnerf_torch.train.trainer import TrainConfig, Trainer

    torch.manual_seed(args.seed)
    model = return_model(args)
    pair_mode = args.data_set_type in PAIR_DATA_SETS
    cfg = TrainConfig(
        lrate=args.lrate,
        decay_steps=args.decay_steps,
        n_samples=args.N_samples,
        n_importance=args.N_importance,
        perturb=args.perturb,
        occupancy=bool(args.occupancy),
        white_bkgd=args.white_bkgd,
        # half_acc turns the acc loss off outright, as in the reference
        acc_loss=bool(args.acc_loss) and not bool(args.half_acc),
        correction_loss=bool(args.correction_loss),
        consistency_loss=bool(args.consistency_loss),
        density_loss=bool(args.density_loss),
        smooth_loss=bool(args.smooth_loss),
        smooth_interval=args.smooth_interval,
        pair_mode=pair_mode,
    )
    dataset = return_dataset(args)
    smpl_models = load_smpl_models(device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model '{args.model}': {n_params / 1e6:.2f}M params")

    # the newest checkpoint; Adam fresh unless --resume_optimizer
    start, restored = 0, None
    if not args.no_reload:
        start, restored = restore_latest(basedir, expname)
    trainer = Trainer(model, cfg, device=device, start_step=start,
                      seed=args.seed)
    if restored is not None:
        print(f"Reloading from step {start}")
        trainer.restore(restored, load_optimizer=bool(args.resume_optimizer))
    writer = MetricWriter(basedir, expname)
    run = types.SimpleNamespace(trainer=trainer, start_step=start, logs=[],
                                dataset=dataset, args=args)

    def smpl_selector(gender: int):
        return smpl_models[gender]

    def run_eval(tag: str):
        from mpsnerf_torch.eval import runner

        savedir = os.path.join(basedir, expname, tag)
        os.makedirs(savedir, exist_ok=True)
        dst = args.data_set_type
        if dst == "Synthetic":
            return runner.run_synthetic_eval(
                args, trainer.model, smpl_selector, savedir, dataset,
                device=device)
        if dst in ("THuman_B", "THuman"):
            return runner.run_thuman_eval(args, trainer.model, smpl_selector,
                                          savedir, device=device)
        if dst in ("H36M_B", "H36M", "H36M_P"):
            return runner.run_h36m_eval(args, trainer.model, smpl_selector,
                                        savedir, device=device)
        # every other data set: the reference's inline test on the test
        # split's poses 13 and 14, the first the source (a pair item's
        # target)
        targs = types.SimpleNamespace(**vars(args))
        targs.start, targs.interval, targs.poses_num = 13, 1, 2
        test_set = return_dataset(targs, split=args.test_split)
        items = [test_set[i] for i in range(min(len(test_set), 2))]
        items = [it["tp_input"] if "sp_input" in it else it for it in items]
        hw = int(512 * (args.image_scaling or 1.0))
        return runner.run_legacy_test(
            args, trainer.model, smpl_selector, savedir, items, H=hw, W=hw,
            data_interval=1, start_pose=13, device=device)

    if args.save_weights == 0:
        tag = f"testset_{trainer.global_step:06d}_more_real_ssim_psnr"
        print("Begin to test, save_weights == 0")
        run_eval(tag)
        print("Saved test set")
        writer.close()
        return run

    profile_dir = os.environ.get("MPSNERF_PROFILE_DIR")
    n_iters = args.N_iteration + 1
    running = []
    last_print = last_ckpt = last_eval = trainer.global_step
    t0 = time.time()
    loader = PrefetchLoader(dataset, seed=args.seed,
                            num_workers=min(args.num_worker, 4))
    primary = (not torch.distributed.is_initialized()
               or torch.distributed.get_rank() == 0)

    # the numpy-era models' NeRF reads the canonical grid too
    canonical = bool(getattr(model, "canonical_grid", False))

    def prepare(item):
        """A loader item -> (rig, source, target) on the device."""
        if pair_mode:
            sp_item, tp_item = item["sp_input"], item["tp_input"]
        else:
            sp_item = tp_item = item
        if model.correction_field:
            attach_spconv_plan(tp_item, canonical=canonical)
            if sp_item is not tp_item:
                # the instance style's backward correction reads the
                # source pose's voxel grid
                attach_spconv_plan(sp_item, canonical=canonical)
        smpl = smpl_models[int(sp_item["gender"])]
        tp = to_device_input(tp_item, device, rays=True)
        sp = tp if sp_item is tp_item else to_device_input(sp_item, device)
        return smpl, sp, tp

    while trainer.global_step < n_iters:
        # profile the second item (after the first one's lazy set-up)
        do_trace = profile_dir and len(run.logs) == 1
        with _profile(profile_dir if do_trace else None,
                      trainer.global_step, device):
            smpl, sp, tp = prepare(next(loader))
            logs = trainer.train_item(smpl, sp, tp)
        running.append(logs)
        run.logs.append(logs)
        gs = trainer.global_step

        # each cadence fires when the view-step counter crosses a multiple
        if gs // args.i_print > last_print // args.i_print:
            last_print = gs
            mean = {k: float(np.mean([r[k] for r in running]))
                    for k in running[0]}
            dt = (time.time() - t0) / max(1, len(running))
            writer.add_scalars(gs, mean)
            dropped = mean.get("n_dropped", 0.0)
            drop_str = (f"  Dropped: {dropped:.0f} pts (compaction overflow!)"
                        if dropped > 0 else "")
            print(f"[TRAIN] Iter: {gs}  Loss: {round(mean['loss'], 5)} "
                  f"PSNR: {round(mean['psnr'], 3)}  Time: {round(dt, 3)} "
                  f"s/item{drop_str}")
            running = []
            t0 = time.time()

        if gs // args.i_weights > last_ckpt // args.i_weights \
                and args.save_weights:
            last_ckpt = gs
            path = save_checkpoint(basedir, expname, gs, trainer.state(),
                                   is_primary=primary)
            if path:
                print("Saved checkpoints at", path)

        if gs // args.i_testset > last_eval // args.i_testset:
            last_eval = gs
            try:
                run_eval(f"testset_{gs:06d}")
                print("Saved test set")
            except NotImplementedError as e:
                print("eval skipped:", e)
    loader.close()
    writer.close()
    return run


if __name__ == "__main__":
    main()
