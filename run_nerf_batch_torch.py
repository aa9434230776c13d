#!/usr/bin/env python
"""Training / evaluation CLI of the PyTorch port (``mpsnerf_torch``),
step for step the JAX package's ``run_nerf_batch.py``.

    python run_nerf_batch_torch.py --config configs/canonical_transformer.txt --batch_size 1
    python run_nerf_batch_torch.py --config configs/h36m.txt --mesh_devices 2
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
the CPU.

``--mesh_devices N --batch_size B`` trains on a (data = B, ray = N / B)
mesh of N ranks (``mpsnerf_torch/parallel/mesh.py:MeshTrainer``): every
view-step takes one Adam step on the mean gradient of B items, each
item's rays sharded over its row's N / B ranks (N must divide by B; B > 1
alone makes N the number of GPUs, or B where that is fewer).  Without
torchrun's environment the CLI starts the N ranks on this host itself;
under ``torchrun --nproc_per_node N`` each process is a rank of the group
that is there.  A rank takes ``cuda:{local_rank % device_count}``: ranks
that share a GPU run over gloo, ranks with a GPU each over NCCL (printed
at start).  Rank 0 draws the items in the sampler's order (the
single-process stream) and sends each data row its item; it alone writes
``args.txt``, checkpoints and scalars and runs the eval.  Every rank
reloads the newest checkpoint.  A rank that fails ends the run with an
error.

    python run_nerf_batch_torch.py --config configs/canonical_transformer.txt --mesh_devices 2
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import types

import numpy as np


def _parser():
    from mpsnerf_torch.config import config_parser

    p = config_parser()
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cpu for the CPU)")
    return p


def mesh_shape(args):
    """``(data, ranks)`` of the mesh the flags ask for, or None for one
    device (``run_nerf_batch.py:124-152``)."""
    data = max(1, args.batch_size)
    n = args.mesh_devices
    if not n and data > 1:
        if "WORLD_SIZE" in os.environ:
            n = int(os.environ["WORLD_SIZE"])
        elif args.device.startswith("cuda"):
            import torch

            n = torch.cuda.device_count()
    if n <= 1 and data == 1:
        return None
    n = max(n, data)
    if n % data:
        raise ValueError(f"--mesh_devices {n} not divisible by "
                         f"--batch_size {data}")
    return data, n


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
    ``logs`` of each item, ``dataset``, ``args``) for callers that drive it
    from Python.  On a mesh that the CLI starts itself, ``ranks`` holds
    each rank's summary (:func:`_summary`), and ``start_step`` and
    ``logs`` are rank 0's."""
    from mpsnerf_torch.config import parse_args

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv, _parser())
    shape = mesh_shape(args)
    if shape is None or "RANK" in os.environ:
        return _run(args, shape)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return _run(args, shape)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch sees no CUDA "
                               "device; pass --device cpu to run on the CPU")
    from mpsnerf_torch.parallel.launch import spawn
    from mpsnerf_torch.parallel.mesh import DEFAULT_TIMEOUT_S

    ranks = spawn(_rank_main, shape[1], (argv,), device=args.device,
                  timeout_s=DEFAULT_TIMEOUT_S)
    return types.SimpleNamespace(args=args, ranks=ranks,
                                 start_step=ranks[0]["start_step"],
                                 logs=ranks[0]["logs"])


def _summary(run) -> dict:
    """What a rank hands back to the CLI that started it: its place in the
    mesh and backend, its steps and per-item logs."""
    from mpsnerf_torch.parallel.mesh import DIST

    mesh = run.trainer.mesh
    return dict(rank=mesh.rank, data_index=mesh.data_index,
                ray_index=mesh.ray_index, backend=DIST["backend"],
                start_step=run.start_step,
                global_step=run.trainer.global_step, logs=run.logs)


def _rank_main(argv):
    """One rank of a mesh that :func:`main` started (the group is up)."""
    from mpsnerf_torch.config import parse_args

    args = parse_args(argv, _parser())
    return _summary(_run(args, mesh_shape(args)))


def _run(args, shape):
    """The CLI on one device (``shape`` None) or as one rank of a mesh."""
    import torch

    mesh = None
    if shape is None:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch sees no CUDA "
                               "device; pass --device cpu to run on the CPU")
    else:
        import torch.distributed as dist

        from mpsnerf_torch.parallel.mesh import (
            DIST, initialize_distributed, make_2d_mesh,
        )

        if not dist.is_initialized():
            initialize_distributed(device=args.device)
        data, n = shape
        if dist.get_world_size() != n:
            raise ValueError(f"--mesh_devices {n}, but the process group "
                             f"has {dist.get_world_size()} ranks")
        device = torch.device(DIST.get("device", args.device))
        mesh = make_2d_mesh(data, n // data, device)
    primary = mesh is None or mesh.rank == 0
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if primary:
        from mpsnerf_torch.config import dump_args, print_args

        if mesh is not None:
            print(f"Mesh execution: {n} ranks (data={data}, ray={n // data})"
                  f" over {DIST['backend']} ({DIST['reason']})")
        print_args(args)
        dump_args(args, args.basedir, args.expname or "exp")
    return _train(args, device, mesh, primary)


def _train(args, device, mesh, primary):
    import torch

    from mpsnerf_torch.data import attach_spconv_plan, to_device_input
    from mpsnerf_torch.data.prefetch import PrefetchLoader
    from mpsnerf_torch.factory import (
        PAIR_DATA_SETS, return_dataset, return_model,
    )
    from mpsnerf_torch.smpl.assets import load_smpl_models
    from mpsnerf_torch.train.checkpoint import restore_latest, save_checkpoint
    from mpsnerf_torch.train.metrics import MetricWriter
    from mpsnerf_torch.train.trainer import TrainConfig, Trainer

    basedir, expname = args.basedir, args.expname or "exp"
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
    # rank 0 loads the items and runs the eval
    dataset = return_dataset(args) if primary else None
    smpl_models = load_smpl_models(device=device)
    if primary:
        n_params = sum(p.numel() for p in model.parameters())
        print(f"Model '{args.model}': {n_params / 1e6:.2f}M params")

    # the newest checkpoint, on every rank; Adam fresh unless
    # --resume_optimizer
    start, restored = 0, None
    if not args.no_reload:
        start, restored = restore_latest(basedir, expname)
    if mesh is None:
        trainer = Trainer(model, cfg, device=device, start_step=start,
                          seed=args.seed)
    else:
        from mpsnerf_torch.parallel.mesh import MeshTrainer, scatter_to_rows

        trainer = MeshTrainer(model, cfg, mesh, start_step=start,
                              seed=args.seed)
    if restored is not None:
        if primary:
            print(f"Reloading from step {start}")
        trainer.restore(restored, load_optimizer=bool(args.resume_optimizer))
    writer = MetricWriter(basedir, expname) if primary else None
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
        if primary:
            tag = f"testset_{trainer.global_step:06d}_more_real_ssim_psnr"
            print("Begin to test, save_weights == 0")
            run_eval(tag)
            print("Saved test set")
            writer.close()
        return run

    profile_dir = os.environ.get("MPSNERF_PROFILE_DIR") if primary else None
    n_iters = args.N_iteration + 1
    running = []
    last_print = last_ckpt = last_eval = trainer.global_step
    t0 = time.time()
    loader = None
    if primary:
        # on a mesh, rank 0 alone draws the single-process stream
        slot = {} if mesh is None else dict(process_index=0, process_count=1)
        loader = PrefetchLoader(dataset, seed=args.seed,
                                num_workers=min(args.num_worker, 4), **slot)

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

    def next_item():
        """This rank's item: the loader's next, or on a mesh its row's of
        the next ``data_size`` (rank 0 sends them)."""
        if mesh is None:
            return next(loader)
        batch = ([next(loader) for _ in range(mesh.data_size)] if primary
                 else None)
        return scatter_to_rows(batch, mesh)

    while trainer.global_step < n_iters:
        # profile the second item (after the first one's lazy set-up)
        do_trace = profile_dir and len(run.logs) == 1
        with _profile(profile_dir if do_trace else None,
                      trainer.global_step, device):
            smpl, sp, tp = prepare(next_item())
            logs = trainer.train_item(smpl, sp, tp)
        running.append(logs)
        run.logs.append(logs)
        gs = trainer.global_step
        if not primary:
            continue

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
                  f"s/{'item' if mesh is None else 'batch'}{drop_str}")
            running = []
            t0 = time.time()

        if gs // args.i_weights > last_ckpt // args.i_weights \
                and args.save_weights:
            last_ckpt = gs
            path = save_checkpoint(basedir, expname, gs, trainer.state())
            print("Saved checkpoints at", path)

        if gs // args.i_testset > last_eval // args.i_testset:
            last_eval = gs
            try:
                run_eval(f"testset_{gs:06d}")
                print("Saved test set")
            except NotImplementedError as e:
                print("eval skipped:", e)
    if primary:
        loader.close()
        writer.close()
    return run


if __name__ == "__main__":
    main()
