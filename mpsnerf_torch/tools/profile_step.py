"""Where one training view-step of a model variant spends the card's time.

    python -m mpsnerf_torch.tools.profile_step --model correction_batch
    python -m mpsnerf_torch.tools.profile_step --model skinning_batch \\
        --flags correction_field=1 compute_dtype=bfloat16

Builds the variant with :func:`variant_model` (``--model`` and ``--flags``
as the CLI takes them) on ``chip_smoke.py``'s 512^2 training scene (3
input views, 1000 rays x 128 samples, the sparse-conv plans attached),
runs two warm-up steps, then profiles one plain and one smooth
``Trainer.view_step`` with ``torch.profiler``: each step's CUDA-event
time, the kernels' summed device time, the matrix products' share of it,
and the ``--top`` kernels by device time.  Needs a CUDA card.

:func:`device_rows`, :func:`gemm_ms` and :func:`variant_model` are also
what ``chip_smoke.py`` sums its profiles and builds its variants with.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

CONFIG_DIR = pathlib.Path(__file__).resolve().parents[2] / "configs"


class KernelRow:
    """One kernel name's launches in a profile: ``key``, ``count``,
    ``self_device_time_total`` (us)."""

    __slots__ = ("key", "count", "self_device_time_total")

    def __init__(self, key):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def device_rows(prof):
    """The profile's device kernels summed by name, largest first.  Summed
    from its events: ``key_averages()`` takes 15-45 s over a served
    view's ~80,000 events on the card's host (and operator rows would
    repeat their kernels' time)."""
    import torch

    rows = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.self_device_time_total <= 0:
            continue
        row = rows.setdefault(e.name, KernelRow(e.name))
        row.count += 1
        row.self_device_time_total += e.self_device_time_total
    return sorted(rows.values(), key=lambda r: r.self_device_time_total,
                  reverse=True)


def gemm_ms(rows):
    """The profile's matrix-product kernels (cuBLAS's and CUTLASS's names
    carry "gemm"), ms."""
    return sum(e.self_device_time_total for e in rows
               if "gemm" in e.key.lower()) / 1e3


def variant_model(model, over, device):
    """``factory.return_model`` on the flagship config with ``--model``
    and the flags ``over`` (name -> value), weights from seed 0, density
    bias +4 (so that a random model's rays are not all empty).  Returns
    (model, args)."""
    import torch

    from mpsnerf_torch.config import parse_args
    from mpsnerf_torch.factory import return_model

    argv = ["--config", str(CONFIG_DIR / "canonical_transformer.txt"),
            "--model", model]
    for k, v in over.items():
        argv += [f"--{k}", str(v)]
    args = parse_args(argv)
    torch.manual_seed(0)
    m = return_model(args)
    with torch.no_grad():
        m.alpha_linear.bias.fill_(4.0)
    return m.to(device), args


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpsnerf_torch.data import attach_spconv_plan, to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.factory import PAIR_DATA_SETS
    from mpsnerf_torch.train.trainer import TrainConfig, Trainer

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="skinning_batch")
    ap.add_argument("--flags", nargs="*", default=[],
                    help="name=value model flags, e.g. correction_field=1")
    ap.add_argument("--top", type=int, default=12)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model, args = variant_model(
        opts.model, dict(f.split("=", 1) for f in opts.flags), dev)
    ds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=512,
                               n_verts=6890, split="train", n_rays=1000)
    smpl = ds.smpl_for(0, device=dev)
    item = to_device_input(attach_spconv_plan(ds.get_item(0, instance_idx=0)),
                           dev, rays=True)
    trainer = Trainer(model, TrainConfig(
        pair_mode=args.data_set_type in PAIR_DATA_SETS), device=dev,
        start_step=2, seed=0)
    for _ in range(2):  # steps 2 and 3: plain
        trainer.view_step(smpl, item, item, 0)
    for _ in range(2):  # steps 4 (smooth) and 5 (plain)
        smooth = trainer.smooth_now()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.view_step(smpl, item, item, 1)
        end.record()
        torch.cuda.synchronize()
        trainer.step -= 1  # the profiled step repeats the timed one's kind
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.view_step(smpl, item, item, 1)
            torch.cuda.synchronize()
        rows = device_rows(prof)
        busy = sum(r.self_device_time_total for r in rows) / 1e3
        print(f"{opts.model} {' '.join(opts.flags)} "
              f"{'smooth' if smooth else 'plain'} step: "
              f"{start.elapsed_time(end):.1f} ms (CUDA events), kernels "
              f"busy {busy:.1f} ms, of which GEMM kernels "
              f"{gemm_ms(rows):.1f} ms", flush=True)
        for r in rows[:opts.top]:
            print(f"  {r.self_device_time_total / 1e3:9.3f} ms "
                  f"{r.count:6d} x  {r.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
