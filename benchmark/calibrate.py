"""The readings that the check's limits are set from, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> ... \\
        [--control <k>] [--fault <name> --fault-seeds <k>] [--seconds <s>]

In one process, for each seed: the cell's set-up, a short window and its
check (a sound run: the lower readings); for the first ``--control``
seeds the control (the plain reference in the nearest lower precision,
TF32, judged as the program is: the upper readings); for the first
``--fault-seeds`` seeds the run with a fault planted in the program
(``faults.py``).  One JSON line a run on standard output, with the worst
leaves of a training check."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness import main as harness  # noqa: E402
from benchmark import faults  # noqa: E402


def one(root, workload, seed, seconds, device, kind, fault=None):
    import torch

    _, cell, cfg, traffic, _ = harness.load_cell(root, workload)
    driver = harness.driver_module(root, traffic["driver"])
    ctx = harness.Context(cfg=cfg, traffic=traffic, device=device, seed=seed,
                          tmp=tempfile.mkdtemp(prefix="calib-"),
                          chips=int(cell["chips"]), cell=cell)
    t0 = time.perf_counter()
    with faults.planted(fault):
        st = driver.setup(ctx)
        driver.window(ctx, st, seconds, False)
    driver.release(ctx, st)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = (driver.control if kind == "control" else driver.check)(ctx, st)
    return {"workload": workload, "seed": seed, "kind": kind,
            "fault": fault, "numbers": numbers,
            "detail": st.get("detail"), "s": time.perf_counter() - t0}


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    root = (pathlib.Path(opts.root).resolve() if opts.root
            else harness.BENCH.parent)
    harness.keep_caches_in(root)
    device = torch.device(opts.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    runs = [(s, "sound", None) for s in opts.seeds]
    runs += [(s, "control", None) for s in opts.seeds[:opts.control]]
    runs += [(s, "fault", opts.fault)
             for s in opts.seeds[:opts.fault_seeds]]
    for seed, kind, fault in runs:
        print(json.dumps(one(root, opts.workload, seed, opts.seconds, device,
                             kind, fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
