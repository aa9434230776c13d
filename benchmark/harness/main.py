"""One run of one cell: set-up, warm-up, a measured window, with
``--trace 1`` a traced stretch after it, then the check of what the window
produced, and the result as the last line of standard output.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration at the ``file`` the manifest gives, its traffic mix at
``benchmark/traffic/<traffic>.json`` (whose ``driver`` names a module of
``benchmark/drivers``), the limits of its check at
``benchmark/limits/<cell>.json`` and each per-layer metric's reader at
``benchmark/metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time
import types
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "mpsnerf_tpu")
GIB = float(1 << 30)
BENCH = pathlib.Path(__file__).resolve().parents[1]


def forbidden_modules() -> List[str]:
    """The loaded modules whose whole top-level name is JAX's, flax's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_manifest(root: pathlib.Path) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(manifest: Dict, name: str) -> Dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(manifest: Dict, cell: Dict, kind: str) -> List[Dict]:
    """The cell's metrics of ``kind`` (end_to_end or per_layer): those that
    list it, and those without a list whose ``moves`` (or, end to end,
    whose name) the cell reports."""
    e2e = [m for m in manifest["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell["name"] in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def metric_reader(root: pathlib.Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_module(root: pathlib.Path, name: str):
    path = root / "benchmark" / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_driver_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: pathlib.Path, workload: str):
    """(manifest, cell, configuration, traffic mix, limits) by name."""
    manifest = load_manifest(root)
    cell = find_cell(manifest, workload)
    config = next(c for c in manifest["configs"]
                  if c["name"] == cell["config"])
    return (manifest, cell, load_json(root / config["file"]),
            load_json(root / "benchmark" / "traffic"
                      / f"{cell['traffic']}.json"),
            load_json(root / "benchmark" / "limits" / f"{cell['name']}.json"))


def keep_caches_in(root: pathlib.Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc builds already go to its ``build/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "bench_cache" / sub)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the CPU rehearsals of the tests: another root and the CPU
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class Context(types.SimpleNamespace):
    """What a driver reads: ``cfg``, ``traffic``, ``device``, ``seed``,
    ``tmp`` (a directory of the run's), ``chips``, ``cell``."""


def run(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    opts = parse(argv)
    root = pathlib.Path(opts.root).resolve() if opts.root else BENCH.parent
    manifest, cell, cfg, traffic, limits = load_cell(root, opts.workload)
    keep_caches_in(root)

    import torch

    chips = int(cell["chips"])
    if opts.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"{cell['name']} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = torch.device(opts.device)
    cuda = device.type == "cuda"
    driver = driver_module(root, traffic["driver"])
    tmp = tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))
    ctx = Context(cfg=cfg, traffic=traffic, device=device, seed=opts.seed,
                  tmp=tmp, chips=chips, cell=cell)
    try:
        state = driver.setup(ctx)
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        win = driver.window(ctx, state, opts.seconds, bool(opts.trace))
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        result_metrics = {}
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(0) if cuda
                       else "cpu", "count": chips,
                       "memory_peak_bytes": int(max(setup_peak, window_peak))
                       if cuda else 0}
        breakdown = None
        if opts.trace:
            trace, launches, units = driver.profile(ctx, state)
            record = types.SimpleNamespace(
                cfg=cfg, traffic=traffic, window=win, trace=trace,
                launches=launches, profiled_units=units, cell=cell)
            for m in cell_metrics(manifest, cell, "per_layer"):
                value = metric_reader(root, m["name"])(record)
                if value is not None:
                    result_metrics[m["name"]] = {"value": value,
                                                 "unit": m["unit"]}
            from benchmark.harness.trace import device_ops, idle_gaps

            device_info.update(busy_s=trace.busy_s, window_s=trace.wall_s)
            breakdown = {"device_ops": device_ops(trace),
                         "idle_gaps": idle_gaps(trace)}
        else:
            e2e = {"setup_s": setup_s,
                   "peak_mem_gib": window_peak / GIB,
                   traffic["rate_name"]:
                       1e3 * win["wall_s"] / max(1, win["units"])}
            for m in cell_metrics(manifest, cell, "end_to_end"):
                result_metrics[m["name"]] = {"value": e2e[m["name"]],
                                             "unit": m["unit"]}
        driver.release(ctx, state)
        if cuda:
            torch.cuda.empty_cache()
        numbers = driver.check(ctx, state)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = {"correct": correct, "attempted": int(win["units"]),
            "failed": 0 if correct else int(win["units"]),
            "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(line))
    return 0
