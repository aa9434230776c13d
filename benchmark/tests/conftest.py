"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark's
data (BENCHMARK.json, configurations, traffic mixes, limits, metric
readers, drivers) whose sizes a CPU run can hold.  The card-only tests
carry the ``card`` marker and decide inside a fixture whether there is a
card."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
DATA = ("configs", "traffic", "limits", "metrics", "drivers")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the check's control runs there)")
    return torch.device("cuda")


def shrink(root: pathlib.Path) -> None:
    """The cells' sizes cut to what a CPU test holds: 64x64 images, a rig
    of 500 vertices, six ring cameras, small tiles and ray counts."""
    for p in (root / "benchmark" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c.update(image_size=64, n_verts=500)
        if c["cameras"] > 6:
            c.update(cameras=6, input_views=[0, 2, 4])
        p.write_text(json.dumps(c))
    for p in (root / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        if "inputs" in t:
            t.update(cameras=6, inputs=[0, 2, 4], check_rays=64, tile=1024)
        else:
            t.update(pool=3, n_rays=32)
        p.write_text(json.dumps(t))


@pytest.fixture
def tiny_root(tmp_path):
    root = tmp_path / "root"
    (root / "benchmark").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root)
    for d in DATA:
        shutil.copytree(BENCH / d, root / "benchmark" / d)
    shrink(root)
    return root


def run_cell(root, workload, seed=7, seconds=1.0, trace=0, extra=()):
    """One CPU run of ``benchmark/run.py`` on ``root`` in a fresh process:
    (exit code, the last line of standard output as JSON or None,
    standard error)."""
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--root", str(root), "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=900, cwd=str(REPO))
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return proc.returncode, last, proc.stderr
