"""Each traffic mix's control flow, rehearsed on the CPU at a tiny size:
set-up, window, the traced stretch, the check and the result line."""

import subprocess
import sys

import pytest

from conftest import run_cell, shrink


@pytest.mark.parametrize("workload,trace", [
    ("flagship.serve_orbit", 0), ("flagship.serve_orbit", 1),
    ("flagship.train", 0), ("h36m_pair.train", 0)])
def test_a_cell_runs_and_is_correct(tiny_root, workload, trace):
    rc, line, err = run_cell(tiny_root, workload, trace=trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-2000:]
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "breakdown" in line
    else:
        assert "setup_s" in line["metrics"]
    # the numbers compared, each beside its limit, are the last lines of
    # standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def test_no_card_no_result(tiny_root):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc, line, err = run_cell(tiny_root, "flagship.train",
                             extra=("--device", "cuda"))
    assert rc != 0 and line is None, err[-1000:]


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files (no
    program) exits with an error and prints no result."""
    import shutil

    from conftest import BENCH, REPO

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "flagship.train",
         "--seed", "3", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode != 0
    assert not proc.stdout.strip().startswith("{")
