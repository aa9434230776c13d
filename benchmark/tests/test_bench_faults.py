"""The check catches each fault a cell can have: a run with the timed
path broken underneath (the card's look skipped: the CPU) comes out with
``correct`` false.  The faults are ``benchmark/faults.py``'s; the
exchange between chips has no cell yet."""

import json
import pathlib
import sys

import pytest

from conftest import REPO


@pytest.mark.parametrize("workload,fault", [
    ("flagship.train", "state_unchanged"), ("flagship.train", "half_batch"),
    ("h36m_pair.train", "state_unchanged"), ("h36m_pair.train", "half_batch"),
    ("flagship.serve_orbit", "altered_answer")])
def test_a_fault_fails_the_check(tiny_root, workload, fault, capsys):
    sys.path.insert(0, str(REPO))
    from benchmark import faults
    from benchmark.harness import main

    with faults.planted(fault):
        rc = main.run(["--workload", workload, "--seed", "11", "--seconds",
                       "1", "--trace", "0", "--root", str(tiny_root),
                       "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    line = json.loads(out[-1])
    assert line["correct"] is False, line["checks"]


def test_the_sound_run_passes_in_process(tiny_root, capsys):
    from benchmark.harness import main

    assert main.run(["--workload", "flagship.train", "--seed", "11",
                     "--seconds", "1", "--root", str(tiny_root),
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
