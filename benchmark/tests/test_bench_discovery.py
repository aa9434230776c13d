"""A configuration, a traffic mix and a per-layer metric added as new
files and manifest entries alone are found by name, with no edit of the
harness."""

import json
import shutil

from conftest import run_cell

METRIC = '''"""Optimizer steps the window completed (a test metric)."""


def read(run):
    return float(run.window["units"])
'''


def test_new_files_are_found_by_name(tiny_root):
    b = tiny_root / "benchmark"
    shutil.copy(b / "configs" / "flagship.json", b / "configs" / "other.json")
    traffic = json.loads((b / "traffic" / "train.json").read_text())
    traffic["pool"] = 2
    (b / "traffic" / "train_small.json").write_text(json.dumps(traffic))
    (b / "metrics" / "steps_in_window.py").write_text(METRIC)
    shutil.copy(b / "limits" / "flagship.train.json",
                b / "limits" / "other.train_small.json")
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "other", "source": "a test",
                         "file": "benchmark/configs/other.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "other.train_small", "config": "other",
                           "traffic": "train_small", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "Train entry", "moves": "train_step_ms",
                           "workloads": ["other.train_small"]})
    for metric in m["end_to_end"]:
        if metric["name"] == "train_step_ms":
            metric["workloads"].append("other.train_small")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))
    rc, line, err = run_cell(tiny_root, "other.train_small", trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"]
    assert line["metrics"]["steps_in_window"]["value"] >= 1
    assert "mfu.train" not in line["metrics"]  # not listed for the new cell
