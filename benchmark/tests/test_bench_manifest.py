"""BENCHMARK.json keeps the contract's shape, names and units, and every
name it gives is found as a file."""

import json
import re

from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    m = manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
    for metric in m["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for cell in m["workloads"]:
        for key in ("config", "traffic"):
            assert NAME.match(cell[key])
        assert cell["chips"] in (1, 4)
        assert 1 <= len(cell["why"]) <= 200


def test_every_name_is_a_file():
    m = manifest()
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for c in m["configs"]:
        assert (REPO / c["file"]).is_file()
        cfg = json.loads((REPO / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in cfg["shipped"] and NAME.match(key)
    for cell in m["workloads"]:
        traffic = json.loads(
            (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (BENCH / "limits" / f"{cell['name']}.json").is_file()
    for metric in m["per_layer"]:
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
        assert metric["moves"] in e2e
        for w in metric.get("workloads", []):
            assert w in {c["name"] for c in m["workloads"]}


def test_roofline_and_mfu_names():
    for metric in manifest()["per_layer"]:
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
