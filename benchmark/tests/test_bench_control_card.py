"""The check's control on the card: the plain reference with TF32
products put in the program's place fails the check's limits.  At a
test's size (the cells' widths, 256x256 images, a short window); the
cells' own readings are ``calibrate.py``'s (PERF.md)."""

import json

import pytest

from conftest import BENCH, REPO


@pytest.mark.card
@pytest.mark.parametrize("workload", ["flagship.serve_orbit",
                                      "flagship.train", "h36m_pair.train"])
def test_control_fails(card, tiny_root, workload, capsys):
    import sys

    sys.path.insert(0, str(REPO))
    from benchmark import calibrate

    for p in (tiny_root / "benchmark" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c.update(image_size=256, n_verts=6890)
        p.write_text(json.dumps(c))
    calibrate.main(["--workload", workload, "--seeds", "5", "--control", "1",
                    "--seconds", "2", "--root", str(tiny_root)])
    runs = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    sound, control = runs
    assert all(v <= limits[k] for k, v in sound["numbers"].items())
    assert any(v > limits[k] for k, v in control["numbers"].items())
