"""The port's jax-free tools (``mpsnerf_torch/tools``): the dataset
validator against ``tools/validate_dataset.py`` and the three learning
proofs at a tiny size on the CPU.

* The validator: both tools run on the same roots, the THuman root of
  ``tests/test_validate_dataset.py`` and the H36M root of
  ``tests/test_h36m_loader.py`` (300 vertices: its vertex and template
  checks fail in both), each clean, with schema drift (the params'
  rotation key dropped) and with a mask removed.  Each check must PASS or
  FAIL alike, under the same name and in the same order, with the same
  exit code; the JAX tool runs in this process (its ``main`` reads
  ``sys.argv``).  The port's command line runs once with jax, cv2 and
  the JAX package made unimportable.
* Each proof's ``main`` trains one or two items at 32^2 (300 vertices; its
  fixed samples, rays and eval tile cut to 8, 32 and 256) into
  ``tmp_path`` and writes the JAX proof's JSON keys and its PNG, with
  finite losses.
"""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from mpsnerf_torch.tools import (
    generalization_proof, pair_train_proof, proof_common, train_proof,
    validate_dataset,
)
from tests.test_h36m_loader import h36m_root  # noqa: F401 (fixture)
from tests.test_validate_dataset import thuman_root  # noqa: F401 (fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"  (PASS|FAIL) (.*?)(?: — |: |$)")
TINY = ["--device", "cpu", "--size", "32", "--n_verts", "300"]


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_dataset", os.path.join(REPO, "tools",
                                             "validate_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checks(text):
    return [m.groups() for m in map(LINE.match, text.splitlines()) if m]


def _run_jax(mod, kind, root, capsys, monkeypatch):
    mod.FAILURES.clear()
    monkeypatch.setattr(sys, "argv", ["validate_dataset.py", "--type", kind,
                                      root])
    try:
        mod.main()
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def _variant(root, case, kind, tmp_path):
    if case == "clean":
        return root
    out = tmp_path / case
    shutil.copytree(root, out)
    if case == "drift":
        params = np.load(out / "new_params" / "0.npy",
                         allow_pickle=True).item()
        params.pop("R" if kind == "thuman" else "Rh")
        np.save(out / "new_params" / "0.npy", params)
    else:
        first = "00/0.png" if kind == "thuman" else "Camera_B1/000000.png"
        os.remove(out / "mask_cihp" / first)
    return str(out)


@pytest.mark.parametrize("case", ["clean", "drift", "missing_mask"])
@pytest.mark.parametrize("kind", ["thuman", "h36m"])
def test_validator_agrees_with_jax(kind, case, thuman_root, h36m_root,
                                   jax_tool, tmp_path, capsys, monkeypatch):
    root = _variant(thuman_root if kind == "thuman" else h36m_root, case,
                    kind, tmp_path)
    code = validate_dataset.main(["--type", kind, root])
    ours = capsys.readouterr().out
    want_code, theirs = _run_jax(jax_tool, kind, root, capsys, monkeypatch)
    assert _checks(ours) == _checks(theirs), ours + theirs
    assert len(_checks(ours)) == 10 and code == want_code
    if kind == "thuman":
        assert code == (0 if case == "clean" else 1)
    if case == "missing_mask":
        assert "missing" in ours and "mask_cihp" in ours
    if case == "drift":
        rot = "'R'" if kind == "thuman" else "'Rh'"
        assert f"missing rotation {rot}" in ours


def test_validator_command_line_without_jax_or_cv2(thuman_root):
    """``python -m mpsnerf_torch.tools.validate_dataset`` with jax, cv2 and
    the JAX package unimportable: exit 0 and every check PASS."""
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'cv2', 'mpsnerf_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['validate_dataset', '--type', 'thuman', sys.argv[1]]\n"
        "runpy.run_module('mpsnerf_torch.tools.validate_dataset',\n"
        "                 run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code, thuman_root], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    checks = _checks(out.stdout)
    assert len(checks) == 10 and {s for s, _ in checks} == {"PASS"}


@pytest.fixture
def tiny(monkeypatch):
    """The proofs' fixed samples, rays and eval tile cut for the CPU."""
    for name, value in (("N_SAMPLES", 8), ("N_RAYS", 32), ("TILE", 256)):
        monkeypatch.setattr(proof_common, name, value)


def _keys(path):
    with open(path) as f:
        return json.load(f)


def test_train_proof_tiny(tmp_path, tiny):
    out = train_proof.main(TINY + ["--items", "1", "--out", str(tmp_path)])
    got = _keys(tmp_path / "torch_synthetic_training_proof.json")
    assert set(got) == {"setup", "train_minutes", "history",
                        "heldout_view_metrics", "mean_heldout_psnr",
                        "mean_heldout_ssim"}
    assert set(got["history"][0]) == {"item", "step", "loss", "psnr", "t"}
    assert set(got["heldout_view_metrics"][0]) == {"pose", "view", "psnr",
                                                   "ssim"}
    assert len(got["heldout_view_metrics"]) == 6
    assert got["history"][-1]["step"] == 6 and "CPU" in got["setup"]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert (tmp_path / "torch_synthetic_novel_view.png").stat().st_size > 0


def test_generalization_proof_tiny(tmp_path, tiny):
    generalization_proof.main(TINY + ["--items", "1", "--out",
                                      str(tmp_path)])
    got = _keys(tmp_path / "torch_generalization_proof.json")
    assert set(got) == {"setup", "history", "results"}
    assert set(got["results"]) == {"heldout", "seen"}
    for res in got["results"].values():
        assert set(res) == {"per_view", "mean_psnr", "mean_ssim"}
        assert [(r["pose"], r["view"]) for r in res["per_view"]] == [
            (0, 1), (0, 3), (1, 1), (1, 3)]
    assert all(np.isfinite(h["loss"]) for h in got["history"])
    assert (tmp_path / "torch_generalization_heldout_subject.png").exists()


def test_pair_train_proof_tiny(tmp_path, tiny):
    out = pair_train_proof.main(TINY + ["--items", "2", "--check", "0",
                                        "--out", str(tmp_path)])
    got = _keys(tmp_path / "torch_pair_train_proof.json")
    assert set(got) == {
        "mode", "setup", "items", "view_steps", "wall_s",
        "same_pose_psnr_first_quarter", "same_pose_psnr_last_quarter",
        "cross_pose_items", "cross_pose_psnr_first_quarter",
        "cross_pose_psnr_last_quarter", "cross_pose_loss_last", "history"}
    assert got["view_steps"] == 12 and len(got["history"]) == 2
    assert set(got["history"][0]) == {"item", "same_pose", "loss", "psnr"}
    assert all(np.isfinite(h["loss"]) for h in out["history"])
