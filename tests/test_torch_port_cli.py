"""The port's eval protocols and training CLI on the CPU:
``run_thuman_eval`` and ``run_h36m_eval`` against the JAX runners on the
same fixtures and weights, and ``run_nerf_batch_torch.main`` with
``--device cpu`` on ``configs/synthetic_smoke.txt`` and on a THuman
fixture: its files under the JAX CLI's names, the resume (with Adam's
state under ``--resume_optimizer``), the acc-loss switches and the options
it refuses.

Fixtures: THuman subjects at 48^2 (24 cameras with distortion), the H36M
fixture of ``tests/test_h36m_loader.py`` (rendered at the protocol's
1000^2, masked rays only).  Weights: the JAX model's init through
``from_jax``.  The protocols' tables are cut by monkeypatching (one
human, one pose per pass), and both runners' ``prewarm`` is skipped (it
renders what the protocol renders next; each package tests it apart).
Metrics agree to 1e-4 relative per image (the fp32 tail, as in
``tests/test_torch_port_eval.py``).  TensorBoard's import (it loads
TensorFlow where installed) is blocked in the CLI runs; the JSONL scalars are read.
"""

import json
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu.data.h36m import H36MDatasetBatch as JH36M
from mpsnerf_tpu.data.thuman import THumanDatasetBatch as JTHuman
from mpsnerf_tpu.eval import runner as j_runner
from mpsnerf_tpu.models.mps_nerf import MPSNeRF as JMPSNeRF
from mpsnerf_tpu.smpl.model import synthetic_smpl as j_synthetic_smpl
from mpsnerf_tpu.train.trainer import to_device_input as j_to_device_input
from mpsnerf_tpu.train.losses import LossTerms
from mpsnerf_tpu.train.trainer import summarize_item_logs

from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.eval import runner as t_runner
from mpsnerf_torch.models.mps_nerf import MPSNeRF as TMPSNeRF
from mpsnerf_torch.smpl.assets import ASSET_FILES
from mpsnerf_torch.smpl.model import synthetic_smpl

import run_nerf_batch_torch as cli

from tests.test_h36m_loader import h36m_root  # noqa: F401 (fixture)
from tests.test_torch_port_io import _distort
from tests.thuman_fixture import build_thuman_subject
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

HW = 48
N_VERTS = 120
N_SAMPLES = 8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``all/subject_{F,M}`` with distortion (3 poses), the human list in
    ``data/``; the weights of one JAX init and the port's copy."""
    base = tmp_path_factory.mktemp("thuman_cli")
    roots = [_distort(build_thuman_subject(base / "all" / name, n_poses=3,
                                           hw=HW, n_verts=N_VERTS, seed=i))
             for i, name in enumerate(["subject_F", "subject_M"])]
    (base / "data").mkdir()
    (base / "data" / "THuman_1_human_list.txt").write_text(
        "subject_F\nsubject_M\n")
    item = JTHuman(roots[0], view_num=3, poses_num=1, seed=0).get_item(0)
    inp = j_to_device_input(item)
    smpl = j_synthetic_smpl(n_verts=N_VERTS, seed=0)
    model = JMPSNeRF(num_instances=1)
    variables = jax.jit(lambda key: model.init(
        {"params": key}, smpl, inp, inp, jnp.zeros((8, 3)),
        jnp.zeros((8, 3)), train=False))(jax.random.PRNGKey(0))
    t_model = TMPSNeRF().eval()
    t_model.load_state_dict(from_jax(jax.tree.map(np.asarray, variables)))
    return dict(base=base, roots=roots, model=model, variables=variables,
                smpl=smpl, t_model=t_model,
                t_smpl=synthetic_smpl(n_verts=N_VERTS, seed=0, device="cpu"))


def _no_prewarm(monkeypatch):
    for mod in (j_runner, t_runner):
        monkeypatch.setattr(mod.ViewRenderer, "prewarm",
                            lambda self, *a, **k: [])


def _shared_items(cls):
    """A ``dataset_cls`` whose items ``cls`` builds once per (root, window,
    index) and hands to each runner as a fresh copy, without either
    package's caches (the 1000^2 H36M items take seconds each; the two
    loaders' items are held equal in ``tests/test_torch_port_io.py``)."""
    cache = {}

    class Shared:
        def __init__(self, root, **kw):
            self.ds = cls(root, **kw)
            self.key = (root,) + tuple(sorted(kw.items()))

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            key = self.key + (i,)
            if key not in cache:
                cache[key] = self.ds[i]
            return {k: v for k, v in cache[key].items()
                    if not k.startswith("_") and k != "body_grid"}
    return Shared


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_metrics_match(t, j, tmp_path):
    for key in ("novel_view_mse", "novel_view_psnr", "novel_view_ssim",
                "novel_pose_mse", "novel_pose_psnr", "novel_pose_ssim"):
        assert np.isfinite(t[key]).all(), key
        np.testing.assert_allclose(t[key], j[key], rtol=1e-4, err_msg=key)
    assert t["all_human_names"] == j["all_human_names"]
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def test_run_thuman_eval_matches_jax(tree, tmp_path, monkeypatch):
    """One held-out human, start pose 1, ``poses_num`` 1 at
    ``image_hw`` 48: 8 novel views in each pass."""
    _no_prewarm(monkeypatch)
    for mod in (j_runner, t_runner):
        monkeypatch.setattr(mod, "THUMAN_TEST_RANGE", (1, 2))
        monkeypatch.setattr(mod, "THUMAN_START_POSES", [1])
    monkeypatch.chdir(tree["base"])
    args = types.SimpleNamespace(
        data_root=tree["roots"][0], test_split="test", view_num=3,
        model="skinning_batch", male=0, mean_shape=0, chunk=4096,
        N_samples=N_SAMPLES, N_importance=0, white_bkgd=False)
    j = j_runner.run_thuman_eval(args, tree["model"], tree["variables"],
                                 lambda g: tree["smpl"], str(tmp_path / "j"),
                                 verbose=False, poses_num=1, image_hw=HW)
    t = t_runner.run_thuman_eval(args, tree["t_model"],
                                 lambda g: tree["t_smpl"],
                                 str(tmp_path / "t"), verbose=False,
                                 poses_num=1, image_hw=HW, device="cpu")
    _assert_metrics_match(t, j, tmp_path)
    assert t["novel_view_psnr"].shape == (1, 1, 8)
    assert "novel_pose/subject_M/frame0002_view0023.png" in \
        _files(tmp_path / "t")


def test_run_h36m_eval_matches_jax(tree, h36m_root, tmp_path,  # noqa: F811
                                   monkeypatch):
    """Subject S9's tables cut to one pose per pass; masked rays at
    1000^2, the unmasked image as the ground truth.  Both runners read
    the same items (``_shared_items`` of the JAX loader)."""
    _no_prewarm(monkeypatch)
    for mod in (j_runner, t_runner):
        for name, value in (("H36M_ROOTS", [h36m_root]),
                            ("H36M_SUBJECTS", ["S9"]),
                            ("H36M_POSES_NUM", [1]),
                            ("H36M_NOVEL_VIEW_POSES_NUM", [1]),
                            ("H36M_INPUT_POSE", [0]),
                            ("H36M_START_POSE", [1])):
            monkeypatch.setattr(mod, name, value)
    args = types.SimpleNamespace(
        test_persons=0, test_split="test", view_num=3, mean_shape=0,
        new_mask=0, chunk=4096, N_samples=4, N_importance=0,
        white_bkgd=False)
    j_smpl = j_synthetic_smpl(n_verts=300, seed=0)  # the fixture's count
    t_smpl = synthetic_smpl(n_verts=300, seed=0, device="cpu")
    shared = _shared_items(JH36M)
    j = j_runner.run_h36m_eval(args, tree["model"], tree["variables"],
                               lambda g: j_smpl, str(tmp_path / "j"),
                               dataset_cls=shared, verbose=False)
    t = t_runner.run_h36m_eval(args, tree["t_model"], lambda g: t_smpl,
                               str(tmp_path / "t"), dataset_cls=shared,
                               verbose=False, device="cpu")
    _assert_metrics_match(t, j, tmp_path)
    assert t["novel_pose_psnr"].shape == (1, 1, 1)


# ---- the CLI ---------------------------------------------------------------

def _main(monkeypatch, tmp_path, config, *extra):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = ["--config", os.path.abspath(f"configs/{config}.txt"),
            "--basedir", str(tmp_path / "logs"), "--device", "cpu",
            "--N_samples", "4", "--num_worker", "2", *map(str, extra)]
    return cli.main(argv)


def _scalars(tmp_path, exp):
    path = tmp_path / "logs" / "summaries" / exp / "scalars.jsonl"
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_cli_synthetic_files_and_resume(tmp_path, monkeypatch):
    """One item (6 view-steps), then a resume for one more with Adam's
    state: ``args.txt``, ``config.txt``, ``checkpoints/{step:06d}``,
    ``summaries/<exp>/scalars.jsonl`` with JAX's keys, and the eval's
    files in ``testset_000012``."""
    base = tmp_path / "logs" / "synthetic_smoke"
    run = _main(monkeypatch, tmp_path, "synthetic_smoke", "--N_iteration", 5,
                "--i_print", 6, "--i_weights", 6, "--i_testset", 12)
    assert run.start_step == 0 and run.trainer.global_step == 6
    assert (base / "args.txt").exists() and (base / "config.txt").exists()
    assert "device = cpu" in (base / "args.txt").read_text()
    assert sorted(os.listdir(base / "checkpoints")) == ["000006"]
    logs = run.logs[0]
    assert logs["acc_loss"] > 0 and logs["n_dropped"] == 0
    assert np.isfinite(logs["loss"])
    saved = torch.load(base / "checkpoints" / "000006", weights_only=True)

    run = _main(monkeypatch, tmp_path, "synthetic_smoke", "--N_iteration",
                11, "--i_print", 6, "--i_weights", 6, "--i_testset", 12,
                "--resume_optimizer", 1)
    assert run.start_step == 6 and run.trainer.global_step == 12
    # Adam's moments resumed: 6 steps restored + 6 taken (fresh: 6)
    state = run.trainer.optimizer.state_dict()["state"]
    assert all(int(s["step"]) == 12 for s in state.values())
    assert len(saved["optimizer"]["state"]) == len(state)
    assert sorted(os.listdir(base / "checkpoints")) == ["000006", "000012"]
    recs = _scalars(tmp_path, "synthetic_smoke")
    assert [r["step"] for r in recs] == [6, 12]
    zero = LossTerms(*[0.0] * len(LossTerms._fields))
    want = set(summarize_item_logs([(zero, 0.0)], 0))  # JAX's [TRAIN] keys
    assert set(recs[0]) == want | {"step", "time"}
    files = _files(base / "testset_000012")
    assert "metrics.json" in files and "metrics.npy" in files
    assert any(f.startswith("novel_view/") and f.endswith("_gt.png")
               for f in files)


def test_cli_resume_restores_step_and_fresh_adam(tmp_path, monkeypatch):
    """Without ``--resume_optimizer`` the weights and step come back and
    Adam restarts, as in the reference."""
    _main(monkeypatch, tmp_path, "synthetic_smoke", "--N_iteration", 5,
          "--i_weights", 6, "--i_testset", 10 ** 6)
    saved = torch.load(tmp_path / "logs" / "synthetic_smoke" / "checkpoints"
                       / "000006", weights_only=True)
    run = _main(monkeypatch, tmp_path, "synthetic_smoke", "--N_iteration", 5,
                "--i_testset", 10 ** 6)
    assert run.start_step == run.trainer.global_step == 6 and not run.logs
    for k, v in run.trainer.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    assert run.trainer.optimizer.state_dict()["state"] == {}


@pytest.mark.parametrize("flags,n_importance", [
    (("--half_acc", 1), 0),
    (("--acc_loss", 0), 2),
])
def test_cli_acc_loss_switches(tmp_path, monkeypatch, flags, n_importance):
    """``--half_acc 1`` and ``--acc_loss 0`` each give a zero acc term, on
    the plain path and on the hierarchical one (the fault: the port's
    loss took the acc term whatever the flags)."""
    run = _main(monkeypatch, tmp_path, "synthetic_smoke", "--N_iteration", 5,
                "--i_testset", 10 ** 6, "--N_importance", n_importance,
                *flags)
    assert run.trainer.cfg.acc_loss is False
    assert run.trainer.cfg.n_importance == n_importance
    terms = [t for t, _ in run.trainer.last_logs]
    assert len(terms) == 6 and all(float(t.acc) == 0.0 for t in terms)
    assert all(float(t.img) > 0 for t in terms)
    assert run.logs[0]["acc_loss"] == 0.0


def _write_smpl_assets(assets, n_verts=N_VERTS):
    """The fixture's rigs (its vertex count) as SMPL pickles in
    ``assets/``, which ``load_smpl_models`` reads by gender."""
    os.makedirs(assets, exist_ok=True)
    for gender, fname in ASSET_FILES.items():
        rig = synthetic_smpl(n_verts=n_verts, seed=gender, device="cpu")
        parents = np.asarray(rig.parents)
        with open(os.path.join(assets, fname), "wb") as f:
            pickle.dump({
                "v_template": rig.v_template.numpy(),
                "shapedirs": rig.shapedirs.numpy(),
                "posedirs": rig.posedirs.numpy(),
                "J_regressor": rig.J_regressor.numpy(),
                "weights": rig.weights.numpy(), "f": rig.faces.numpy(),
                "kintree_table": np.stack([parents, np.arange(24)]),
            }, f)


def test_cli_thuman_trains(tree, tmp_path, monkeypatch):
    """The flagship config on a THuman fixture with ``--batch_size 1``:
    one item of 24 view-steps through the port's loader and the rigs of
    ``assets/``, the smooth loss every 4th, finite, nothing dropped, a
    checkpoint.  The item is loaded in the loop (``--num_worker 0``): on
    a loaded CPU the loader threads' Python holds the GIL between the
    step's ops (in one whole-suite run on 8 loaded cores this test took
    306 s, against 4 s alone);
    the synthetic runs above keep the threads."""
    _write_smpl_assets(str(tree["base"] / "assets"))
    monkeypatch.chdir(tree["base"])
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = cli.main([
        "--config", os.path.join(repo, "configs", "canonical_transformer.txt"),
        "--basedir", str(tmp_path / "logs"), "--device", "cpu",
        "--data_root", tree["roots"][0], "--batch_size", "1",
        "--multi_person", "0", "--num_instance", "1", "--poses_num", "2",
        "--N_rand", "32", "--N_samples", "4", "--N_iteration", "23",
        "--i_print", "24", "--i_weights", "24", "--num_worker", "0"])
    assert run.trainer.global_step == 24
    terms = [t for t, _ in run.trainer.last_logs]
    assert sum(float(t.smpl_normal) > 0 for t in terms) == 6
    assert all(np.isfinite(float(t.total)) for t in terms)
    assert run.logs[0]["n_dropped"] == 0
    assert os.listdir(tmp_path / "logs" / "THuman_3_view" / "checkpoints") \
        == ["000024"]


@pytest.mark.parametrize("extra,part", [
    (("--batch_size", 3, "--mesh_devices", 4), "not divisible"),
    (("--batch_size", 2, "--mesh_devices", 3), "not divisible"),
    (("--batch_size", 4, "--mesh_devices", 6), "not divisible"),
    (("--batch_size", 1, "--model", "nope"), "not available"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, extra, part):
    """What the CLI refuses: a mesh whose rank count does not divide by
    the batch (JAX's rule; the batched and sharded trainers themselves
    run in ``tests/test_torch_port_parallel_cli.py``) and a model outside
    the factory."""
    err = NotImplementedError if part == "not available" else ValueError
    with pytest.raises(err, match=part):
        _main(monkeypatch, tmp_path, "canonical_transformer", *extra)


def test_profile_scope_writes_a_trace(tmp_path):
    """The trace ``MPSNERF_PROFILE_DIR`` asks for (the CLI's second
    item), named by the step; no directory, no trace."""
    with cli._profile(str(tmp_path / "trace"), 6, torch.device("cpu")):
        torch.ones(8).sum()
    assert os.listdir(tmp_path / "trace") == ["item_step000006.json"]
    with cli._profile(None, 7, torch.device("cpu")):
        torch.ones(8).sum()
    assert len(os.listdir(tmp_path / "trace")) == 1


def test_cli_needs_a_card_for_cuda(tmp_path, monkeypatch):
    """No silent fallback: ``--device cuda`` without a card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--config", "configs/synthetic_smoke.txt",
                  "--basedir", str(tmp_path)])
