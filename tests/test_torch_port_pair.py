"""Pair training and the losses that need the correction field, on the
CPU: each loss term (and the pair pose gate) of a plain view-step against
the JAX package's on the same weights; ``run_nerf_batch_torch.main`` on
the shipped ``configs/h36m.txt`` over the H36M fixture of
``tests/test_h36m_loader.py`` and with the correction field and its loss
on the synthetic config; a ``THuman_P`` pair item from the port's factory
and loader through one view-step.  The loaders' pair generator is
unseeded, as the JAX package's: the tests seed it."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu.models.mps_nerf import MPSNeRF as JMPSNeRF
from mpsnerf_tpu.train.trainer import to_device_input as j_to_device_input

from mpsnerf_torch.compat.from_jax import from_jax
from mpsnerf_torch.models.mps_nerf import MPSNeRF as TMPSNeRF
from mpsnerf_torch.smpl.model import synthetic_smpl
from mpsnerf_torch.train import trainer as t_trainer_mod

import run_nerf_batch_torch as cli

from tests.test_h36m_loader import h36m_root  # noqa: F401 (fixture)
from tests.test_torch_port_cli import _write_smpl_assets
from tests.thuman_fixture import build_thuman_subject
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


PAIR_LOSSES = ("correction_loss", "consistency_loss", "density_loss",
               "pair_mode")


@pytest.mark.parametrize("field", PAIR_LOSSES)
def test_train_config_losses_match_jax(field):
    """Each loss and pair training that used to raise: a plain view-step's
    loss terms (perturb 0) against the JAX package's on the same weights,
    at 1e-5, with the term switched on (the correction field aggregate, the
    source and target one pose apart in pair mode, so the gated image term
    is 0 and ``img_raw`` is not)."""
    from mpsnerf_tpu.data import attach_spconv_plan as j_attach
    from mpsnerf_tpu.train import trainer as j_trainer

    from mpsnerf_torch.data import attach_spconv_plan, to_device_input
    from mpsnerf_torch.train import trainer as t_trainer
    from tests.test_torch_port_variants import _items, random_variables

    j_smpl, items = _items()
    pair = field == "pair_mode"
    j_sp, j_tp = [j_to_device_input(j_attach(dict(it))) for it in items]
    t_sp, t_tp = [to_device_input(attach_spconv_plan(dict(it)), "cpu",
                                  rays=True) for it in items]
    if not pair:
        j_sp, t_sp = j_tp, t_tp
    kw = dict(num_instances=3, nerf_width=32, nerf_depth=2, nerf_skips=(),
              correction_field=field == "correction_loss", pair_mode=pair)
    model = JMPSNeRF(**kw)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, j_smpl, j_tp, j_tp, jnp.zeros((8, 3)),
        jnp.ones((8, 3)), train=False), jax.random.PRNGKey(0))
    variables = random_variables(shapes)
    cfg = dict(n_samples=4, perturb=0.0, **{field: True})
    loss = j_trainer.make_loss_fn(model, j_trainer.TrainConfig(**cfg), False)
    rays = (j_tp["ray_o_all"][0], j_tp["ray_d_all"][0],
            j_tp["near_all"][0][:, 0], j_tp["far_all"][0][:, 0],
            j_tp["rgb_all"][0], j_tp["bkgd_msk_all"][0])
    _, (terms, _, _) = jax.jit(lambda v: loss(
        v["params"], v["batch_stats"], j_smpl, j_sp, j_tp, *rays,
        jax.random.PRNGKey(0)))(variables)
    t_model = TMPSNeRF(**kw)
    t_model.load_state_dict(from_jax(variables), strict=True)
    t_loss = t_trainer.make_loss_fn(t_model, t_trainer.TrainConfig(**cfg),
                                    False)
    with torch.no_grad():
        _, (t_terms, _) = t_loss(
            synthetic_smpl(n_verts=500, seed=0, device="cpu"), t_sp, t_tp,
            *t_trainer.train_rays(t_tp, 0, "cpu"))
    for f in terms._fields:
        np.testing.assert_allclose(float(getattr(terms, f)),
                                   float(getattr(t_terms, f)), atol=1e-5,
                                   err_msg=f)
    name = {"correction_loss": "correction", "consistency_loss":
            "consistency", "density_loss": "density"}.get(field)
    if pair:
        assert float(t_terms.img) == 0.0 < float(t_terms.img_raw)
    else:
        assert float(getattr(t_terms, name)) > 0


def _seeded_datasets(monkeypatch, seed):
    """The loaders draw from an unseeded generator (as the JAX package's
    do); seed it so that the run's pairs are fixed."""
    from mpsnerf_torch import factory

    make = factory.return_dataset

    def seeded(*a, **k):
        ds = make(*a, **k)
        ds.rng = np.random.default_rng(seed)
        return ds
    monkeypatch.setattr(factory, "return_dataset", seeded)


def _pair_terms(run):
    """(img, img_raw) of each view-step and whether its item paired two
    poses."""
    return [(float(t.img), float(t.img_raw)) for t, _ in run.trainer.last_logs]


@pytest.mark.parametrize("case", ["H36M_P", "correction_loss"])
def test_cli_trains_pair_data_sets_and_the_correction_field(
        case, h36m_root, tmp_path, monkeypatch):  # noqa: F811
    """What the CLI used to refuse now trains, finite with nothing
    dropped: the shipped ``configs/h36m.txt`` (``--batch_size 1``,
    multi-person over the H36M fixture, linked to the config's subject
    paths, 2 pair items of 4 view-steps); the aggregate correction field
    with its loss on the synthetic config (1 item of 6: the zero-init
    field's loss is 0 at the first step and > 0 once it has moved).  A pair
    whose poses differ has a gated image term of 0 and a real ``img_raw``;
    one of the same pose counts its image term."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = ["--basedir", str(tmp_path / "logs"), "--device", "cpu",
            "--batch_size", "1", "--N_rand", "32", "--N_samples", "4",
            "--i_testset", "1000000", "--num_worker", "0"]
    seen = []
    orig = t_trainer_mod.Trainer.train_item

    def spy(trainer, smpl, sp, tp):
        seen.append(int(sp["pose_index"]) == int(tp["pose_index"]))
        return orig(trainer, smpl, sp, tp)

    monkeypatch.setattr(t_trainer_mod.Trainer, "train_item", spy)
    if case == "H36M_P":
        work = tmp_path / "work"
        for sub in ("H36M/S1", "h36m/S1", "h36m/S5", "h36m/S6", "h36m/S7",
                    "h36m/S9"):
            (work / "data" / sub).mkdir(parents=True)
            os.symlink(h36m_root, work / "data" / sub / "Posing")
        _write_smpl_assets(str(work / "assets"), n_verts=300)
        monkeypatch.chdir(work)
        _seeded_datasets(monkeypatch, 0)
        argv = ["--config", os.path.join(repo, "configs", "h36m.txt"),
                "--poses_num", "2", "--interval", "1", "--N_iteration", "7",
                "--i_weights", "8", "--i_print", "4", "--image_scaling",
                "0.2"]
        steps = 8
    else:
        argv = ["--config", os.path.join(repo, "configs",
                                         "synthetic_smoke.txt"),
                "--correction_field", "1", "--correction_loss", "1",
                "--N_iteration", "5"]
        steps = 6
    run = cli.main(argv + base)
    assert run.trainer.global_step == steps
    assert run.trainer.model.correction_field == (case == "correction_loss")
    assert run.trainer.cfg.pair_mode == (case != "correction_loss")
    terms = [t for t, _ in run.trainer.last_logs]
    assert all(np.isfinite(float(x)) for t in terms for x in t)
    assert all(lg["n_dropped"] == 0 for lg in run.logs)
    last_same = seen[-1]
    for img, raw in _pair_terms(run):
        assert raw > 0 and (img == raw if last_same else img == 0.0)
    if case == "H36M_P":
        assert seen == [True, False]  # seeded: one pair of each kind
    if case == "correction_loss":
        # the zero-init field starts at the pure LBS warp, then moves
        assert float(terms[0].correction) == 0.0 < float(terms[-1].correction)


def test_thuman_pair_item_trains(tmp_path):
    """``--data_set_type THuman_P``: ``factory.return_dataset`` gives a
    (source, target) pair item of the THuman loader, ``return_model`` the
    pair model, and one view-step of ``Trainer`` on it is finite, gated
    by the poses, and moves the parameters."""
    from mpsnerf_torch import factory
    from mpsnerf_torch.config import parse_args
    from mpsnerf_torch.data import to_device_input

    root = build_thuman_subject(tmp_path / "subject_F", n_poses=3, hw=48,
                                n_verts=120, seed=0)
    args = parse_args([
        "--config", "configs/canonical_transformer.txt", "--data_set_type",
        "THuman_P", "--data_root", root, "--multi_person", "0",
        "--num_instance", "1", "--poses_num", "3", "--N_rand", "32",
        "--N_samples", "4"])
    ds = factory.return_dataset(args)
    ds.rng = np.random.default_rng(0)
    pair = ds[0]
    sp, tp = (to_device_input(pair[k], "cpu", rays=k == "tp_input")
              for k in ("sp_input", "tp_input"))
    torch.manual_seed(0)
    model = factory.return_model(args)
    assert model.pair_mode and tp["rgb_all"].shape[0] == 24
    trainer = t_trainer_mod.Trainer(
        model, t_trainer_mod.TrainConfig(n_samples=4, pair_mode=True),
        device="cpu", start_step=1)
    before = [p.detach().clone() for p in model.parameters()]
    terms, _ = trainer.view_step(
        synthetic_smpl(n_verts=120, seed=0, device="cpu"), sp, tp, 0)
    assert all(np.isfinite(float(x)) for x in terms)
    same = int(sp["pose_index"]) == int(tp["pose_index"])
    assert float(terms.img_raw) > 0
    assert (float(terms.img) == float(terms.img_raw)) == same
    assert same or float(terms.img) == 0.0
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
