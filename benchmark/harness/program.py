"""The system under test, built the way its command line builds it: the
port's config parser, model factory, ``TrainConfig`` and SMPL container.
Every import of the port is inside a function, so that importing the
harness loads nothing of it."""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from benchmark.harness.weights import seeded_state


def program_args(cfg: Dict):
    """The port's ``args`` from a configuration file's shipped keys, as
    ``--key value`` flags through its own parser (keys it does not know
    are skipped)."""
    from mpsnerf_torch.config import config_parser, parse_args

    parser = config_parser()
    known = {a.dest: a for a in parser._actions}
    argv = []
    for k, v in cfg.items():
        action = known.get(k)
        if action is None or isinstance(v, (dict, list)):
            continue
        if isinstance(action, argparse._StoreTrueAction):
            argv += [f"--{k}"] if str(v).lower() in ("1", "true") else []
        else:
            argv += [f"--{k}", str(v)]
    return parse_args(argv)


def build_model(args, seed: int, device):
    """``factory.return_model(args)`` made on ``device`` and loaded with
    the seeded weights; returns (model, the weights)."""
    from mpsnerf_torch.factory import return_model

    with torch.device(device):
        model = return_model(args)
    state = seeded_state(model.state_dict(), seed, device)
    model.load_state_dict(state)
    return model, state


def train_config(args):
    """``TrainConfig`` as the port's training command line fills it."""
    from mpsnerf_torch.factory import PAIR_DATA_SETS
    from mpsnerf_torch.train.trainer import TrainConfig

    return TrainConfig(
        lrate=args.lrate, decay_steps=args.decay_steps,
        n_samples=args.N_samples, n_importance=args.N_importance,
        perturb=args.perturb, occupancy=bool(args.occupancy),
        white_bkgd=args.white_bkgd,
        acc_loss=bool(args.acc_loss) and not bool(args.half_acc),
        correction_loss=bool(args.correction_loss),
        consistency_loss=bool(args.consistency_loss),
        density_loss=bool(args.density_loss),
        smooth_loss=bool(args.smooth_loss),
        smooth_interval=args.smooth_interval,
        pair_mode=args.data_set_type in PAIR_DATA_SETS)


def smpl_model(rig: Dict, device):
    """The benchmark's rig as the port's ``SMPLModel``."""
    from mpsnerf_torch.smpl.model import SMPLModel

    return SMPLModel(parents=tuple(rig["parents"]), **{
        k: torch.as_tensor(rig[k], device=device)
        for k in ("v_template", "shapedirs", "posedirs", "J_regressor",
                  "weights", "faces")})
