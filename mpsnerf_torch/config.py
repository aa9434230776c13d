"""CLI / config-file surface (port of ``mpsnerf_tpu/config.py``): the
reference's flags, one for one, and configargparse's semantics: ``--config
<file>`` of ``key = value`` lines merged with command-line flags, the
command line winning; a key repeated in the file takes its last value (the
shipped configs rely on this).  A small reader reproduces the format.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def _read_config_file(path: str) -> dict:
    """Parse ``key = value`` lines; later duplicates win; '#' comments."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def config_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="run_nerf_batch.py")
    p.add_argument("--config", type=str, default=None, help="config file path")
    p.add_argument("--expname", type=str, help="experiment name")
    p.add_argument("--basedir", type=str, default="./logs/")

    # training options
    p.add_argument("--N_rand", type=int, default=1024 * 32)
    p.add_argument("--lrate", type=float, default=5e-4)
    p.add_argument("--decay_steps", type=int, default=10000)
    p.add_argument("--chunk", type=int, default=1024 * 64)
    p.add_argument("--netchunk_per_gpu", type=int, default=1024 * 64 * 64)
    p.add_argument("--no_reload", action="store_true")
    p.add_argument("--ft_path", type=str, default=None)

    # rendering options
    p.add_argument("--N_samples", type=int, default=64)
    # consumed by the train step and the eval renderer's hierarchical pass
    # (the reference parses it and never uses it; 0 is its behaviour)
    p.add_argument("--N_importance", type=int, default=0)
    p.add_argument("--perturb", type=float, default=1.0)
    p.add_argument("--use_viewdirs", action="store_true")
    p.add_argument("--with_viewdirs", type=int, default=1)

    # dataset options
    p.add_argument("--data_root", type=str, default="msra_h36m/S9/Posing")
    p.add_argument("--data_set_type", type=str, default="multi_pair")
    p.add_argument("--train_split", type=str, default="test")
    p.add_argument("--test_split", type=str, default="test")
    p.add_argument("--image_scaling", type=float, default=0.4)
    p.add_argument("--model", type=str, default="correction_by_f3d")
    p.add_argument("--N_iteration", type=int, default=48001)
    p.add_argument("--white_bkgd", action="store_true")

    p.add_argument("--use_os_env", type=int, default=0)
    p.add_argument("--multi_person", type=int, default=1)

    p.add_argument("--density_loss", type=int, default=0)
    p.add_argument("--correction_loss", type=int, default=0)
    p.add_argument("--acc_loss", type=int, default=1)
    p.add_argument("--T_loss", type=int, default=1)
    p.add_argument("--smooth_loss", type=int, default=1)
    p.add_argument("--consistency_loss", type=int, default=0)

    p.add_argument("--half_acc", type=int, default=0)
    p.add_argument("--human_sample", type=int, default=0)
    p.add_argument("--num_worker", type=int, default=8)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--interval", type=int, default=10)
    p.add_argument("--poses_num", type=int, default=100)
    p.add_argument("--num_instance", type=int, default=100)
    p.add_argument("--test_num_instance", type=int, default=1)
    p.add_argument("--random_pair", type=int, default=1)

    p.add_argument("--use_f2d", type=int, default=0)
    p.add_argument("--use_trans", type=int, default=0)
    p.add_argument("--save_weights", type=int, default=1)
    p.add_argument("--view_num", type=int, default=3)
    p.add_argument("--border", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=1)

    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--ddp", type=int, default=0)
    p.add_argument("--occupancy", type=int, default=0)
    p.add_argument("--mean_shape", type=int, default=1)
    p.add_argument("--correction_field", type=int, default=0)
    p.add_argument("--skinning_field", type=int, default=0)
    p.add_argument("--smooth_interval", type=int, default=4)
    p.add_argument("--append_rgb", type=int, default=1)
    p.add_argument("--male", type=int, default=0)
    p.add_argument("--new_mask", type=int, default=0)
    p.add_argument("--test_persons", type=int, default=2)
    p.add_argument("--ani_nerf_ft", type=int, default=0)

    # logging/saving options
    p.add_argument("--i_print", type=int, default=120)
    p.add_argument("--i_weights", type=int, default=12000)
    p.add_argument("--i_testset", type=int, default=3000)

    p.add_argument("--smpl_shape_loss", type=int, default=1)

    # --- extensions of the JAX package (absent from the reference) ---
    p.add_argument("--compact_fraction", type=float, default=0.5,
                   help="masked-point compaction capacity (1.0 = never drop)")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="shard rays over this many devices (0 = all)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="matmul compute dtype for the NeRF MLP/transformer "
                        "(params and geometry stay float32)")
    p.add_argument("--debug_nans", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume_optimizer", type=int, default=0,
                   help="restore optimizer state on resume (the reference "
                        "intentionally resumes with a fresh Adam)")

    return p


def parse_args(
    argv: Optional[Sequence[str]] = None,
    parser: Optional[argparse.ArgumentParser] = None,
) -> argparse.Namespace:
    """configargparse's merge: the file's values become defaults, the
    command line wins.  A pre-extended ``parser`` (script-specific flags)
    keeps the merge."""
    parser = parser or config_parser()
    args, _ = parser.parse_known_args(argv)
    if args.config:
        typed = {}
        for k, v in _read_config_file(args.config).items():
            action = next((a for a in parser._actions if a.dest == k), None)
            if action is None:
                continue
            if isinstance(action, argparse._StoreTrueAction):
                typed[k] = v.lower() in ("1", "true", "yes")
            elif action.type is not None:
                typed[k] = action.type(v)
            else:
                typed[k] = v
        parser.set_defaults(**typed)
        args = parser.parse_args(argv)
    return args


def print_args(args) -> str:
    lines = ["--------args----------"]
    for k in sorted(vars(args)):
        lines.append(f"{k}: {vars(args)[k]}")
    lines.append("--------args----------\n")
    text = "\n".join(lines)
    print(text)
    return text


def dump_args(args, basedir: str, expname: str) -> None:
    """Write args.txt and config.txt into the experiment directory."""
    os.makedirs(os.path.join(basedir, expname), exist_ok=True)
    with open(os.path.join(basedir, expname, "args.txt"), "w") as f:
        for arg in sorted(vars(args)):
            f.write(f"{arg} = {getattr(args, arg)}\n")
    if getattr(args, "config", None):
        with open(args.config) as src, open(
                os.path.join(basedir, expname, "config.txt"), "w") as f:
            f.write(src.read())
