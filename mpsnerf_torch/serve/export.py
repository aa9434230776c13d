#!/usr/bin/env python
"""Checkpoint -> serving bundle CLI of the port (port of
``mpsnerf_tpu/serve/export.py``): train with ``run_nerf_batch_torch.py``,
then

    python -m mpsnerf_torch.serve.export --config configs/xxx.txt \\
        --bundle_dir bundles/actor1 [--serve_chunk 4096]

loads the experiment's newest checkpoint and writes a bundle that
``python -m mpsnerf_torch.serve.server --bundle bundles/actor1`` serves.
The model is ``factory.return_model`` of the flags; ``--N_samples`` and
``--white_bkgd`` set the render; the test split's first item fixes the
request schema.  The JAX CLI's XLA options are refused:
``--shard_devices`` > 0 (the port renders on one device) and
``--export_platforms`` (nothing is lowered); ``--serve_headroom`` (the
JAX graphs' static capacities) does not exist here, the port's
capacities being exact.
"""

from __future__ import annotations

import os


def main(argv=None) -> str:
    """Run the CLI; returns the bundle directory."""
    from mpsnerf_torch.config import config_parser, parse_args

    parser = config_parser()
    parser.add_argument("--bundle_dir", type=str, default=None,
                        help="output directory (default: "
                             "<basedir>/<expname>/bundle)")
    parser.add_argument("--serve_chunk", type=int, default=4096,
                        help="rays per chunk of the chunked path")
    parser.add_argument("--shard_devices", type=int, default=0,
                        help="refused above 0: the port renders on one "
                             "device")
    parser.add_argument("--export_platforms", type=str, default=None,
                        help="refused: the port lowers no graphs")
    parser.add_argument("--allow_random_init", type=int, default=0,
                        help="export even when no checkpoint exists")
    parser.add_argument("--serve_global", type=int, default=1,
                        help="serve views on the global path (human-sample "
                             "models)")
    parser.add_argument("--serve_tile", type=int, default=16384,
                        help="tail tile of the global path")
    parser.add_argument("--serve_mesh_chunk", type=int, default=262144,
                        help="points per density query of /mesh and "
                             "/animate; 0 exports no mesh extraction")
    args = parse_args(argv, parser)
    if args.shard_devices > 0:
        raise SystemExit(
            f"--shard_devices {args.shard_devices}: a port bundle renders on "
            "one device (multi-device serving is not ported)")
    if args.export_platforms:
        raise SystemExit(
            f"--export_platforms {args.export_platforms}: a port bundle "
            "holds weights, not lowered graphs; it loads on any device")

    from mpsnerf_torch.factory import (
        PAIR_DATA_SETS, return_dataset, return_model,
    )
    from mpsnerf_torch.serve.bundle import export_serving_bundle
    from mpsnerf_torch.smpl.assets import load_smpl_models
    from mpsnerf_torch.train.checkpoint import restore_latest

    import torch

    torch.manual_seed(args.seed)
    model = return_model(args)
    expname = args.expname or "exp"
    step, state = restore_latest(args.basedir, expname)
    if state is not None:
        print(f"Loaded checkpoint at step {step}")
        model.load_state_dict(state["model"])
    elif not args.allow_random_init:
        raise SystemExit(f"no checkpoint under {args.basedir}/{expname}: "
                         "train first, or pass --allow_random_init 1")
    else:
        print("WARNING: exporting RANDOM-INIT weights "
              "(--allow_random_init 1)")

    first = return_dataset(args, split="test")[0]
    pair = args.data_set_type in PAIR_DATA_SETS
    sp_item = first["sp_input"] if pair else first
    tp_item = first["tp_input"] if pair else first
    out_dir = args.bundle_dir or os.path.join(args.basedir, expname, "bundle")
    export_serving_bundle(
        out_dir, args, model, load_smpl_models(device="cpu"), dict(sp_item),
        dict(tp_item), chunk=args.serve_chunk, n_samples=args.N_samples,
        white_bkgd=bool(args.white_bkgd),
        global_compact=bool(args.serve_global), tile=args.serve_tile,
        mesh_chunk=args.serve_mesh_chunk)
    sizes = {f: os.path.getsize(os.path.join(out_dir, f))
             for f in sorted(os.listdir(out_dir))}
    print(f"bundle written to {out_dir} ({sum(sizes.values()) / 1e6:.1f} MB):")
    for f, s in sizes.items():
        print(f"  {f:24s} {s / 1e6:8.2f} MB")
    return out_dir


if __name__ == "__main__":
    main()
