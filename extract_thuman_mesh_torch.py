#!/usr/bin/env python
"""Density-grid mesh extraction CLI of the PyTorch port
(``mpsnerf_torch``), step for step the JAX package's
``extract_thuman_mesh.py``:

    python extract_thuman_mesh_torch.py --config configs/canonical_transformer.txt
    python extract_thuman_mesh_torch.py --config ... --can_flag 1   # canonical frame
    python extract_thuman_mesh_torch.py --config ... --device cpu

The model is ``factory.return_model`` of the flags with the newest
checkpoint under ``<basedir>/<expname>/checkpoints`` (random weights where
there is none); the item is the test split's first.  The target-pose
extraction queries the grid in ``"full"`` mode with the configured
``compact_fraction`` and the item's body grid; ``--can_flag 1`` queries
the canonical big-pose grid in ``"extract_mesh"`` mode (no warps, no
mask, no compaction).  ``--mesh_N`` points per axis (256), the iso level
``--mesh_threshold`` (30); the mesh goes to
``objs/THuman/<expname>/{novel,canonical}_<view_num>_view_pose_<pose>.obj``
under the working directory.  The points compacted away beyond a
query's capacity are counted and printed (``n_dropped``).  Queries run in
chunks of 262,144 points, not padded (nothing compiles per shape).
``--device`` (default ``cuda``) picks the device; there is no fallback to
the CPU.
"""

from __future__ import annotations

import os
import types


def main(argv=None):
    """Run the CLI; returns the run (``verts``, ``tris``, ``obj_path``,
    ``n_dropped``, per-stage ``stats``, the checkpoint ``step``, the
    ``grid``)."""
    from mpsnerf_torch.config import config_parser, parse_args

    parser = config_parser()
    parser.add_argument("--can_flag", type=int, default=0)
    parser.add_argument("--mesh_N", type=int, default=256)
    parser.add_argument("--mesh_threshold", type=float, default=30.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to query on (cpu for the CPU)")
    args = parse_args(argv, parser)

    import numpy as np
    import torch

    from mpsnerf_torch.data import attach_body_grid, to_device_input
    from mpsnerf_torch.factory import return_dataset, return_model
    from mpsnerf_torch.geometry import GridSpec, extract_density_mesh
    from mpsnerf_torch.ops.knn import kernel_buckets
    from mpsnerf_torch.smpl.assets import load_smpl_models
    from mpsnerf_torch.train.checkpoint import restore_latest

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                           "pass --device cpu to run on the CPU")
    torch.manual_seed(args.seed)
    model = return_model(args)
    expname = args.expname or "exp"
    step, state = restore_latest(args.basedir, expname)
    if state is not None:
        print(f"Loaded checkpoint at step {step}")
        model.load_state_dict(state["model"])
    model = model.to(device).eval()
    smpl = load_smpl_models(device=device)

    item = return_dataset(args, split="test")[0]
    if not args.can_flag:
        attach_body_grid(item)  # the O(1) cull of the dense grid queries
    inp = to_device_input(item, device)
    smpl = smpl[int(item["gender"])]

    out_dir = os.path.join("objs", "THuman", expname)
    os.makedirs(out_dir, exist_ok=True)
    mode = "extract_mesh" if args.can_flag else "full"
    dropped = torch.zeros((), dtype=torch.int64, device=device)

    with torch.no_grad():
        latent = model.encode(inp["img_all"])
        buckets = kernel_buckets(inp["t_vertices"])  # once for every chunk

        def density_fn(pts):
            raw = model.query(smpl, inp, inp, latent, pts,
                              torch.zeros_like(pts), t_buckets=buckets,
                              mode=mode)
            dropped.add_(raw.n_dropped)
            return raw.sigma

        verts_src = np.asarray(item["t_vertices" if args.can_flag
                                    else "vertices"])
        grid = GridSpec.from_vertices(verts_src, n=args.mesh_N)
        name = (f"{'canonical' if args.can_flag else 'novel'}_"
                f"{args.view_num}_view_pose_{int(item['pose_index']):03d}.obj")
        obj_path = os.path.join(out_dir, name)
        stats = {}
        verts, tris = extract_density_mesh(
            density_fn, grid, verts_src, smpl.faces,
            threshold=args.mesh_threshold, chunk=262144, obj_path=obj_path,
            device=device, stats=stats)
    n_dropped = int(dropped)
    print(f"done: {len(verts)} verts, {len(tris)} tris -> {obj_path} "
          f"(n_dropped {n_dropped})")
    return types.SimpleNamespace(verts=verts, tris=tris, obj_path=obj_path,
                                 n_dropped=n_dropped, stats=stats, step=step,
                                 grid=grid)


if __name__ == "__main__":
    main()
