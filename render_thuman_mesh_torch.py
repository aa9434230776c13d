#!/usr/bin/env python
"""Normal-map mesh rendering CLI of the PyTorch port (``mpsnerf_torch``),
the JAX package's ``render_thuman_mesh.py``: every ``.obj`` under
``objs/THuman/<expname>/`` (or ``--objs_dir``) rendered from cameras
``--cameras`` (4 12 20) as vertex-normal colour maps, each written beside
its mesh as ``<mesh>_view_<j>_normal.png`` (RGBA, cropped to 512 x 256).

    python render_thuman_mesh_torch.py --config configs/canonical_transformer.txt

The cameras are ``<data_root>/annots.npy``'s, or the synthetic ring's
where there is none.  It runs on the host (the port's rasteriser), as the
JAX CLI does: nothing of it runs on a device.
"""

from __future__ import annotations

import os


def main(argv=None):
    """Run the CLI; returns the PNG paths it wrote."""
    import numpy as np

    from mpsnerf_torch.config import config_parser, parse_args
    from mpsnerf_torch.geometry import render_normal_map
    from mpsnerf_torch.native import load_obj

    parser = config_parser()
    parser.add_argument("--objs_dir", type=str, default=None)
    parser.add_argument("--cameras", type=int, nargs="*", default=[4, 12, 20])
    args = parse_args(argv, parser)

    objs_dir = args.objs_dir or os.path.join(
        "objs", "THuman", args.expname or "exp")
    ann_path = os.path.join(args.data_root, "annots.npy")
    if os.path.exists(ann_path):
        cams = np.load(ann_path, allow_pickle=True).item()["cams"]
        Ks = np.array(cams["K"])
        Rs = np.array(cams["R"])
        Ts = np.array(cams["T"]).reshape(len(Ks), 3)
    else:
        # ring cameras where there is no capture
        from mpsnerf_torch.data.synthetic import _ring_camera

        cams = [_ring_camera(2 * np.pi * i / 24, 2.2, 0.1, 512, 512)
                for i in range(24)]
        Ks = np.stack([c[0] for c in cams])
        Rs = np.stack([c[1] for c in cams])
        Ts = np.stack([c[2].reshape(3) for c in cams])

    written = []
    for f in sorted(os.listdir(objs_dir)):
        if not f.endswith(".obj"):
            continue
        mesh_path = os.path.join(objs_dir, f)
        print(f)
        verts, tris = load_obj(mesh_path)
        for j, cam_idx in enumerate(args.cameras):
            out = f"{mesh_path[:-4]}_view_{j:03d}_normal.png"
            render_normal_map(verts, tris, Ks[cam_idx], Rs[cam_idx],
                              Ts[cam_idx], save_path=out)
            written.append(out)
            print("  ->", out)
    return written


if __name__ == "__main__":
    main()
