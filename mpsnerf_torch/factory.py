"""Model and dataset factories (port of ``mpsnerf_tpu/factory.py``).

``return_model`` builds the flagship model, ``skinning_batch`` at the
flagship's flags; ``return_dataset`` maps ``--data_set_type`` to a loader
with the split's windowing arguments.  Every other model name, model flag
or data set raises ``NotImplementedError`` naming the ``ROADMAP.md`` item
that ports it.
"""

from __future__ import annotations

from typing import Any

from mpsnerf_torch.models.mps_nerf import MPSNeRF

PAIR_DATA_SETS = ("H36M_P", "THuman_P")

# the flagship's model flags, as MPSNeRF implements them
FLAGSHIP_FLAGS = {
    "use_trans": 1, "append_rgb": 1, "with_viewdirs": 0, "human_sample": 1,
    "mean_shape": 0, "correction_field": 0, "skinning_field": 0,
}


def return_model(args: Any) -> MPSNeRF:
    if args.model != "skinning_batch":
        raise NotImplementedError(
            f"model '{args.model}' is not ported: only skinning_batch is "
            "(ROADMAP.md item 6: the model variants, CorrectionF3D, "
            "CorrectionUvhAgg and the vanilla NeRF)")
    off = [f"--{k} {getattr(args, k)} (the port needs {v})"
           for k, v in FLAGSHIP_FLAGS.items() if int(getattr(args, k)) != v]
    if getattr(args, "compute_dtype", "float32") != "float32":
        off.append(f"--compute_dtype {args.compute_dtype} (float32 only)")
    if args.data_set_type in PAIR_DATA_SETS:
        off.append(f"--data_set_type {args.data_set_type} (pair training)")
    if off:
        raise NotImplementedError(
            "skinning_batch with " + ", ".join(off) + " is not ported "
            "(ROADMAP.md item 6: the non-flagship model options)")
    fraction = getattr(args, "compact_fraction", None)
    return MPSNeRF(compact_fraction=fraction if fraction not in (None, 0)
                   else None)


def _windowing(args, split):
    return dict(
        split=split, view_num=args.view_num, N_rand=args.N_rand,
        multi_person=bool(args.multi_person), num_instance=args.num_instance,
        start=args.start, interval=args.interval, poses_num=args.poses_num,
        mean_shape=args.mean_shape, image_scaling=args.image_scaling)


def return_dataset(args: Any, split: str | None = None):
    """The training dataset of ``--data_set_type`` (``split`` defaults to
    ``--train_split``)."""
    split = split or args.train_split
    dst = args.data_set_type

    if dst == "Synthetic":
        from mpsnerf_torch.data.synthetic import SyntheticHumanDataset

        return SyntheticHumanDataset(
            n_poses=args.poses_num, n_cameras=6,
            image_size=int(512 * args.image_scaling), n_rays=args.N_rand,
            num_instances=args.num_instance, split=split)

    if dst in ("THuman_B", "THuman", "THuman_B_R", "THuman_P"):
        from mpsnerf_torch.data import thuman

        kw = dict(_windowing(args, split), male=args.male)
        if dst == "THuman_P":
            return thuman.THumanDatasetPair(
                args.data_root, border=args.border,
                random_pair=bool(args.random_pair), **kw)
        if dst == "THuman_B_R":
            return thuman.THumanDatasetBatchRandom(args.data_root, **kw)
        cls = (thuman.THumanDatasetBatch if dst == "THuman_B"
               else thuman.THumanDataset)
        return cls(args.data_root, model=args.model, **kw)

    if dst in ("H36M_B", "H36M", "H36M_B_All", "H36M_P"):
        from mpsnerf_torch.data import h36m

        kw = _windowing(args, split)
        if dst == "H36M_P":
            return h36m.H36MDatasetPair(
                args.data_root, border=args.border,
                random_pair=bool(args.random_pair), **kw)
        cls = {"H36M_B": h36m.H36MDatasetBatch, "H36M": h36m.H36MDataset,
               "H36M_B_All": h36m.H36MDatasetBatchAll}[dst]
        return cls(args.data_root, new_mask=args.new_mask, **kw)

    raise NotImplementedError(
        f"data_set_type '{dst}' is not available: the port loads "
        "Synthetic, THuman_B, THuman, THuman_B_R, THuman_P, H36M_B, H36M, "
        "H36M_B_All and H36M_P")
