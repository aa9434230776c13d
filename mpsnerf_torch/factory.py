"""Model and dataset factories (port of ``mpsnerf_tpu/factory.py``).

``return_model`` maps ``--model`` to ``MPSNeRF`` with the variant's flags
over the command line's (``_MODEL_VARIANTS``, the JAX package's table), or
to the numpy-era per-sample models: ``correction_by_f3d`` and
``correction_by_f3d_fagg`` (``CorrectionF3D``, the ``_fagg`` with the
windowed aggregate), ``correction_by_uvh_agg`` and
``correction_by_uvh_agg_fagg`` (``CorrectionUvhAgg``); unknown names raise
``NotImplementedError``.  ``return_dataset`` maps ``--data_set_type`` to a
loader with the split's windowing arguments.
"""

from __future__ import annotations

from typing import Any

from mpsnerf_torch.models.mps_nerf import MPSNeRF

PAIR_DATA_SETS = ("H36M_P", "THuman_P")

# model string -> flags over the command line's (the reference's variants
# share the SKinningBatch pipeline with other deform stages)
_MODEL_VARIANTS = {
    "skinning_batch": {},
    # CoarseBatch: the pure LBS warp, no correction or skinning field
    "coarse_batch": {"correction_field": False, "skinning_field": False},
    # CorrectionBatch: the instance-style correction field, forward on the
    # canonical points and backward on the source-pose points
    "correction_batch": {
        "correction_field": True,
        "skinning_field": False,
        "correction_style": "instance",
    },
    # DirectDeform: the MLP reads the fused 2D feature only (no PE of the
    # canonical points); its deform fields are unused in the reference
    "direct_deform": {
        "correction_field": False,
        "skinning_field": False,
        "pe_condition": False,
    },
    # CorrectionBatchBlend: the rgb head blends the sampled image rgb
    "correction_batch_blend": {"blend_rgb": True},
}


LEGACY_MODELS = ("correction_by_f3d", "correction_by_f3d_fagg",
                 "correction_by_uvh_agg", "correction_by_uvh_agg_fagg")


def return_model(args: Any):
    name = args.model
    if name in ("correction_by_f3d", "correction_by_f3d_fagg"):
        from mpsnerf_torch.models.correction_f3d import CorrectionF3D

        return CorrectionF3D(
            use_agg=name.endswith("_fagg"), use_f2d=bool(args.use_f2d),
            with_viewdirs=bool(args.with_viewdirs),
            human_sample=bool(args.human_sample),
            use_transformer=bool(args.use_trans))
    if name in ("correction_by_uvh_agg", "correction_by_uvh_agg_fagg"):
        from mpsnerf_torch.models.correction_f3d import CorrectionUvhAgg

        return CorrectionUvhAgg(use_agg=name.endswith("_fagg"),
                                use_f2d=bool(args.use_f2d))
    if name not in _MODEL_VARIANTS:
        raise NotImplementedError(
            f"model '{name}' is not available: "
            + ", ".join(sorted(_MODEL_VARIANTS) + list(LEGACY_MODELS)))
    fraction = getattr(args, "compact_fraction", None)
    kwargs = dict(
        num_instances=args.num_instance,
        use_transformer=bool(args.use_trans),
        append_rgb=bool(args.append_rgb),
        with_viewdirs=bool(args.with_viewdirs),
        human_sample=bool(args.human_sample),
        mean_shape=bool(args.mean_shape),
        correction_field=bool(args.correction_field),
        skinning_field=bool(args.skinning_field),
        pair_mode=args.data_set_type in PAIR_DATA_SETS,
        n_input_views=args.view_num,
        compute_dtype=getattr(args, "compute_dtype", "float32"),
        compact_fraction=fraction if fraction not in (None, 0) else None,
    )
    kwargs.update(_MODEL_VARIANTS[name])
    return MPSNeRF(**kwargs)


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
