from mpsnerf_torch.smpl.model import SMPLModel, load_smpl_pickle, synthetic_smpl
from mpsnerf_torch.smpl.kinematics import (
    BIG_POSE_AXES,
    big_pose_vector,
    pose_blend_offsets,
    rigid_transforms,
    rodrigues,
    shape_blend_offsets,
    transform_params,
)
from mpsnerf_torch.smpl.lbs import (
    PoseTransforms,
    deform_canonical_to_source,
    deform_target_to_canonical,
    inv3x3,
    posed_vertices,
    smpl_to_world,
    world_to_smpl,
)

__all__ = [
    "SMPLModel", "load_smpl_pickle", "synthetic_smpl",
    "BIG_POSE_AXES", "big_pose_vector", "pose_blend_offsets",
    "rigid_transforms", "rodrigues", "shape_blend_offsets",
    "transform_params",
    "PoseTransforms", "deform_canonical_to_source",
    "deform_target_to_canonical", "inv3x3", "posed_vertices",
    "smpl_to_world", "world_to_smpl",
]
