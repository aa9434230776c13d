"""SMPL rigs by gender flag (port of ``mpsnerf_tpu/smpl/assets.py``): the
three pickled rigs (1 male, 0 female, 2 neutral) from ``assets/``; where a
pickle is absent (they are licensed files the user supplies), the
deterministic synthetic rig of that seed stands in, with a warning."""

from __future__ import annotations

import os
import warnings
from typing import Dict

from mpsnerf_torch.smpl.model import SMPLModel, load_smpl_pickle, synthetic_smpl

ASSET_FILES = {
    1: "basicmodel_m_lbs_10_207_0_v1.0.0.pkl",
    0: "basicmodel_f_lbs_10_207_0_v1.0.0.pkl",
    2: "SMPL_NEUTRAL.pkl",
}


def load_smpl_models(assets_dir: str = "assets", device="cuda"
                     ) -> Dict[int, SMPLModel]:
    """gender flag -> rig on ``device``."""
    out: Dict[int, SMPLModel] = {}
    for gender, fname in ASSET_FILES.items():
        path = os.path.join(assets_dir, fname)
        if os.path.exists(path):
            out[gender] = load_smpl_pickle(path, device=device)
        else:
            warnings.warn(
                f"SMPL asset {path} not found — using a synthetic rig "
                "(provide the official SMPL pickles for real data).")
            out[gender] = synthetic_smpl(seed=gender, device=device)
    return out
