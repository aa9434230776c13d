"""Camera info for rendered sequences (port of
``mpsnerf_tpu/utils/cameras.py``, the reference's ``write_K_pose_inf``):
each view's K and world -> camera pose, as json."""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np


def write_camera_info(path: str, Ks: Sequence[np.ndarray],
                      RTs: Sequence[np.ndarray]) -> None:
    """Ks: (3, 3) intrinsics; RTs: (3, 4) or (4, 4) world -> camera."""
    info = {}
    for i, (K, RT) in enumerate(zip(Ks, RTs)):
        RT = np.asarray(RT)
        info[f"{i:06d}"] = {"K": np.asarray(K).tolist(),
                            "W2C": RT[:3, :4].tolist()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(info, f)
