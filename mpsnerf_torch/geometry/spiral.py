"""Spiral camera paths for free-viewpoint video (port of
``mpsnerf_tpu/geometry/spiral.py``, numpy): ``viewmatrix``, ``ptstocam``,
``load_cam`` and ``gen_path`` of the reference's render utilities.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    vec2 = _normalize(z)
    vec1 = _normalize(np.cross(vec2, up))
    vec0 = _normalize(np.cross(vec1, vec2))
    return np.stack([vec0, vec1, vec2, pos], 1)


def ptstocam(pts: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    return (c2w[:3, :3].T @ (pts - c2w[:3, 3])[..., None])[..., 0]


def load_cam(ann_file: str):
    """K and RT (4x4 world -> camera, T in metres) lists from an annots
    file (``.json`` of the capture, or ``annots.npy``)."""
    if ann_file.endswith(".json"):
        with open(ann_file) as f:
            cams = json.load(f)["cams"]["20190823"]
    else:
        cams = np.load(ann_file, allow_pickle=True).item()["cams"]

    K, RT = [], []
    lower = np.array([[0.0, 0.0, 0.0, 1.0]])
    for i in range(len(cams["K"])):
        K.append(np.array(cams["K"][i]))
        r = np.array(cams["R"][i])
        t = np.array(cams["T"][i]) / 1000.0
        RT.append(np.concatenate([np.concatenate([r, t], 1), lower], 0))
    return K, RT


def gen_path(RT: List[np.ndarray], center: Optional[np.ndarray] = None,
             num_views: int = 40) -> List[np.ndarray]:
    """``num_views`` world -> camera matrices on a spiral around the
    subject, about the cameras' mean up axis."""
    lower = np.array([[0.0, 0.0, 0.0, 1.0]])
    RT = np.linalg.inv(np.array(RT))
    RT = np.concatenate(
        [RT[:, :, 1:2], RT[:, :, 0:1], -RT[:, :, 2:3], RT[:, :, 3:4]], 2)

    up = _normalize(RT[:, :3, 0].sum(0))
    z = _normalize(RT[0, :3, 2])
    vec1 = _normalize(np.cross(z, up))
    vec2 = _normalize(np.cross(up, vec1))
    z_off = 0.0
    if center is None:
        center = RT[:, :3, 3].mean(0)
        z_off = 1.3

    c2w = np.stack([up, vec1, vec2, center], 1)
    tt = ptstocam(RT[:, :3, 3], c2w).T
    rads = np.percentile(np.abs(tt), 80, -1) * 1.3
    rads = np.array(list(rads) + [1.0])

    render_w2c = []
    for theta in np.linspace(0.0, 2 * np.pi, num_views + 1)[:-1]:
        cam_pos = np.array([0, np.sin(theta), np.cos(theta), 1]) * rads
        cam_pos_world = c2w[:3, :4] @ cam_pos
        z = _normalize(cam_pos_world
                       - c2w[:3, :4] @ np.array([z_off, 0, 0, 1.0]))
        mat = viewmatrix(z, up, cam_pos_world)
        mat = np.concatenate(
            [mat[:, 1:2], mat[:, 0:1], -mat[:, 2:3], mat[:, 3:4]], 1)
        render_w2c.append(np.linalg.inv(np.concatenate([mat, lower], 0)))
    return render_w2c
