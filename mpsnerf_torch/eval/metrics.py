"""Evaluation metrics: masked PSNR and SSIM (port of
``mpsnerf_tpu/eval/metrics.py``, numpy and scipy only).

The reference's SSIM is scikit-image's ``compare_ssim(img_pred, img_gt,
multichannel=True)`` on bbox-cropped masked float images, which for float
inputs without an explicit ``data_range`` takes ``data_range = 2.0``
(floats assumed in [-1, 1]); that quirk is the default, so the numbers
compare with the reference's.  ``cv2.boundingRect`` is redone in numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.ndimage import uniform_filter


def psnr_metric(img_pred: np.ndarray, img_gt: np.ndarray) -> float:
    mse = np.mean((img_pred - img_gt) ** 2)
    return float(-10.0 * np.log(mse) / np.log(10.0))


def structural_similarity(
    im1: np.ndarray,
    im2: np.ndarray,
    data_range: float = 2.0,
    win_size: int = 7,
    K1: float = 0.01,
    K2: float = 0.03,
    channel_axis: Optional[int] = None,
) -> float:
    """Mean SSIM with a uniform window in float64 (skimage's for float
    images: sample covariance, the border of half a window cropped)."""
    if channel_axis is not None:
        ims1 = np.moveaxis(im1, channel_axis, -1)
        ims2 = np.moveaxis(im2, channel_axis, -1)
        return float(np.mean([
            structural_similarity(ims1[..., c], ims2[..., c], data_range,
                                  win_size, K1, K2)
            for c in range(ims1.shape[-1])
        ]))

    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    n_px = win_size ** 2
    cov_norm = n_px / (n_px - 1)

    def filt(x):
        return uniform_filter(x, size=win_size)

    ux, uy = filt(im1), filt(im2)
    uxx, uyy, uxy = filt(im1 * im1), filt(im2 * im2), filt(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def bounding_rect(mask: np.ndarray):
    """``cv2.boundingRect`` of a 2-D mask: ``(x, y, w, h)`` of its nonzero
    pixels, ``(0, 0, 0, 0)`` when there are none."""
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0:
        return 0, 0, 0, 0
    return (int(cols[0]), int(rows[0]), int(cols[-1] - cols[0] + 1),
            int(rows[-1] - rows[0] + 1))


def ssim_metric(
    rgb_pred: np.ndarray,
    rgb_gt: np.ndarray,
    mask_at_box: np.ndarray,
    H: int,
    W: int,
) -> float:
    """SSIM on the bbox-cropped masked image.  ``rgb_pred``/``rgb_gt``:
    (M, 3) pixels at the True positions of ``mask_at_box`` (H, W)."""
    img_pred = np.zeros((H, W, 3))
    img_pred[mask_at_box] = rgb_pred
    img_gt = np.zeros((H, W, 3))
    img_gt[mask_at_box] = rgb_gt

    x, y, w, h = bounding_rect(mask_at_box)
    img_pred = img_pred[y:y + h, x:x + w]
    img_gt = img_gt[y:y + h, x:x + w]
    return structural_similarity(img_pred, img_gt, channel_axis=-1)
