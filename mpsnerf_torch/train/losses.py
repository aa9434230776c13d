"""Loss assembly for the training step (port of
``mpsnerf_tpu/train/losses.py``).

Masked terms are mask-weighted means over the full arrays (masked entries
are exact zeros in both operands), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mpsnerf_torch.models.mps_nerf import RawOutput
from mpsnerf_torch.ops.composite import shifted_softplus


def img2mse(x: torch.Tensor, y) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def masked_mse(x: torch.Tensor, y, mask: torch.Tensor) -> torch.Tensor:
    """Mean of (x-y)^2 over rows where mask==1 (rows have C channels)."""
    m = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - mask.dim()))
    denom = torch.clamp(torch.sum(m) * (x.numel() / mask.numel()), min=1.0)
    return torch.sum(((x - y) ** 2) * m) / denom


class LossTerms(NamedTuple):
    total: torch.Tensor
    img: torch.Tensor
    img_raw: torch.Tensor  # the image MSE whatever the pair-mode gating
    acc: torch.Tensor
    correction: torch.Tensor
    consistency: torch.Tensor
    density: torch.Tensor
    normal_smooth: torch.Tensor
    smpl_normal: torch.Tensor
    # in-body points lost to compaction-capacity overflow in this step's
    # forward(s); > 0 means the gradient came from a truncated point set
    n_dropped: torch.Tensor


def compute_losses(
    rgb_map: torch.Tensor,
    acc_map: torch.Tensor,
    target_rgb: torch.Tensor,
    bkgd_msk: torch.Tensor,
    raw: RawOutput,
    raw_perturbed: Optional[RawOutput],
    *,
    use_acc_loss: bool = True,
    use_correction_loss: bool = False,
    use_consistency_loss: bool = False,
    use_density_loss: bool = False,
    pose_match: Optional[torch.Tensor] = None,
) -> LossTerms:
    zero = rgb_map.new_zeros(())

    img_raw = img2mse(rgb_map, target_rgb)
    img = img_raw if pose_match is None else torch.where(pose_match, img_raw,
                                                         zero)
    acc = (img2mse(bkgd_msk.reshape(acc_map.shape), acc_map)
           if use_acc_loss else zero)

    mask = raw.pts_mask.to(rgb_map.dtype)
    correction = (masked_mse(raw.correction, 0.0, mask)
                  + masked_mse(raw.correction_, 0.0, mask)
                  if use_correction_loss else zero)
    consistency = (masked_mse(raw.smpl_query_pts, raw.smpl_src_pts, mask)
                   if use_consistency_loss else zero)
    if use_density_loss:
        # 0.005 * L1(exp(-softplus(sigma-1)), 1) over masked samples
        dens = torch.exp(-shifted_softplus(raw.sigma))
        density = 0.005 * torch.sum(torch.abs(dens - 1.0) * mask) \
            / torch.clamp(torch.sum(mask), min=1.0)
    else:
        density = zero

    n_dropped = raw.n_dropped.to(torch.float32)
    if raw_perturbed is not None:
        normal_smooth = img2mse(raw_perturbed.occ_normal, raw.occ_normal)
        smpl_normal = img2mse(raw.nearest_smpl_normal, -raw.occ_normal)
        other = 0.1 * normal_smooth + 0.1 * smpl_normal
        n_dropped = n_dropped + raw_perturbed.n_dropped.to(torch.float32)
    else:
        normal_smooth = smpl_normal = other = zero

    total = img + correction + acc + consistency + density + other
    return LossTerms(
        total=total, img=img, img_raw=img_raw, acc=acc,
        correction=correction, consistency=consistency, density=density,
        normal_smooth=normal_smooth, smpl_normal=smpl_normal,
        n_dropped=n_dropped,
    )
