"""Pixel-aligned 2D image encoder: the first two stages of ResNet-34 (port
of ``mpsnerf_tpu/models/resnet.py:SpatialEncoder`` at ``num_layers=2``).

A 2x2 area downsample of the input, conv1 + BN + ReLU, then ``layer1``
(three 64-channel BasicBlocks, no max-pool); both stage outputs share one
resolution, so the align-corners resize is the identity and they are
concatenated: 128 channels at 1/4 of the input resolution.  Module names
follow the reference checkpoint (``encoder_2d.model.*``, torchvision's
ResNet names).

BatchNorm follows flax's ``nn.BatchNorm`` (momentum 0.9, eps 1e-5), not
torch's: in train mode it normalises with the biased batch variance
``E[x^2] - E[x]^2`` (clipped at 0) and moves both running statistics by
0.1 towards the batch's mean and *biased* variance (torch moves
``running_var`` towards the unbiased one).  In eval mode it uses the
running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same state names) with flax's train-mode
    statistics; see the module docstring."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3)
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean
                                    + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var
                                   + self.momentum * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class BasicBlock(nn.Module):
    """A stride-1 ResNet BasicBlock with equal in/out channels."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(ch, eps=1e-5, momentum=0.1)
        self.conv2 = nn.Conv2d(ch, ch, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(ch, eps=1e-5, momentum=0.1)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class _Backbone(nn.Module):
    """The ResNet-34 trunk's used stages, under torchvision's names."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5, momentum=0.1)
        self.layer1 = nn.Sequential(*(BasicBlock(64) for _ in range(3)))


class SpatialEncoder(nn.Module):
    """images (V, 3, H, W) -> latent (V, 128, H/4, W/4)."""

    LATENT_CHANNELS = 128

    def __init__(self):
        super().__init__()
        self.model = _Backbone()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = F.avg_pool2d(images, 2)  # area downsample by 2
        m = self.model
        x = F.relu(m.bn1(m.conv1(x)))
        return torch.cat([x, m.layer1(x)], dim=1)
