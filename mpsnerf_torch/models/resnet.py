"""Pixel-aligned 2D image encoder: the first stages of ResNet-34 (port
of ``mpsnerf_tpu/models/resnet.py:SpatialEncoder``).

A 2x2 area downsample of the input, conv1 + BN + ReLU, then the first
``num_layers - 1`` residual stages (no max-pool; stage 1 at stride 1, the
later ones at stride 2); every stage output is resized (bilinear,
align_corners) to the first one's resolution and all are concatenated:
64 * ``num_layers`` channels at 1/4 of the input resolution (128 at the
trained ``num_layers = 2``, where the resize is the identity).  Module
names follow the reference checkpoint (``encoder_2d.model.*``,
torchvision's ResNet names).

BatchNorm follows flax's ``nn.BatchNorm`` (momentum 0.9, eps 1e-5), not
torch's: in train mode it normalises with the biased batch variance
``E[x^2] - E[x]^2`` (clipped at 0) and moves both running statistics by
0.1 towards the batch's mean and *biased* variance (torch moves
``running_var`` towards the unbiased one).  In eval mode it uses the
running statistics.  With ``axis_name`` (flax's ``axis_name``, JAX's
``bn_axis_name``) the train-mode batch mean and mean of squares are
averaged over that axis of the bound mesh before the variance is formed
(``parallel/collectives.py:pmean``, differentiable): cross-replica
BatchNorm with flax's biased running variance, where ``nn.SyncBatchNorm``
would move it towards the unbiased one.  Outside a bound mesh the name
raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpsnerf_torch.parallel.collectives import pmean


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same state names) with flax's train-mode
    statistics, averaged over the mesh axis ``axis_name`` when it is set;
    see the module docstring."""

    def __init__(self, *args, axis_name=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.axis_name = axis_name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3)
        mean, mean2 = x.mean(dims), (x * x).mean(dims)
        if self.axis_name is not None:
            mean, mean2 = pmean(torch.stack([mean, mean2]),
                                self.axis_name).unbind(0)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
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


_STAGE_BLOCKS = (3, 4, 6, 3)  # ResNet-34
_STAGE_CHANNELS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    """A ResNet BasicBlock; a strided or widening one has torchvision's
    ``downsample`` (1x1 conv + BN) on its residual."""

    def __init__(self, cin: int, ch: int, stride: int = 1, axis_name=None):
        super().__init__()
        bn = dict(eps=1e-5, momentum=0.1, axis_name=axis_name)
        self.conv1 = nn.Conv2d(cin, ch, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(ch, **bn)
        self.conv2 = nn.Conv2d(ch, ch, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(ch, **bn)
        self.downsample = None
        if stride != 1 or cin != ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, ch, 1, stride, bias=False),
                BatchNorm2d(ch, **bn))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(self.bn2(self.conv2(y)) + res)


class _Backbone(nn.Module):
    """The ResNet-34 trunk's used stages, under torchvision's names."""

    def __init__(self, num_layers: int, axis_name=None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5, momentum=0.1,
                               axis_name=axis_name)
        cin = 64
        for stage in range(1, num_layers):
            ch = _STAGE_CHANNELS[stage - 1]
            blocks = [BasicBlock(cin if b == 0 else ch, ch,
                                 1 if stage == 1 or b else 2, axis_name)
                      for b in range(_STAGE_BLOCKS[stage - 1])]
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
            cin = ch


class SpatialEncoder(nn.Module):
    """images (V, 3, H, W) -> latent (V, 64 * num_layers, H/4, W/4) in
    ``torch.channels_last`` memory: a pixel's channels are contiguous, as
    the patch grid-sample kernels read them (one layout copy per encode,
    none per sample)."""

    def __init__(self, num_layers: int = 2, bn_axis_name=None):
        super().__init__()
        if not 1 <= num_layers <= 5:
            raise ValueError(f"num_layers {num_layers}: 1 to 5")
        self.num_layers = num_layers
        self.latent_channels = [0, 64, 128, 256, 512, 1024][num_layers]
        self.model = _Backbone(num_layers, bn_axis_name)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = F.avg_pool2d(images, 2)  # area downsample by 2
        m = self.model
        x = F.relu(m.bn1(m.conv1(x)))
        latents = [x]
        for stage in range(1, self.num_layers):
            x = getattr(m, f"layer{stage}")(x)
            latents.append(x)
        size = latents[0].shape[-2:]
        latents = [lat if lat.shape[-2:] == size else F.interpolate(
            lat, size=size, mode="bilinear", align_corners=True)
            for lat in latents]
        return torch.cat(latents, dim=1).contiguous(
            memory_format=torch.channels_last)
