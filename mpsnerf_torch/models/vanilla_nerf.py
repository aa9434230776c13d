"""The classic NeRF MLP and the legacy log-sampled embedder (port of
``mpsnerf_tpu/models/vanilla_nerf.py``): the reference's ``NeRF`` and
``get_embedder``, unused by the trained configurations (a plain-NeRF
baseline).  Module names follow the JAX package's (``pts_linears.{i}``
for its ``pts_linear_{i}``, ``output_linear``, ``alpha_linear``,
``feature_linear``, ``views_linear``, ``rgb_linear``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mpsnerf_torch.models.layers import TorchLinear


def get_embedder(multires: int, i: int = 0):
    """The legacy positional embedding: frequencies 2^0 .. 2^(m-1), no pi
    (unlike ``ops.positional_encoding``), layout ``[x, sin(f0 x), cos(f0
    x), ...]``.  Returns ``(fn, out_dim)``; ``i == -1`` is the identity."""
    if i == -1:
        return (lambda x: x), 3
    freqs = 2.0 ** np.linspace(0.0, multires - 1, multires)

    def embed(x):
        outs = [x]
        for f in freqs:
            outs.append(torch.sin(x * float(f)))
            outs.append(torch.cos(x * float(f)))
        return torch.cat(outs, dim=-1)

    return embed, 3 * (2 * multires + 1)


class VanillaNeRF(nn.Module):
    """8 x 256 NeRF, a skip at layer 4, the official view branch with
    ``use_viewdirs`` (rgb then alpha), else one ``output_linear``."""

    def __init__(self, depth: int = 8, width: int = 256, input_ch: int = 3,
                 input_ch_views: int = 3, output_ch: int = 4,
                 skips: Tuple[int, ...] = (4,), use_viewdirs: bool = False):
        super().__init__()
        self.input_ch, self.input_ch_views = input_ch, input_ch_views
        self.skips = tuple(skips)
        self.use_viewdirs = bool(use_viewdirs)
        widths = [input_ch] + [width + (input_ch if i in self.skips else 0)
                               for i in range(depth)]
        self.pts_linears = nn.ModuleList(
            [TorchLinear(widths[i], width) for i in range(depth)])
        if self.use_viewdirs:
            self.alpha_linear = TorchLinear(widths[-1], 1)
            self.feature_linear = TorchLinear(widths[-1], width)
            self.views_linear = TorchLinear(width + input_ch_views,
                                            width // 2)
            self.rgb_linear = TorchLinear(width // 2, 3)
        else:
            self.output_linear = TorchLinear(widths[-1], output_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pts = x[..., :self.input_ch]
        views = x[..., self.input_ch:self.input_ch + self.input_ch_views]
        h = pts
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if i in self.skips:
                h = torch.cat([pts, h], dim=-1)
        if not self.use_viewdirs:
            return self.output_linear(h)
        alpha = self.alpha_linear(h)
        h = torch.cat([self.feature_linear(h), views], dim=-1)
        rgb = self.rgb_linear(F.relu(self.views_linear(h)))
        return torch.cat([rgb, alpha], dim=-1)
