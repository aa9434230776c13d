"""Deformation fields: the correction MLP and the skinning-weight field
(port of ``mpsnerf_tpu/models/deform.py``).

A ``depth``-layer, 256-wide ReLU MLP with the input concatenated back
after each layer in ``skips``; the ``"correction"`` type starts its output
layer at zero (training starts from the pure LBS warp), the
``"weights"`` type applies a 24-way softmax.  Module names follow the
reference checkpoint (``pts_time_linears.{j}``, ``output_linear``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpsnerf_torch.models.layers import TorchLinear


class DeformField(nn.Module):
    def __init__(self, in_ch: int, depth: int = 8, width: int = 256,
                 out_ch: int = 3, skips: tuple = (4,),
                 deform_type: str = "weights"):
        super().__init__()
        if deform_type not in ("weights", "correction"):
            raise ValueError(f"deform_type {deform_type!r}")
        self.skips = tuple(skips)
        self.deform_type = deform_type
        widths = [in_ch] + [width + (in_ch if i in self.skips else 0)
                            for i in range(depth)]
        self.pts_time_linears = nn.ModuleList(
            [TorchLinear(widths[i], width) for i in range(depth)])
        self.output_linear = TorchLinear(
            widths[depth], out_ch, zero_init=deform_type == "correction")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.pts_time_linears):
            h = F.relu(layer(h))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        out = self.output_linear(h)
        if self.deform_type == "weights":
            out = torch.softmax(out, dim=-1)
        return out
