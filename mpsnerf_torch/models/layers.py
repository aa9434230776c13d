"""Shared layer primitives (port of ``mpsnerf_tpu/models/layers.py``)."""

from __future__ import annotations

import math

import torch
from torch import nn


class TorchLinear(nn.Linear):
    """``nn.Linear`` with the JAX package's init: weight and bias both
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def reset_parameters(self) -> None:
        with torch.no_grad():
            bound = 1.0 / math.sqrt(self.in_features)
            self.weight.uniform_(-bound, bound)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound)
