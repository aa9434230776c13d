"""Shared layer primitives (port of ``mpsnerf_tpu/models/layers.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype_of(name: str) -> Optional[torch.dtype]:
    """The model's ``compute_dtype`` string -> the products' dtype (None:
    the input's, fp32)."""
    if name == "bfloat16":
        return torch.bfloat16
    if name != "float32":
        raise ValueError(f"compute_dtype {name!r}: float32 or bfloat16")
    return None


class TorchLinear(nn.Linear):
    """``nn.Linear`` with the JAX package's init: weight and bias both
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)); ``zero_init`` starts both at 0.

    ``dtype`` is the compute dtype, as flax's ``Dense(dtype=...)``: the
    parameters stay float32 and the input, weight and bias are cast to it
    for the product, whose result keeps it.  None computes in the input's
    dtype."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 zero_init: bool = False):
        self.zero_init = zero_init
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        with torch.no_grad():
            bound = 0.0 if self.zero_init else 1.0 / math.sqrt(
                self.in_features)
            self.weight.uniform_(-bound, bound)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), bias)
