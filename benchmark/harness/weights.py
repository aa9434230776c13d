"""Seeded weights, made on the device in one draw and handed to the port
and to the reference alike.

The draw is one ``torch.rand`` on a ``torch.Generator`` of the device,
cut into the leaves of a ``state_dict`` template in its order: a weight of
two or more dimensions is U(-b, b) with b = 1/sqrt(fan in) (the default
of PyTorch's linear and convolution layers, and the port's), a bias the
same with its weight's fan in, a one-dimensional weight (a norm's scale)
1 and a norm's bias 0.  The density head's bias is +4, so that a random
model's body is opaque.  Buffers keep the template's values.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

DENSITY_BIAS = ("alpha_linear.bias", 4.0)


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:]))


def seeded_state(template: Dict[str, torch.Tensor], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """``template`` name -> tensor (shapes and dtypes); returns a new dict
    of tensors on ``device``."""
    floats = [k for k, v in template.items() if v.is_floating_point()
              and not k.endswith(("running_mean", "running_var"))]
    total = sum(template[k].numel() for k in floats)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for k, v in template.items():
        if k not in floats:
            out[k] = v.detach().to(device).clone()
            continue
        piece = u[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
        if v.dim() >= 2:
            out[k] = piece / math.sqrt(_fan_in(v.shape))
        elif k.endswith(".bias") and template.get(
                k[:-5] + ".weight", v).dim() >= 2:
            out[k] = piece / math.sqrt(_fan_in(template[k[:-5] + ".weight"]
                                               .shape))
        else:
            out[k] = torch.full_like(piece, 1.0 if k.endswith(".weight")
                                     else 0.0)
    name, value = DENSITY_BIAS
    out[name] = torch.full_like(out[name], value)
    return out
