"""NeRF frequency positional encoding (port of
``mpsnerf_tpu/ops/positional.py``): frequencies ``pi * 2^k``, layout
``[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]``."""

from __future__ import annotations

import numpy as np
import torch


def pe_dim(num_freqs: int, d_in: int = 3, include_input: bool = True) -> int:
    return num_freqs * 2 * d_in + (d_in if include_input else 0)


def positional_encoding(
    x: torch.Tensor,
    num_freqs: int,
    freq_factor: float = np.pi,
    include_input: bool = True,
) -> torch.Tensor:
    """Encode (..., D) -> (..., pe_dim)."""
    freqs = torch.as_tensor(
        freq_factor * (2.0 ** np.arange(num_freqs)), dtype=x.dtype,
        device=x.device,
    )
    xb = x[..., None, :] * freqs[:, None]                  # (..., F, D)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = enc.reshape(x.shape[:-1] + (num_freqs * 2 * x.shape[-1],))
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
