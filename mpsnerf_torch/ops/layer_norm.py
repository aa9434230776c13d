"""LayerNorm over the last dimension, fp32 statistics, affine: the
view-fusion transformer's normalisation of its 155-wide rows.

* :func:`layer_norm_cuda`: the hand-written CUDA kernel
  (``mpsnerf_torch/csrc/layer_norm.cu``: one warp a row, the row in
  registers, the mean and then the centred variance over them), for fp32
  CUDA rows up to ``MAX_WIDTH`` wide.  ``models/transformer.py:PreNorm``
  calls it where autograd records nothing; it has no backward.
* :func:`layer_norm_plain`: the same function in plain PyTorch (the
  mean, then the centred variance), the kernel's reference in the tests.
"""

from __future__ import annotations

import ctypes

import torch

from mpsnerf_torch import cuda_build

# the widest row the kernel holds in registers (5 floats a lane)
MAX_WIDTH = 160


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight + bias


_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 2 + (ctypes.c_double,)


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel on the card: ``x`` (..., D) fp32 with 0 < D <=
    ``MAX_WIDTH``, ``weight`` and ``bias`` (D,) fp32 on its device; a new
    tensor of ``x``'s shape."""
    d = x.shape[-1] if x.dim() else 0
    if not 0 < d <= MAX_WIDTH:
        raise ValueError(f"layer_norm_cuda: rows {d} wide, not 1 to "
                         f"{MAX_WIDTH}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"layer_norm_cuda: {name} is on {t.device}, "
                             f"x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"layer_norm_cuda: {name} is {t.dtype}, "
                            "not float32")
    if tuple(weight.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(f"layer_norm_cuda: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")
    x = x.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows:
        cuda_build.launch("layer_norm", "mpsnerf_layer_norm", _ARGS, x.device,
                          x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                          out.data_ptr(), rows, d, float(eps))
    return out

