"""Multi-view fusion transformer (port of
``mpsnerf_tpu/models/transformer.py``).

Depth-2, 4-head, dim_head-64 pre-norm transformer with residuals over the
V input views of each query point; tokens are (V, N, dim), view-major.
Module names follow the reference checkpoint
(``transformer.layers.{i}.{0,1}.fn.{norm,fn}.*``).  Exact erf GELU and
LayerNorm eps 1e-5: on fp32 CUDA rows that autograd does not record (the
served and eval renders) and that the kernel holds (up to 160 wide), the
hand-written kernel of ``ops/layer_norm.py``; else ``nn.LayerNorm``
(every train step, the CPU).

``dtype`` (bfloat16 or None) is the compute dtype, as in the JAX package:
the parameters, the LayerNorm statistics and the residual stream stay
float32; the LayerNorm output, the projections' products and the
attention core (logits, softmax, value mix) are in ``dtype``.  The JAX
package writes the softmax out (max, exp, sum, divide in ``dtype``);
``torch.softmax`` of a bfloat16 tensor accumulates in float32 and rounds
its output to bfloat16.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mpsnerf_torch.models.layers import TorchLinear
from mpsnerf_torch.ops.layer_norm import MAX_WIDTH, layer_norm_cuda


def autograd_records(x: torch.Tensor, norm: nn.LayerNorm) -> bool:
    """Whether autograd records a LayerNorm of ``x`` by ``norm``."""
    return torch.is_grad_enabled() and (
        x.requires_grad or norm.weight.requires_grad
        or norm.bias.requires_grad)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn
        self.compute_dtype = dtype

    def forward(self, x, **kwargs):
        # statistics in the input's float32; the hand-written kernel where
        # autograd records nothing (it has no backward) and it holds the row
        n = self.norm
        if x.is_cuda and x.dtype == torch.float32 and \
                x.shape[-1] <= MAX_WIDTH and not autograd_records(x, n):
            y = layer_norm_cuda(x, n.weight, n.bias, n.eps)
        else:
            y = n(x)
        if self.compute_dtype is not None:
            y = y.to(self.compute_dtype)
        return self.fn(y, **kwargs)


class Residual(nn.Module):
    """``x + fn(x)``; with ``out_views`` only the first rows of x are kept
    (fn computes only those rows)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, out_views: Optional[int] = None):
        if out_views:
            return x[:out_views] + self.fn(x, out_views=out_views)
        return x + self.fn(x)


class Attention(nn.Module):
    """Attention over the (tiny) view axis; input (V, N, D)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim_head ** -0.5
        self.to_qkv = TorchLinear(dim, inner * 3, bias=False, dtype=dtype)
        self.to_out = nn.Sequential(TorchLinear(inner, dim, dtype=dtype),
                                    nn.Dropout(0.0))

    def forward(self, x, out_views: Optional[int] = None):
        v_views, n, _ = x.shape
        out_v = out_views or v_views
        h, dh = self.heads, self.dim_head
        # logits, softmax and the value mix in the compute dtype
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        # queries only for the rows that are read; keys and values still
        # mix every view
        q = q[:out_v].reshape(out_v, n, h, dh)
        k = k.reshape(v_views, n, h, dh)
        v = v.reshape(v_views, n, h, dh)
        logits = torch.einsum("inhd,jnhd->nhij", q, k) * self.scale
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("nhij,jnhd->inhd", attn, v)
        return self.to_out(out.reshape(out_v, n, h * dh))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.net = nn.Sequential(
            TorchLinear(dim, hidden_dim, dtype=dtype), nn.GELU(),
            nn.Dropout(0.0), TorchLinear(hidden_dim, dim, dtype=dtype),
            nn.Dropout(0.0),
        )

    def forward(self, x):
        return self.net(x)


class ViewFusionTransformer(nn.Module):
    """Pre-norm residual transformer over the view axis: (V, N, dim);
    depth 2, 4 heads of 64, feed-forward width 128.  The output is
    float32 whatever ``dtype``."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                Residual(PreNorm(dim, Attention(dim, dtype=dtype), dtype)),
                Residual(PreNorm(dim, FeedForward(dim, 128, dtype=dtype),
                                 dtype)),
            ])
            for _ in range(2)
        ])

    def forward(self, x, out_views: Optional[int] = None):
        """With ``out_views`` the last layer computes only the first
        ``out_views`` rows (the model reads fused[0] and fused[1]); earlier
        layers stay full since their outputs feed every view's keys."""
        depth = len(self.layers)
        for i, (attn, ff) in enumerate(self.layers):
            ov = out_views if i == depth - 1 else None
            x = attn(x, out_views=ov)
            x = ff(x)
        return x
