"""Multi-view fusion transformer (port of
``mpsnerf_tpu/models/transformer.py``).

Depth-2, 4-head, dim_head-64 pre-norm transformer with residuals over the
V input views of each query point; tokens are (V, N, dim), view-major.
Module names follow the reference checkpoint
(``transformer.layers.{i}.{0,1}.fn.{norm,fn}.*``).  Exact erf GELU and
LayerNorm eps 1e-5.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mpsnerf_torch.models.layers import TorchLinear


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(self.norm(x), **kwargs)


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

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim_head ** -0.5
        self.to_qkv = TorchLinear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(TorchLinear(inner, dim), nn.Dropout(0.0))

    def forward(self, x, out_views: Optional[int] = None):
        v_views, n, _ = x.shape
        out_v = out_views or v_views
        h, dh = self.heads, self.dim_head
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
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.net = nn.Sequential(
            TorchLinear(dim, hidden_dim), nn.GELU(), nn.Dropout(0.0),
            TorchLinear(hidden_dim, dim), nn.Dropout(0.0),
        )

    def forward(self, x):
        return self.net(x)


class ViewFusionTransformer(nn.Module):
    """Pre-norm residual transformer over the view axis: (V, N, dim);
    depth 2, 4 heads of 64, feed-forward width 128."""

    def __init__(self, dim: int):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                Residual(PreNorm(dim, Attention(dim))),
                Residual(PreNorm(dim, FeedForward(dim, 128))),
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
