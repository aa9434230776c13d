"""Volume rendering: alpha compositing of per-sample (rgb, sigma)
(port of ``mpsnerf_tpu/ops/composite.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x - 1): the density activation."""
    return F.softplus(x - 1.0)


def wide_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """(1 + 2e-4) * sigmoid(x) - 1e-4: the rgb activation."""
    return (1.0 + 2.0 * 1e-4) * torch.sigmoid(x) - 1e-4


class RenderOutputs(NamedTuple):
    rgb_map: torch.Tensor        # (R, 3)
    disp_map: torch.Tensor       # (R,)
    acc_map: torch.Tensor        # (R,)
    weights: torch.Tensor        # (R, S)
    depth_map: torch.Tensor      # (R,)
    transmittance: torch.Tensor  # (R, S)


def composite_rays(
    raw_rgb: torch.Tensor,    # (R, S, 3) pre-activation rgb
    raw_sigma: torch.Tensor,  # (R, S) pre-activation density
    z_vals: torch.Tensor,     # (R, S)
    rays_d: torch.Tensor,     # (R, 3)
    occupancy: bool = False,
    white_bkgd: bool = False,
) -> RenderOutputs:
    """Alpha-composite samples along each ray."""
    rgb = wide_sigmoid(raw_rgb)
    if not occupancy:
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
        dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        alpha = 1.0 - torch.exp(-shifted_softplus(raw_sigma) * dists)
    else:
        alpha = wide_sigmoid(raw_sigma)

    # T_i = prod_{j<i} (1 - alpha_j + 1e-10): an exclusive cumprod.  The
    # exp(cumsum(log)) form has a NaN gradient when alpha saturates to 1.
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(
        torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1), dim=-1
    )[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(
        depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10
    )
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map, trans)


def linspace01(n_samples: int, dtype=torch.float32, device="cpu"):
    """``jnp.linspace(0, 1, n)`` bit for bit: ``i * (1 / (n - 1))`` in the
    working type (XLA turns the division by the constant into a product
    with its reciprocal), with the end point exactly 1.  ``torch.linspace``
    and a true division round some entries differently."""
    if n_samples == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    div = n_samples - 1
    recip = torch.tensor(1.0 / div, dtype=dtype, device=device)
    t = torch.arange(div, dtype=dtype, device=device) * recip
    return torch.cat([t, torch.ones(1, dtype=dtype, device=device)])


def stratified_z_vals(
    near: torch.Tensor,   # (R, 1)
    far: torch.Tensor,    # (R, 1)
    n_samples: int,
    perturb: float = 0.0,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stratified depth samples per ray, (R, S).  With ``perturb > 0`` each
    bin is jittered by the uniform noise ``u`` (R, S), which the caller
    draws (from a ``torch.Generator`` or injected for parity tests)."""
    t = linspace01(n_samples, near.dtype, near.device)
    z = near * (1.0 - t) + far * t
    if perturb > 0.0:
        if u is None:
            raise ValueError("perturb > 0 needs the uniform noise u")
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        z = lower + (upper - lower) * u
    return z


def sample_pdf(
    bins: torch.Tensor,      # (R, B)
    weights: torch.Tensor,   # (R, B - 1)
    n_samples: int,
    det: bool = False,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Hierarchical inverse-CDF sampling, (R, n_samples).  ``det`` places
    the draws at ``linspace01`` (``jnp.linspace`` bit for bit); otherwise
    they are ``u`` (R, n_samples) when given, else uniform draws from
    ``generator``.  ``torch.searchsorted(right=True)`` is JAX's
    ``side="right"``."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = linspace01(n_samples, cdf.dtype, cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=generator, dtype=cdf.dtype,
                       device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_lo = torch.gather(cdf, -1, below)
    cdf_hi = torch.gather(cdf, -1, above)
    bin_lo = torch.gather(bins, -1, below)
    bin_hi = torch.gather(bins, -1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)
