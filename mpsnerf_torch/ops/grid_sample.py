"""Bilinear sampling of image / feature maps at continuous coordinates
(port of ``mpsnerf_tpu/ops/grid_sample.py``: ``grid_sample_2d``,
``grid_sample_2d_patch`` with its hand-written backward, and
``index_features_patch``).

align_corners=True with border replication.  Two forms of one function:

* the 4-corner form (:func:`grid_sample_2d`): bilinear weights from the
  *unclamped* positions, corner indices clamped to the border;
* the patch form (:func:`grid_sample_2d_patch_plain`): the 2x2 patch start
  clipped to ``w - 2`` / ``h - 2`` and the weight recomputed against it and
  clamped to [0, 1].  Its values equal the 4-corner form's.

:class:`GridSamplePatch` (``grid_sample_2d_patch``) is K2: its forward is
the patch form and its backward is the VJP of the 4-corner form, as in the
JAX package's ``custom_vjp`` (``grid_sample.py:132-143``).  The two
derivatives differ on the last column and row: at ``x = W-1`` exactly the
4-corner form's x-gradient is 0, where autograd through the patch form's
clamped weight gives the backward difference.  Beyond the border both give
0 across it and the same gradient along it.  The backward is itself an
``autograd.Function`` whose backward is the double backward that the
smooth loss's outer gradient runs through.

Each of the three has a CUDA kernel (``mpsnerf_torch/csrc/
grid_sample_patch.cu``) for CUDA tensors and a plain PyTorch version,
written on the 4-corner helpers below, for CPU tensors.  There is no
fallback: a CUDA tensor reaches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

# launches of the CUDA kernels since the last reset (chip_smoke.py reads it)
LAUNCHES = {"grid_sample_patch_fwd": 0, "grid_sample_patch_bwd": 0,
            "grid_sample_patch_bwd2": 0}

# d^2 w_k / d ix d iy of the corners nw, ne, sw, se (the weights are
# bilinear, so d^2 w_k / d ix^2 = d^2 w_k / d iy^2 = 0)
_CROSS = (1.0, -1.0, -1.0, 1.0)


def _positions(coords: torch.Tensor, h: int, w: int):
    ix = (coords[..., 0] + 1.0) * 0.5 * (w - 1)  # (V, N)
    iy = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    return ix, iy


class _Corners:
    """The 4-corner form at ``coords``: flat indices ``lin`` (clamped) of
    the corners nw, ne, sw, se, their weights ``w`` from the unclamped
    positions, the weights' derivatives ``dwx``/``dwy`` by the pixel
    position, and ``sx``/``sy`` = d position / d coordinate."""

    def __init__(self, coords: torch.Tensor, h: int, w: int):
        ix, iy = _positions(coords, h, w)
        ix0, iy0 = torch.floor(ix), torch.floor(iy)
        ix1, iy1 = ix0 + 1.0, iy0 + 1.0
        ax, bx = ix1 - ix, ix - ix0  # weights of columns x0, x1
        ay, by = iy1 - iy, iy - iy0  # weights of rows y0, y1

        def clampi(a, hi):
            return torch.clamp(a, 0, hi).long()

        x0, x1 = clampi(ix0, w - 1), clampi(ix1, w - 1)
        y0, y1 = clampi(iy0, h - 1), clampi(iy1, h - 1)
        self.lin: List[torch.Tensor] = [y0 * w + x0, y0 * w + x1,
                                        y1 * w + x0, y1 * w + x1]
        self.w = [ax * ay, bx * ay, ax * by, bx * by]
        self.dwx = [-ay, ay, -by, by]
        self.dwy = [-ax, -bx, ax, bx]
        self.sx, self.sy = 0.5 * (w - 1), 0.5 * (h - 1)


def _gather(flat: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """flat (V, C, HW), lin (V, N) -> (V, C, N)."""
    return torch.gather(flat, 2, lin[:, None, :].expand(-1, flat.shape[1], -1))


def _weighted(vals: List[torch.Tensor], wts: List[torch.Tensor]):
    """sum_k vals[k] (V, C, N) * wts[k] (V, N)."""
    out = vals[0] * wts[0][:, None, :]
    for val, wt in zip(vals[1:], wts[1:]):
        out = out + val * wt[:, None, :]
    return out


def grid_sample_2d(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The 4-corner form: sample ``image`` (V, C, H, W) at normalized
    coords (V, N, 2) in [-1, 1] (x along the width first).  Returns
    (V, C, N).  Autograd through it gives the reference's gradients."""
    v, c, h, w = image.shape
    k = _Corners(coords, h, w)
    flat = image.reshape(v, c, h * w)
    return _weighted([_gather(flat, lin) for lin in k.lin], k.w)


def grid_sample_2d_patch_plain(image: torch.Tensor, coords: torch.Tensor):
    """The patch form, K2's forward in plain PyTorch: (V, C, N)."""
    v, c, h, w = image.shape
    ix, iy = _positions(coords, h, w)
    x0 = torch.floor(ix).clamp(0, w - 2)
    y0 = torch.floor(iy).clamp(0, h - 2)
    wx = torch.clamp(ix - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(iy - y0, 0.0, 1.0)[..., None]

    flat = image.permute(0, 2, 3, 1).reshape(v, h * w, c)
    lin = y0.long() * w + x0.long()  # (V, N)

    def corner(offset):
        idx = (lin + offset)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx)  # (V, N, C)

    out = (
        corner(0) * ((1 - wx) * (1 - wy))
        + corner(1) * (wx * (1 - wy))
        + corner(w) * ((1 - wx) * wy)
        + corner(w + 1) * (wx * wy)
    )
    return out.permute(0, 2, 1)  # (V, C, N)


def _scatter(shape, lin: List[torch.Tensor], vals: List[torch.Tensor]):
    """sum of ``vals[k]`` (V, C, N) into pixels ``lin[k]``: (V, C, H, W)."""
    v, c, h, w = shape
    out = vals[0].new_zeros(v, c, h * w)
    for idx, val in zip(lin, vals):
        out.scatter_add_(2, idx[:, None, :].expand(-1, c, -1), val)
    return out.reshape(v, c, h, w)


def grid_sample_patch_backward_plain(g, image, coords, need_image: bool):
    """K2's backward in plain PyTorch: the VJP of the 4-corner form,
    ``(d image (V, C, H, W) or None, d coords (V, N, 2))``."""
    v, c, h, w = image.shape
    k = _Corners(coords, h, w)
    flat = image.reshape(v, c, h * w)
    vals = [_gather(flat, lin) for lin in k.lin]
    gx = (g * _weighted(vals, k.dwx)).sum(1) * k.sx
    gy = (g * _weighted(vals, k.dwy)).sum(1) * k.sy
    d_image = None
    if need_image:
        d_image = _scatter(image.shape, k.lin,
                           [g * wt[:, None, :] for wt in k.w])
    return d_image, torch.stack([gx, gy], dim=-1)


def grid_sample_patch_double_backward_plain(
    g, image, coords, gg_image: Optional[torch.Tensor],
    gg_coords: Optional[torch.Tensor], need: Tuple[bool, bool, bool],
):
    """K2's double backward in plain PyTorch: the VJP of
    :func:`grid_sample_patch_backward_plain` for the upstream
    ``(gg_image, gg_coords)`` (either may be None); returns
    ``(d g, d image, d coords)``, None where ``need`` says so.  The
    formulas are in ``csrc/grid_sample_patch.cu``'s header."""
    v, c, h, w = image.shape
    k = _Corners(coords, h, w)
    flat = image.reshape(v, c, h * w)
    vals = [_gather(flat, lin) for lin in k.lin]
    d_g = torch.zeros_like(g)
    ex = ey = torch.zeros_like(coords[..., 0])
    d_image = None
    if gg_image is not None:
        gflat = gg_image.reshape(v, c, h * w)
        gvals = [_gather(gflat, lin) for lin in k.lin]
        d_g = d_g + _weighted(gvals, k.w)
        ex = ex + (g * _weighted(gvals, k.dwx)).sum(1) * k.sx
        ey = ey + (g * _weighted(gvals, k.dwy)).sum(1) * k.sy
    if gg_coords is not None:
        tx = gg_coords[..., 0] * k.sx  # (V, N)
        ty = gg_coords[..., 1] * k.sy
        d_g = d_g + (tx[:, None, :] * _weighted(vals, k.dwx)
                     + ty[:, None, :] * _weighted(vals, k.dwy))
        if need[1]:
            d_image = _scatter(image.shape, k.lin, [
                g * (tx * dx + ty * dy)[:, None, :]
                for dx, dy in zip(k.dwx, k.dwy)])
        mixed = (g * _weighted(vals, [torch.full_like(tx, s)
                                      for s in _CROSS])).sum(1)
        ex = ex + k.sx * ty * mixed
        ey = ey + k.sy * tx * mixed
    return (d_g if need[0] else None, d_image,
            torch.stack([ex, ey], dim=-1) if need[2] else None)


# ---- the CUDA kernels ----------------------------------------------------

def _check_cuda(name: str, **tensors):
    dev = None
    for arg, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}, not float32")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
    return dev


def _shapes(name: str, image: torch.Tensor, coords: torch.Tensor):
    if image.dim() != 4 or coords.dim() != 3 or coords.shape[2] != 2 \
            or coords.shape[0] != image.shape[0]:
        raise ValueError(f"{name}: image {tuple(image.shape)} and coords "
                         f"{tuple(coords.shape)} are not (V, C, H, W) and "
                         "(V, N, 2)")
    v, c, h, w = image.shape
    if h < 2 or w < 2:
        raise ValueError(f"{name}: the 2x2 patch needs H, W >= 2, got {h}x{w}")
    return v, c, h, w, coords.shape[1]


def _expect(name: str, **shapes):
    """Raise unless each given tensor (None is skipped) has its shape."""
    for arg, (t, shape) in shapes.items():
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"not {tuple(shape)}")


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """(V, C, H, W) -> a contiguous (V, H, W, C) copy."""
    return x.permute(0, 2, 3, 1).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


# argument types of the three C entry points (after them: the stream)
_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = {
    "mpsnerf_grid_sample_patch_fwd": [_PTR] * 3 + [_I64] * 5,
    "mpsnerf_grid_sample_patch_bwd": [_PTR] * 5 + [_I64] * 5,
    "mpsnerf_grid_sample_patch_bwd2": [_PTR] * 8 + [_I64] * 5,
}
_FNS = {}


def _launch(symbol: str, counter: str, dev, *args):
    """Call the C entry point ``symbol`` on the current stream of ``dev``
    (pointers as ints, then sizes) and count one launch of ``counter``."""
    fn = _FNS.get(symbol)
    if fn is None:
        from mpsnerf_torch.cuda_build import load_kernel_library

        fn = getattr(load_kernel_library("grid_sample_patch"), symbol)
        fn.argtypes = _ARGTYPES[symbol] + [_PTR]
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


def grid_sample_patch_fwd_cuda(image: torch.Tensor, coords: torch.Tensor):
    """K2 forward on the card: (V, C, N)."""
    name = "grid_sample_patch_fwd_cuda"
    dev = _check_cuda(name, image=image, coords=coords)
    v, c, h, w, n = _shapes(name, image, coords)
    out = torch.empty(v, c, n, device=dev)
    if out.numel() == 0:
        return out
    img = _channels_last(image)
    crd = coords.contiguous()
    _launch("mpsnerf_grid_sample_patch_fwd", "grid_sample_patch_fwd", dev,
            img.data_ptr(), crd.data_ptr(), out.data_ptr(),
            v, c, h, w, n)
    return out


def grid_sample_patch_bwd_cuda(g, image, coords, need_image: bool):
    """K2 backward on the card: ``(d image or None, d coords)``.  The image
    gradient is summed with atomics into a channels-last buffer and
    returned as a (V, C, H, W) view of it."""
    name = "grid_sample_patch_bwd_cuda"
    dev = _check_cuda(name, g=g, image=image, coords=coords)
    v, c, h, w, n = _shapes(name, image, coords)
    _expect(name, g=(g, (v, c, n)))
    d_coords = torch.empty(v, n, 2, device=dev)
    d_hwc = torch.zeros(v, h, w, c, device=dev) if need_image else None
    if n > 0:
        img = _channels_last(image)
        gc, crd = g.contiguous(), coords.contiguous()
        _launch("mpsnerf_grid_sample_patch_bwd", "grid_sample_patch_bwd", dev,
                gc.data_ptr(), img.data_ptr(), crd.data_ptr(),
                _ptr(d_hwc), d_coords.data_ptr(), v, c, h, w, n)
    return (None if d_hwc is None else d_hwc.permute(0, 3, 1, 2)), d_coords


def grid_sample_patch_bwd2_cuda(g, image, coords, gg_image, gg_coords,
                                need: Tuple[bool, bool, bool]):
    """K2 double backward on the card: ``(d g, d image, d coords)``, None
    where ``need`` says so."""
    name = "grid_sample_patch_bwd2_cuda"
    dev = _check_cuda(name, g=g, image=image, coords=coords,
                      gg_image=gg_image, gg_coords=gg_coords)
    v, c, h, w, n = _shapes(name, image, coords)
    _expect(name, g=(g, (v, c, n)), gg_image=(gg_image, image.shape),
            gg_coords=(gg_coords, coords.shape))
    need_g, need_image, need_coords = need
    need_image = need_image and gg_coords is not None
    d_g = torch.empty(v, c, n, device=dev) if need_g else None
    d_hwc = torch.zeros(v, h, w, c, device=dev) if need_image else None
    d_coords = torch.empty(v, n, 2, device=dev) if need_coords else None
    if n > 0 and (need_g or need_image or need_coords):
        img = _channels_last(image)
        gg_hwc = None if gg_image is None else _channels_last(gg_image)
        ggc = None if gg_coords is None else gg_coords.contiguous()
        gc, crd = g.contiguous(), coords.contiguous()
        _launch("mpsnerf_grid_sample_patch_bwd2", "grid_sample_patch_bwd2",
                dev, gc.data_ptr(), img.data_ptr(),
                crd.data_ptr(), _ptr(gg_hwc), _ptr(ggc),
                _ptr(d_g), _ptr(d_hwc), _ptr(d_coords),
                v, c, h, w, n)
    return d_g, (None if d_hwc is None else d_hwc.permute(0, 3, 1, 2)), \
        d_coords


# ---- dispatch and autograd -----------------------------------------------

def _on_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


class GridSamplePatchBackward(torch.autograd.Function):
    """K2's backward as a differentiable function of ``(g, image,
    coords)``; its own backward is K2's double backward."""

    @staticmethod
    def forward(ctx, g, image, coords, need_image: bool):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(g, image, coords)
        if _on_cpu(g, image, coords):
            return grid_sample_patch_backward_plain(g, image, coords,
                                                    need_image)
        return grid_sample_patch_bwd_cuda(g, image, coords, need_image)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg_image, gg_coords):
        g, image, coords = ctx.saved_tensors
        need = tuple(ctx.needs_input_grad[:3])
        if (gg_image is None and gg_coords is None) or not any(need):
            return None, None, None, None
        args = (g, image, coords, gg_image, gg_coords, need)
        if _on_cpu(g, image, coords, gg_image, gg_coords):
            d_g, d_image, d_coords = \
                grid_sample_patch_double_backward_plain(*args)
        else:
            d_g, d_image, d_coords = grid_sample_patch_bwd2_cuda(*args)
        return d_g, d_image, d_coords, None


class GridSamplePatch(torch.autograd.Function):
    """K2: the patch-form forward with the 4-corner form's backward."""

    @staticmethod
    def forward(ctx, image, coords):
        ctx.save_for_backward(image, coords)
        if _on_cpu(image, coords):
            return grid_sample_2d_patch_plain(image, coords)
        return grid_sample_patch_fwd_cuda(image, coords)

    @staticmethod
    def backward(ctx, g):
        image, coords = ctx.saved_tensors
        # the image scatter is skipped for inputs that carry no gradient
        # (the RGB images; the latent under the encoder does)
        d_image, d_coords = GridSamplePatchBackward.apply(
            g, image, coords, ctx.needs_input_grad[0])
        return d_image, d_coords


def grid_sample_2d_patch(image: torch.Tensor, coords: torch.Tensor):
    """Sample ``image`` (V, C, H, W) at normalized coords (V, N, 2) in
    [-1, 1] (x along the width first).  Returns (V, C, N)."""
    return GridSamplePatch.apply(image, coords)


def index_features_patch(latent: torch.Tensor, uv: torch.Tensor, image_size):
    """Pixel-aligned feature lookup: ``uv`` (V, N, 2) are pixel coords of
    the full image of size ``image_size`` = (W, H); they are normalised
    against it, then sampled with align_corners against the (smaller)
    latent resolution."""
    size = torch.as_tensor(image_size, dtype=uv.dtype, device=uv.device)
    return grid_sample_2d_patch(latent, 2.0 * uv / size - 1.0)
