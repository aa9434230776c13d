"""What the host loaders take from OpenCV, transcribed in numpy (the card's
machine has no ``cv2``).  Every loader reads images through :func:`imread`.

- :func:`imread`: ``cv2.imread(path, IMREAD_UNCHANGED)`` followed by the
  JAX loaders' ``[..., ::-1]`` on colour images.  PNG (8-bit grey, RGB or
  RGBA, not interlaced) is decoded here with ``zlib`` and the five PNG
  filters; JPEG goes through PIL when it imports.
- :func:`undistort`: ``cv2.undistort`` as OpenCV computes it: the map of
  ``initUndistortRectifyMap`` in row stripes of ``4096 // width`` rows, the
  map's coordinates rounded to 1/32 pixel (``INTER_BITS`` 5), and a
  bilinear ``remap`` with the weights of that 32 x 32 table, the sum taken
  in the image's precision (fixed point for 8-bit images), zeros outside
  the image (``BORDER_CONSTANT``).
- :func:`resize`: ``cv2.resize`` with ``INTER_AREA`` (box mean for an
  integer downscale, area weights for any other downscale, OpenCV's
  area-mode bilinear for an upscale), ``INTER_NEAREST`` (source index
  ``floor(dst * src / dst)``) and, for 8-bit images, ``INTER_LINEAR``
  (OpenCV's fixed point: 11-bit weights, ``INTER_RESIZE_COEF_BITS``, the
  rows' sums rounded as its vector path rounds them).
- :func:`erode` / :func:`dilate`: a square kernel of ones at OpenCV's
  default anchor ``(k // 2, k // 2)`` (for an even ``k`` the window is
  ``[x - k // 2, x + k - 1 - k // 2]``); the image edge neither erodes nor
  dilates.
- :func:`rodrigues`: ``cv2.Rodrigues`` of an axis-angle vector, in float64.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib
from typing import Tuple

import numpy as np

AREA = "area"
NEAREST = "nearest"
LINEAR = "linear"

_INTER_BITS = 5
_INTER_TAB = 1 << _INTER_BITS  # 32 sub-pixel positions per axis
_COEF_BITS = 15                # fixed-point weights of 8-bit remaps

# ---- images ---------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _paeth_row(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prev[i]) >> 1)) & 0xFF
    return out


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit grey (H, W), RGB (H, W, 3) or RGBA (H, W, 4) PNG, channels
    in the file's order."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"PNG with bit depth {depth}, colour type {color}, interlace "
            f"{interlace}: only 8-bit grey, RGB and RGBA, not interlaced, "
            "are decoded")
    bpp = _PNG_CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = raw[y, 0], raw[y, 1:]
        if kind == 0:
            cur = row
        elif kind == 1:  # Sub: a running sum over each channel, mod 256
            cur = np.cumsum(row.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = row + prev
        elif kind == 3:
            cur = np.frombuffer(_average_row(row.tobytes(), prev.tobytes(),
                                             bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_paeth_row(row.tobytes(), prev.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def _decode_jpeg(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: JPEG images need a decoder and PIL (Pillow) is not "
            "installed; PNG images decode without it") from e
    with Image.open(path) as im:
        if im.mode not in ("L", "RGB"):
            raise ValueError(f"{path}: JPEG mode {im.mode} is not decoded")
        return np.asarray(im).copy()


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` then, for a colour image,
    ``[..., ::-1]`` as the JAX loaders do: RGB for RGB files, ARGB for RGBA
    ones (OpenCV's BGRA reversed)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PNG_SIGNATURE:
        with open(path, "rb") as f:
            img = decode_png(f.read())
    elif head[:2] == b"\xff\xd8":
        img = _decode_jpeg(path)
    else:
        raise ValueError(f"{path}: neither PNG nor JPEG")
    if img.ndim == 2:
        return img
    bgr = img[..., [2, 1, 0, 3][:img.shape[2]]]  # OpenCV's channel order
    return bgr[..., ::-1]


# ---- undistort -------------------------------------------------------------

def _inv3(m: np.ndarray) -> np.ndarray:
    """OpenCV's 3x3 inverse (``invert`` with DECOMP_LU takes the adjugate
    over the determinant at n <= 3), in its operation order."""
    d = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
         - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
         + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    d = 1.0 / d
    return np.array([
        (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d,
        (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
        (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d,
        (m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d,
        (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
        (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d,
        (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d,
        (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
        (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d,
    ])


def undistort_map(K: np.ndarray, D: np.ndarray, h: int, w: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.undistort``'s fixed-point map of an (h, w) image: the source
    position of each pixel in 1/32 pixels, as int64 (x, y) arrays."""
    A = np.asarray(K, np.float64).reshape(3, 3)
    d = np.zeros(14)
    dist = np.asarray(D, np.float64).ravel()
    if len(dist) > 12 and np.any(dist[12:]):
        raise NotImplementedError("tilted-sensor distortion (tau_x, tau_y)")
    d[:len(dist)] = dist
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = d[:12]
    fx, fy, u0, v0 = A[0, 0], A[1, 1], A[0, 2], A[1, 2]
    # cv2.undistort maps row stripes, each with the principal point moved
    # up by the stripe's first row (the inverse is taken per stripe)
    stripe = min(max(1, (1 << 12) // max(w, 1)), h)
    mx = np.empty((h, w), np.int64)
    my = np.empty((h, w), np.int64)
    for y0 in range(0, h, stripe):
        rows = min(stripe, h - y0)
        ar = A.copy()
        ar[1, 2] = v0 - y0
        ir = _inv3(ar)
        i = np.arange(rows, dtype=np.float64)[:, None]
        # x runs along the row as a running sum of ir[0] (OpenCV's loop);
        # ir[3] and ir[6] are zero, so y and w are constant along it
        steps = np.empty((rows, w))
        steps[:, :1] = i * ir[1] + ir[2]
        steps[:, 1:] = ir[0]
        _x = np.cumsum(steps, axis=1)
        _y = i * ir[4] + ir[5]
        _w = i * ir[7] + ir[8]
        inv_w = 1.0 / _w
        x, y = _x * inv_w, _y * inv_w
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        _2xy = 2 * x * y
        kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
              / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
        xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2) + s1 * r2 + s2 * r2 * r2
        yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy + s3 * r2 + s4 * r2 * r2
        u = fx * xd + u0
        v = fy * yd + v0
        mx[y0:y0 + rows] = np.rint(u * _INTER_TAB).astype(np.int64)
        my[y0:y0 + rows] = np.rint(v * _INTER_TAB).astype(np.int64)
    return mx, my


def _weight_table():
    """The bilinear weights of each of the 32 x 32 sub-pixel positions
    (fy * 32 + fx): float32 as OpenCV's float table, and its 8-bit table
    in 1/32768 (the float products are exact, so the rounding is too)."""
    f = np.arange(_INTER_TAB, dtype=np.float32) * np.float32(1 / _INTER_TAB)
    ay, ax = (a.reshape(-1) for a in np.meshgrid(f, f, indexing="ij"))
    one = np.float32(1.0)
    tab = np.stack([(one - ay) * (one - ax), (one - ay) * ax,
                    ay * (one - ax), ay * ax], axis=1)
    return tab, np.rint(tab * (1 << _COEF_BITS)).astype(np.int64)


_WEIGHTS, _WEIGHTS_8U = _weight_table()


@functools.lru_cache(maxsize=32)
def _undistort_plan(k_bytes: bytes, d_bytes: bytes, h: int, w: int):
    """Per camera and image size (cached: the loaders undistort every
    image and mask of a camera with one map): the flat index of each
    pixel's top-left source corner in the image padded by one zero pixel,
    its weight-table row, and the pixels whose corners all lie outside."""
    mx, my = undistort_map(np.frombuffer(k_bytes).reshape(3, 3),
                           np.frombuffer(d_bytes), h, w)
    sx, sy = mx >> _INTER_BITS, my >> _INTER_BITS
    # every corner of a pixel that starts outside [-1, size - 1] lies
    # outside the image: clip it there, where the zero border gives 0
    outside = (sx < -1) | (sx >= w) | (sy < -1) | (sy >= h)
    sx = np.clip(sx, -1, w - 1) + 1
    sy = np.clip(sy, -1, h - 1) + 1
    base = (sy * (w + 2) + sx).astype(np.int32)
    row = ((my & (_INTER_TAB - 1)) * _INTER_TAB
           + (mx & (_INTER_TAB - 1))).astype(np.int16)
    return base, row, outside


def _remap(img: np.ndarray, plan) -> np.ndarray:
    """``cv2.remap`` with INTER_LINEAR and BORDER_CONSTANT (0) through a
    fixed-point plan of :func:`_undistort_plan`: the four corners weighted
    left to right in the image's precision, 8-bit images in fixed point
    with OpenCV's rounding."""
    base, row, outside = plan
    h, w = img.shape[:2]
    pad = [(1, 1), (1, 1)] + [(0, 0)] * (img.ndim - 2)
    src = np.pad(img, pad).reshape((h + 2) * (w + 2), -1)
    corners = (base, base + 1, base + (w + 2), base + (w + 3))
    if img.dtype == np.uint8:
        wt = _WEIGHTS_8U[row]
        acc = sum(src[c].astype(np.int64) * wt[..., i, None]
                  for i, c in enumerate(corners))
        out = ((acc + (1 << (_COEF_BITS - 1))) >> _COEF_BITS).clip(0, 255)
        out = out.astype(np.uint8)
    elif img.dtype in (np.float32, np.float64):
        wt = _WEIGHTS[row].astype(img.dtype)
        out = src[corners[0]] * wt[..., 0, None]
        for i in (1, 2, 3):
            out = out + src[corners[i]] * wt[..., i, None]
    else:
        raise TypeError(f"remap of {img.dtype} images is not transcribed")
    out[outside] = 0
    return out.reshape(img.shape)


def undistort(img: np.ndarray, K: np.ndarray, D: np.ndarray) -> np.ndarray:
    """``cv2.undistort(img, K, D)`` (the new camera matrix is ``K``)."""
    plan = _undistort_plan(np.asarray(K, np.float64).tobytes(),
                           np.asarray(D, np.float64).ravel().tobytes(),
                           img.shape[0], img.shape[1])
    return _remap(img, plan)


# ---- resize ----------------------------------------------------------------

def _area_weights(ssize: int, dsize: int, scale: float) -> np.ndarray:
    """OpenCV's ``computeResizeAreaTab`` as a (dsize, ssize) float32
    matrix of the source pixels' shares of each destination pixel."""
    m = np.zeros((dsize, ssize), np.float32)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            m[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            m[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            m[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return m


def _upscale_taps(ssize: int, dsize: int, scale: float, inv: float):
    """OpenCV's area-mode bilinear taps of an upscale: source index and the
    float32 weight of the next source pixel, per destination pixel."""
    d = np.arange(dsize, dtype=np.float64)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    last = s >= ssize - 1
    f[last] = 0
    s = np.minimum(s, ssize - 1)
    return s, np.minimum(s + 1, ssize - 1), f


_RESIZE_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _linear_taps(ssize: int, dsize: int, clamp: bool):
    """OpenCV's bilinear taps: source index and the two 11-bit weights per
    destination pixel, the position ``(d + 0.5) * scale - 0.5`` in float32.
    Columns (``clamp``) pin a tap outside the image to the edge with weight
    0; rows keep the index and clamp the row they read."""
    d = np.arange(dsize, dtype=np.float64)
    f = ((d + 0.5) * (ssize / dsize) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        out = (s < 0) | (s >= ssize - 1)
        f[out] = 0
        s = np.clip(s, 0, ssize - 1)
    one = np.float32(1 << _RESIZE_COEF_BITS)
    return (s, np.rint((np.float32(1) - f) * one).astype(np.int64),
            np.rint(f * one).astype(np.int64))


def _resize_linear_u8(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """``cv2.resize(img, (dw, dh))`` of a uint8 image: the horizontal pass
    in 32-bit integers, then the vertical pass on the rows' sums shifted
    right by 4, each product's high 16 bits, (sum + 2) >> 2."""
    sh, sw = img.shape[:2]
    x = img.astype(np.int64)
    xs, ax0, ax1 = _linear_taps(sw, dw, True)
    ys, ay0, ay1 = _linear_taps(sh, dh, False)
    col = (-1,) + (1,) * (img.ndim - 2)
    rows = (x[:, xs] * ax0.reshape(col)
            + x[:, np.minimum(xs + 1, sw - 1)] * ax1.reshape(col))
    s0 = rows[np.clip(ys, 0, sh - 1)] >> 4
    s1 = rows[np.clip(ys + 1, 0, sh - 1)] >> 4
    row = (-1, 1) + (1,) * (img.ndim - 2)
    out = (((s0 * ay0.reshape(row)) >> 16) + ((s1 * ay1.reshape(row)) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, dsize: Tuple[int, int], interpolation: str
           ) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=INTER_AREA, INTER_NEAREST
    or INTER_LINEAR)``; ``dsize`` is (width, height) as in OpenCV."""
    dw, dh = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    inv_x, inv_y = dw / sw, dh / sh
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    if interpolation == LINEAR:
        if img.dtype != np.uint8:
            raise TypeError(f"INTER_LINEAR of {img.dtype} images is not "
                            "transcribed")
        return _resize_linear_u8(img, dw, dh)
    if interpolation == NEAREST:
        xs = np.minimum(np.floor(np.arange(dw) * scale_x).astype(np.int64),
                        sw - 1)
        ys = np.minimum(np.floor(np.arange(dh) * scale_y).astype(np.int64),
                        sh - 1)
        return img[ys[:, None], xs[None, :]]
    if interpolation != AREA:
        raise ValueError(f"interpolation {interpolation!r}")
    if img.dtype not in (np.float32, np.float64):
        raise TypeError(f"INTER_AREA of {img.dtype} images is not "
                        "transcribed")
    x = img.astype(np.float64)
    if scale_x >= 1 and scale_y >= 1:
        # a downscale: each destination pixel is the area-weighted mean of
        # the source pixels it covers (an integer factor: the box mean)
        wy = _area_weights(sh, dh, scale_y).astype(np.float64)
        wx = _area_weights(sw, dw, scale_x).astype(np.float64)
        out = np.tensordot(wy, x, axes=(1, 0))           # (dh, sw, ...)
        out = np.moveaxis(np.tensordot(wx, out, axes=(1, 1)), 0, 1)
        return out.astype(img.dtype)
    # an upscale: OpenCV's bilinear in area mode, rows then columns, each
    # pass in the image's precision
    t = img.dtype.type
    x0, x1, fx = _upscale_taps(sw, dw, scale_x, inv_x)
    y0, y1, fy = _upscale_taps(sh, dh, scale_y, inv_y)
    ax = [a.astype(t).reshape((-1,) + (1,) * (img.ndim - 2))
          for a in (1 - fx, fx)]
    ay = [a.astype(t).reshape((-1, 1) + (1,) * (img.ndim - 2))
          for a in (1 - fy, fy)]
    rows = img[:, x0] * ax[0] + img[:, x1] * ax[1]
    return rows[y0] * ay[0] + rows[y1] * ay[1]


# ---- morphology ------------------------------------------------------------

def _morph(img: np.ndarray, k: int, reduce, border) -> np.ndarray:
    if k <= 1:
        return img.copy()
    a = k // 2  # OpenCV's default anchor
    pad = np.pad(img, ((a, k - 1 - a), (a, k - 1 - a)),
                 constant_values=border)
    win = np.lib.stride_tricks.sliding_window_view(pad, (k, k))
    return reduce(win, axis=(2, 3)).astype(img.dtype)


def erode(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.erode(img, np.ones((k, k), np.uint8))`` of a 2-D image."""
    return _morph(img, k, np.min, np.iinfo(img.dtype).max
                  if img.dtype.kind in "ui" else np.inf)


def dilate(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.dilate(img, np.ones((k, k), np.uint8))`` of a 2-D image."""
    return _morph(img, k, np.max, np.iinfo(img.dtype).min
                  if img.dtype.kind in "ui" else -np.inf)


# ---- rotation --------------------------------------------------------------

def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """``cv2.Rodrigues(rvec)[0]``: the (3, 3) rotation of an axis-angle
    vector, in float64 as OpenCV computes it, returned in ``rvec``'s
    floating dtype."""
    r = np.asarray(rvec, np.float64).reshape(3)
    out_t = np.asarray(rvec).dtype if np.asarray(rvec).dtype.kind == "f" \
        else np.float64
    theta = float(np.sqrt(r @ r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3, dtype=out_t)
    c, s = np.cos(theta), np.sin(theta)
    c1 = 1.0 - c
    r = r * (1.0 / theta)
    rrt = np.outer(r, r)
    r_x = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
    return (c * np.eye(3) + c1 * rrt + s * r_x).astype(out_t)
