"""Videos of the legacy eval's sweeps (port of ``mpsnerf_tpu/eval/video.py``):
the novel-pose and novel-view frames written next to their images as a
low-fps ``.avi``.

The JAX package writes through ``cv2.VideoWriter`` (MJPG); the card's
machine has no OpenCV, so the RIFF/AVI container is written here: one
video stream, an ``idx1`` index, each frame a keyframe.  Frames are JPEG
(``MJPG``) through PIL where it imports, else uncompressed 24-bit
``DIB ``: BGR rows padded to 4 bytes, top-down (a negative height in the
bitmap header; FFmpeg's reader, which OpenCV uses, corrupts its heap on
bottom-up rows in this container).  Frames are read with
``data/imageio.imread`` and a frame of another size is resized to the
first's as OpenCV's ``INTER_LINEAR`` does.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Iterable, List, Optional

import numpy as np

from mpsnerf_torch.data import imageio

MJPG, DIB = "MJPG", "DIB "
JPEG_QUALITY = 95  # the MJPG frames' PIL quality
_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def default_codec() -> str:
    """``MJPG`` where PIL imports (it encodes the JPEG frames), else
    ``DIB ``."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return DIB
    return MJPG


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    pad = b"\0" if len(data) % 2 else b""
    return fourcc + struct.pack("<I", len(data)) + data + pad


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def _encode_frame(rgb: np.ndarray, codec: str) -> bytes:
    if codec == MJPG:
        from PIL import Image

        buf = io.BytesIO()
        # full-resolution chroma: the frames are small, edges sharp
        Image.fromarray(rgb).save(buf, format="JPEG", quality=JPEG_QUALITY,
                                  subsampling=0)
        return buf.getvalue()
    h, w = rgb.shape[:2]
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[:, :, ::-1].reshape(h, 3 * w)  # BGR
    return rows.tobytes()


def write_avi(path: str, frames: Iterable[np.ndarray], fps: int = 1,
              codec: Optional[str] = None) -> int:
    """Write (H, W, 3) uint8 RGB frames, all of one size, to ``path`` as an
    AVI of ``fps`` frames a second; ``codec`` ``MJPG`` or ``DIB `` (default
    :func:`default_codec`).  Returns the number of frames."""
    codec = codec or default_codec()
    if codec not in (MJPG, DIB):
        raise ValueError(f"codec {codec!r}: {MJPG!r} or {DIB!r}")
    ckid = b"00dc" if codec == MJPG else b"00db"
    movi, index, size, largest = [], [], None, 0
    offset = 4  # offsets count from the 'movi' fourcc
    for rgb in frames:
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        if size is None:
            size = rgb.shape[:2]
        elif rgb.shape[:2] != size:
            raise ValueError(f"frame of {rgb.shape[:2]}, not {size}")
        data = _encode_frame(rgb, codec)
        movi.append(_chunk(ckid, data))
        index.append(struct.pack("<4sIII", ckid, _AVIIF_KEYFRAME, offset,
                                 len(data)))
        offset += len(movi[-1])
        largest = max(largest, len(data))
    if size is None:
        raise ValueError("write_avi: no frames")
    h, w = size
    n = len(movi)
    avih = struct.pack("<IIIIIIIIII4I", int(round(1e6 / fps)), largest * fps,
                       0, _AVIF_HASINDEX, n, 0, 1, largest, w, h, 0, 0, 0, 0)
    handler = codec.encode()
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", handler, 0, 0, 0, 0, 1,
                       fps, 0, n, largest, -1, 0, 0, 0, w, h)
    compression = handler if codec == MJPG else b"\0\0\0\0"
    image_bytes = 3 * w * h if codec == MJPG else (3 * w + 3) // 4 * 4 * h
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h if codec == MJPG else -h,
                       1, 24, compression, image_bytes, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    body = (b"AVI " + hdrl + _list(b"movi", b"".join(movi))
            + _chunk(b"idx1", b"".join(index)))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return n


def read_avi_index(path: str):
    """The container's header and index: ``(codec, width, height, frames
    in the header, [frame sizes from idx1])``; the check of a written
    video where no decoder is at hand."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI")
    avih = data.index(b"avih")
    total, = struct.unpack_from("<I", data, avih + 8 + 16)
    w, h = struct.unpack_from("<II", data, avih + 8 + 32)
    strh = data.index(b"strh")
    codec = data[strh + 12:strh + 16].decode()
    idx = data.rindex(b"idx1")
    n_bytes, = struct.unpack_from("<I", data, idx + 4)
    sizes = [struct.unpack_from("<4sIII", data, idx + 8 + i)[3]
             for i in range(0, n_bytes, 16)]
    return codec, w, h, total, sizes


def images_to_video(image_folder: str, video_name: str, images: List[str],
                    fps: int = 1, codec: Optional[str] = None
                    ) -> Optional[str]:
    """Write ``<image_folder>/<video_name>.avi`` from the listed frames
    (resized to the first's size); None for no frames."""
    if not images:
        return None
    first = imageio.imread(os.path.join(image_folder, images[0]))
    h, w = first.shape[:2]

    def frames():
        for name in images:
            img = imageio.imread(os.path.join(image_folder, name))
            if img.shape[:2] != (h, w):
                img = imageio.resize(img, (w, h), imageio.LINEAR)
            yield img

    path = os.path.join(image_folder, video_name + ".avi")
    write_avi(path, frames(), fps=fps, codec=codec)
    return path


def frames_to_video_bytes(frames: np.ndarray, fps: int = 3) -> bytes:
    """(N, H, W, 3) float [0, 1] RGB frames -> ``.avi`` bytes (the serving
    layer's video response)."""
    import tempfile

    frames = np.asarray(frames)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "out.avi")
        write_avi(path, ((np.clip(f, 0.0, 1.0) * 255).astype(np.uint8)
                         for f in frames), fps=fps)
        with open(path, "rb") as fh:
            return fh.read()


def write_sweep_videos(savedir: str, novel_pose_suffix: str = "_03.png",
                       novel_view_prefix: str = "frame0000") -> None:
    """The legacy test's two videos: ``novel_pose.avi`` (1 fps) of the
    files ending in ``novel_pose_suffix`` and ``novel_view.avi`` (3 fps)
    of those starting with ``novel_view_prefix``, in name order."""
    names = sorted(os.listdir(savedir))
    images_to_video(savedir, "novel_pose",
                    [f for f in names if f.endswith(novel_pose_suffix)],
                    fps=1)
    images_to_video(savedir, "novel_view",
                    [f for f in names if f.startswith(novel_view_prefix)],
                    fps=3)
