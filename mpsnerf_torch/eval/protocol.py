"""The novel-view / novel-pose evaluation protocol (port of
``mpsnerf_tpu/eval/protocol.py``, without OpenCV).

  * novel-pose pass: item 0 of the window is the source; items 1..P are
    targets; render the novel views; metrics on mask_at_box pixels; PNGs
    named ``frame{:04d}_view{:04d}[_gt].png``;
  * novel-view pass: source == target pose (items 0..P-1);
  * ``metrics.json``: {novel_view,novel_pose}_{mean_human,all_human};
    ``metrics.npy``: the full metric dict, with per-image arrays of shape
    (humans, poses, views).

PNGs are written by a small encoder on ``zlib`` (8-bit RGB or grey, no
filtering), whose pixels decode to what ``cv2.imwrite`` stores.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from mpsnerf_torch.eval.metrics import psnr_metric, ssim_metric


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img8: np.ndarray) -> bytes:
    """An 8-bit (H, W, 3) RGB or (H, W) grey image as PNG bytes."""
    if img8.dtype != np.uint8 or img8.ndim not in (2, 3) or (
            img8.ndim == 3 and img8.shape[2] != 3):
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) uint8, not "
                         f"{img8.dtype} {img8.shape}")
    h, w = img8.shape[:2]
    color = 2 if img8.ndim == 3 else 0
    rows = np.ascontiguousarray(img8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                              0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _imwrite(path: str, img8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img8))


def _eval_pass(
    render_view: Callable,
    items: List[Dict],
    sp_index: Optional[int],
    novel_views: Sequence[int],
    H: int,
    W: int,
    save_path: str,
    frame_offset: int = 0,
    verbose: bool = True,
    gt_fn: Optional[Callable] = None,
    render_async: Optional[tuple] = None,
):
    """One pass over poses x views.  ``sp_index`` selects a fixed source
    item (novel-pose mode); None means sp == tp (novel-view mode).
    ``gt_fn(item, k) -> (H, W, 3)`` overrides the ground truth.

    ``render_async=(dispatch, finish)`` runs a depth-1 pipeline: view i+1
    is dispatched before view i is finished, so view i's fetch, metrics
    and PNGs overlap view i+1's device render.  The results are those of
    the sequential loop; "Time per image" is then dispatch to finish.

    Returns (mse, psnr, ssim) lists-of-lists [pose][view]."""
    os.makedirs(save_path, exist_ok=True)
    tp_items = items[1:] if sp_index is not None else items
    sp_item = items[sp_index] if sp_index is not None else None

    if render_async is not None:
        dispatch, finish = render_async
    else:
        dispatch, finish = render_view, lambda x: x

    # sized by len(): iterating a lazy DatasetWindow would build every
    # item a second time
    nv, np_ = len(novel_views), len(tp_items)
    all_mse = [[None] * nv for _ in range(np_)]
    all_psnr = [[None] * nv for _ in range(np_)]
    all_ssim = [[None] * nv for _ in range(np_)]

    def process(entry):
        pi, vi, item, k, t0, handle = entry
        rgb_pred = finish(handle)  # (H*W, 3) in [0, 1]
        if verbose:
            print("Time per image: ", time.time() - t0)

        if gt_fn is not None:
            target = np.asarray(gt_fn(item, k)).reshape(H, W, 3)
        else:
            target = np.asarray(item["rgb_all"][k]).reshape(H, W, 3)
        pred = np.asarray(rgb_pred).reshape(H, W, 3)
        mask = np.asarray(item["mask_at_box_all"][k]).reshape(H, W) > 0

        pose_idx = int(item["pose_index"])
        stem = f"frame{pose_idx + frame_offset:04d}_view{k:04d}"
        _imwrite(os.path.join(save_path, f"{stem}_gt.png"), to8b(target))
        _imwrite(os.path.join(save_path, f"{stem}.png"), to8b(pred))

        mse = float(np.mean((pred[mask] - target[mask]) ** 2))
        psnr = psnr_metric(pred[mask], target[mask])
        ssim = ssim_metric(pred[mask], target[mask], mask, H, W)
        if verbose:
            print(
                "[Test] pose:", pose_idx, " view:", k,
                " mse:", round(mse, 5), " psnr:", round(psnr, 5),
                " ssim:", round(ssim, 5),
            )
        all_mse[pi][vi] = mse
        all_psnr[pi][vi] = psnr
        all_ssim[pi][vi] = ssim

    # depth 1 only with a real async pair: deferring process() past the
    # next synchronous render would make the per-image time span two
    pipelined = render_async is not None
    pending = None
    for pi, item in enumerate(tp_items):
        sp = sp_item if sp_item is not None else item
        for vi, k in enumerate(novel_views):
            t0 = time.time()
            handle = dispatch(sp, item, k)
            if not pipelined:
                process((pi, vi, item, k, t0, handle))
                continue
            if pending is not None:
                process(pending)
            pending = (pi, vi, item, k, t0, handle)
    if pending is not None:
        process(pending)
    return all_mse, all_psnr, all_ssim


def evaluate_novel_view_pose(
    render_view: Callable,
    humans: Dict[str, Dict[str, List[Dict]]],
    novel_views: Sequence[int],
    H: int,
    W: int,
    savedir: str,
    start_poses: Optional[Dict[str, int]] = None,
    verbose: bool = True,
    gt_fn: Optional[Callable] = None,
    render_async: Optional[tuple] = None,
) -> Dict:
    """Run both protocol passes for every human and write the metrics.

    ``render_view(sp_item, tp_item, k) -> (H*W, 3)`` renders one view;
    ``humans``: name -> {"novel_pose": [items], "novel_view": [items]}
    (the novel-pose pass's first item is the source, the rest targets; in
    the novel-view pass each item is its own source); ``start_poses``:
    name -> frame offset used only in file names.  Returns the metric dict
    (also written to metrics.json and metrics.npy)."""
    start_poses = start_poses or {}
    metric = {
        "novel_view_mean_human": [], "novel_view_all_human": [],
        "novel_view_mse": [], "novel_view_psnr": [], "novel_view_ssim": [],
        "novel_pose_mean_human": [], "novel_pose_all_human": [],
        "novel_pose_mse": [], "novel_pose_psnr": [], "novel_pose_ssim": [],
        "all_human_names": list(humans.keys()),
    }

    for prefix, sp_mode in (("novel_pose", 0), ("novel_view", None)):
        h_mse, h_psnr, h_ssim = [], [], []
        for name, passes in humans.items():
            mse, psnr, ssim = _eval_pass(
                render_view, passes[prefix], sp_mode, novel_views, H, W,
                os.path.join(savedir, prefix, name),
                frame_offset=start_poses.get(name, 0) if sp_mode == 0 else 0,
                verbose=verbose, gt_fn=gt_fn, render_async=render_async,
            )
            h_mse.append(mse)
            h_psnr.append(psnr)
            h_ssim.append(ssim)

        n = len(h_mse)
        metric[f"{prefix}_mse"] = np.array(h_mse)
        metric[f"{prefix}_psnr"] = np.array(h_psnr)
        metric[f"{prefix}_ssim"] = np.array(h_ssim)
        metric[f"{prefix}_mean_human"] = np.array([
            np.mean(metric[f"{prefix}_mse"]),
            np.mean(metric[f"{prefix}_psnr"]),
            np.mean(metric[f"{prefix}_ssim"]),
        ])
        metric[f"{prefix}_all_human"] = np.array([
            np.mean(metric[f"{prefix}_mse"].reshape(n, -1), axis=-1),
            np.mean(metric[f"{prefix}_psnr"].reshape(n, -1), axis=-1),
            np.mean(metric[f"{prefix}_ssim"].reshape(n, -1), axis=-1),
        ])

    os.makedirs(savedir, exist_ok=True)
    with open(os.path.join(savedir, "metrics.json"), "w") as f:
        json.dump({
            key: metric[key].tolist()
            for key in ("novel_view_mean_human", "novel_pose_mean_human",
                        "novel_view_all_human", "novel_pose_all_human")
        }, f)
    np.save(os.path.join(savedir, "metrics.npy"), metric)
    return metric
