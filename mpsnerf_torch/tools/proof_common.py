"""What the port's learning proofs share (``train_proof``,
``generalization_proof``, ``pair_train_proof``): the command line, the
device and the card's name, the seeded model, the held-out view metrics
and the pred|gt PNG.  Nothing runs at import."""

from __future__ import annotations

import argparse
import os
import platform
import subprocess
from typing import Dict, List, Sequence

import numpy as np
import torch


# the JAX scripts' fixed settings: samples a ray (training and eval),
# training rays a view, and the eval's tail tile (the JAX ViewRenderer's)
N_SAMPLES, N_RAYS, TILE = 64, 512, 16384


def parser(doc: str, items: int, size: int) -> argparse.ArgumentParser:
    """The proofs' common flags, with the JAX script's item count, image
    size and rig as defaults (the rest of its setup is fixed)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu for the CPU); no fallback")
    p.add_argument("--out", default="artifacts",
                   help="directory of the JSON and the PNG")
    p.add_argument("--items", type=int, default=items,
                   help="loader items trained (each a step per view)")
    p.add_argument("--size", type=int, default=size, help="image size")
    p.add_argument("--n_verts", type=int, default=6890,
                   help="vertices of the synthetic rig")
    return p


def device_of(name: str) -> torch.device:
    """The proof's device; a CUDA device that torch does not see raises
    (the proofs measure the card and never fall back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: torch sees no CUDA device "
                             "(pass --device cpu to run on the CPU)")
        # fp32 products, as the JAX package computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def where(dev: torch.device) -> str:
    """The hardware a proof ran on, for its ``setup``: the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, or the CPU."""
    if dev.type == "cuda":
        try:
            line = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip().splitlines()[dev.index or 0]
        except (OSError, IndexError, subprocess.SubprocessError):
            line = f"{torch.cuda.get_device_name(dev)}, power limit unread"
        return line.strip()
    return (f"the CPU ({platform.machine()}, {torch.get_num_threads()} "
            "torch threads)")


def seeded(build, seed: int = 0):
    """``build()`` with torch's initialisers drawing from ``seed`` (the
    global generator's state is kept)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def view_metrics(renderer, item: Dict, views: Sequence[int], size: int,
                 pose: int) -> List[Dict]:
    """PSNR and SSIM of each view inside the body box (the JAX proofs'
    protocol), with the view's pred|gt images kept under ``images``."""
    from mpsnerf_torch.eval.metrics import psnr_metric, ssim_metric

    out = []
    for k in views:
        pred = renderer.render_view(item, item, k).reshape(size, size, 3)
        gt = np.asarray(item["rgb_all"][k]).reshape(size, size, 3)
        mask = np.asarray(item["mask_at_box_all"][k]).reshape(size,
                                                              size) > 0
        out.append({"pose": pose, "view": k,
                    "psnr": round(psnr_metric(pred[mask], gt[mask]), 3),
                    "ssim": round(ssim_metric(pred[mask], gt[mask], mask,
                                              size, size), 4),
                    "images": (pred, gt)})
    return out


def write_side_by_side(path: str, pred: np.ndarray, gt: np.ndarray) -> None:
    """pred | gt as an 8-bit RGB PNG."""
    from mpsnerf_torch.eval.protocol import encode_png, to8b

    with open(path, "wb") as f:
        f.write(encode_png(to8b(np.concatenate([pred, gt], axis=1))))


def mean_of(records: List[Dict], key: str, digits: int) -> float:
    return round(float(np.mean([r[key] for r in records])), digits)


def public(records: List[Dict]) -> List[Dict]:
    """The records without their images."""
    return [{k: v for k, v in r.items() if k != "images"} for r in records]


def history_record(item: int, step: int, logs: Dict, t: float,
                   rounded: bool) -> Dict:
    rec = {"item": item, "step": step, "loss": logs["loss"],
           "psnr": logs["psnr"], "t": round(t, 1)}
    if rounded:
        rec.update(loss=round(logs["loss"], 5), psnr=round(logs["psnr"], 2))
    return rec


def out_path(out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, name)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_finite(history: List[Dict]) -> None:
    """Raise when a logged loss is not finite."""
    bad = [h for h in history if not np.isfinite(h["loss"])]
    if bad:
        raise FloatingPointError(f"training: non-finite loss at {bad[0]}")
