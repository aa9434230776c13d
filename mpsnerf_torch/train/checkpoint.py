"""Checkpointing with latest-in-dir resume (port of
``mpsnerf_tpu/train/checkpoint.py``, with ``torch.save`` in place of
orbax): checkpoints named by the zero-padded global step under
``<basedir>/<expname>/checkpoints``, the newest one reloaded on start.
The optimizer state is saved, and :meth:`Trainer.restore` leaves it out by
default (training resumes with a fresh Adam at the saved step's rate).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_STEP_RE = re.compile(r"^(\d{6,})$")


def _ckpt_dir(basedir: str, expname: str) -> str:
    return os.path.join(os.path.abspath(basedir), expname, "checkpoints")


def save_checkpoint(basedir: str, expname: str, step: int,
                    state: Dict[str, Any], is_primary: bool = True
                    ) -> Optional[str]:
    """Save ``state`` (e.g. :meth:`Trainer.state`) as ``{step:06d}``;
    only the primary process writes."""
    if not is_primary:
        return None
    d = _ckpt_dir(basedir, expname)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{step:06d}")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def list_checkpoints(basedir: str, expname: str) -> List[Tuple[int, str]]:
    d = _ckpt_dir(basedir, expname)
    if not os.path.isdir(d):
        return []
    steps = sorted(int(m.group(1)) for f in os.listdir(d)
                   if (m := _STEP_RE.match(f)))
    return [(s, os.path.join(d, f"{s:06d}")) for s in steps]


def restore_latest(basedir: str, expname: str, map_location="cpu"
                   ) -> Tuple[int, Optional[Dict[str, Any]]]:
    """The newest checkpoint: ``(step, state)``, or ``(0, None)``."""
    ckpts = list_checkpoints(basedir, expname)
    if not ckpts:
        return 0, None
    step, path = ckpts[-1]
    return step, torch.load(path, map_location=map_location,
                            weights_only=True)
