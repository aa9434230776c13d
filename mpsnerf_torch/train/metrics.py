"""Scalar logging (port of ``mpsnerf_tpu/train/metrics.py``): one JSON
record a line in ``<basedir>/summaries/<expname>/scalars.jsonl``
(``{"step", "time", <scalars>}``), and TensorBoard events in the same
directory when ``torch.utils.tensorboard`` imports."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, basedir: str, expname: str):
        self.dir = os.path.join(basedir, "summaries", expname)
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(self.dir)
        except Exception:  # tensorboard is optional
            pass

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **scalars}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
