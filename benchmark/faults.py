"""Faults planted in the program under test, to show that the check
catches them (``benchmark/tests`` on the CPU, ``calibrate.py`` on the
card).  Each patches the port from outside while entered:

* ``state_unchanged``: every optimizer step leaves the parameters as it
  found them;
* ``half_batch``: a step sees the first half of its rays only, the loss
  the mean over them;
* ``altered_answer``: every served image is off by 1/255 in its red
  channel where a ray ran.
"""

from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch", "altered_answer")


@contextlib.contextmanager
def planted(name):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"fault {name!r}: one of {FAULTS}")
    import torch

    if name == "state_unchanged":
        from mpsnerf_torch.train.trainer import Trainer

        target, attr = Trainer, "rays_step"
        orig = Trainer.rays_step

        def patched(self, *a, **k):
            before = [p.detach().clone() for p in self.params]
            out = orig(self, *a, **k)
            with torch.no_grad():
                for p, b in zip(self.params, before):
                    p.copy_(b)
            return out
    elif name == "half_batch":
        from mpsnerf_torch.train import trainer as target

        attr = "train_rays"
        orig = target.train_rays

        def patched(*a, **k):
            rays = orig(*a, **k)
            half = rays[0].shape[0] // 2
            return tuple(x[:half] for x in rays)
    else:
        from mpsnerf_torch.eval.runner import ViewRenderer

        target, attr = ViewRenderer, "finish_view"
        orig = ViewRenderer.finish_view

        def patched(self, pending):
            img = orig(self, pending).copy()
            img[img.any(axis=1), 0] += 1.0 / 255.0
            return img
    setattr(target, attr, patched)
    try:
        yield
    finally:
        setattr(target, attr, orig)
