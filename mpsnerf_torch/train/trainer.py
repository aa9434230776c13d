"""Training: the per-view optimization step and the host loop (port of
``mpsnerf_tpu/train/trainer.py`` for the flagship configuration: the acc
loss on, no correction, consistency, density or pair losses; the
hierarchical pass, occupancy compositing and a white background as
options).

One optimizer step per output view of a loader item; the step counter
counts view-steps and sets the learning rate ``lrate * 0.5^(step /
decay_steps)`` before each Adam update (beta 0.9 / 0.999, eps 1e-8), so a
restored checkpoint resumes at the decayed rate.  Every
``smooth_interval``-th step also runs the smooth loss: the query is
repeated at points jittered by ``0.01 * N(0, 1)`` and the two occupancy
normals are compared, which differentiates the normal (a gradient) once
more.

Randomness is explicit: the stratified jitter ``u``, the importance draws
``u_imp`` and the smooth delta are drawn from the trainer's
``torch.Generator``, or injected by the caller (the parity tests hand in
the JAX package's own draws).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mpsnerf_torch.models.mps_nerf import MPSNeRF, RawOutput
from mpsnerf_torch.ops.composite import composite_rays
from mpsnerf_torch.renderer.render import importance_z, query_rays, z_ladder
from mpsnerf_torch.smpl.model import SMPLModel
from mpsnerf_torch.train.losses import LossTerms, compute_losses, mse2psnr


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lrate: float = 5e-4
    decay_steps: int = 30000
    n_samples: int = 128
    # hierarchical pass (NeRF section 5.2): importance samples from the
    # coarse weights; 0 is the reference's behaviour
    n_importance: int = 0
    perturb: float = 1.0
    occupancy: bool = False
    white_bkgd: bool = False
    smooth_loss: bool = True
    smooth_interval: int = 4


def lr_at_step(cfg: TrainConfig, step: int) -> float:
    """``lrate * 0.5^(step / decay_steps)``, computed in float32 as the
    JAX package computes it."""
    t = torch.tensor(step, dtype=torch.float32) / cfg.decay_steps
    return float(cfg.lrate * torch.pow(0.5, t))


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig):
    """Adam; :meth:`Trainer.view_step` sets the group's lr per step."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lrate,
                            betas=(0.9, 0.999), eps=1e-8)


def make_loss_fn(model: MPSNeRF, cfg: TrainConfig, smooth: bool):
    """The view-step loss: ``(smpl, sp, tp, rays_o, rays_d, near, far,
    target_rgb, bkgd_msk, u=None, delta=None, u_imp=None, generator=None)
    -> (total, (terms, rgb_map))``.  It runs the model in train mode, so
    the encoder's BatchNorm statistics move.  ``u`` (R, S) is the
    stratified jitter (drawn when ``perturb > 0`` and not given); ``u_imp``
    (R, n_importance) the importance draws (drawn when ``perturb > 0`` and
    not given); ``delta`` (R * (S + n_importance), 3) the smooth loss's
    point jitter, applied to the union points (drawn when not given)."""

    def loss_fn(smpl: SMPLModel, sp_input, tp_input, rays_o, rays_d, near,
                far, target_rgb, bkgd_msk, u=None, delta=None, u_imp=None,
                generator: Optional[torch.Generator] = None):
        model.train()
        latent = model.encode(sp_input["img_all"])
        r = rays_o.shape[0]
        z_vals = z_ladder(near, far, cfg.n_samples, cfg.perturb, u, generator)

        def query(z, normals=False, jitter=None):
            return query_rays(model, smpl, sp_input, tp_input, latent, rays_o,
                              rays_d, z, normals, jitter)

        coarse_dropped = None
        if cfg.n_importance > 0:
            z_vals, coarse_dropped = importance_z(
                query, z_vals, rays_d, cfg.n_importance, cfg.perturb,
                cfg.occupancy, cfg.white_bkgd, u_imp, generator)
        n_s = z_vals.shape[1]
        raw: RawOutput = query(z_vals, smooth)
        if coarse_dropped is not None:
            raw = raw._replace(n_dropped=raw.n_dropped + coarse_dropped)
        raw_perturbed = None
        if smooth:
            if delta is None:
                delta = 0.01 * torch.randn(r * n_s, 3, generator=generator,
                                           device=rays_o.device)
            raw_perturbed = query(z_vals, True, delta)

        out = composite_rays(raw.rgb.reshape(r, n_s, 3),
                             raw.sigma.reshape(r, n_s), z_vals, rays_d,
                             occupancy=cfg.occupancy,
                             white_bkgd=cfg.white_bkgd)
        terms = compute_losses(out.rgb_map, out.acc_map, target_rgb, bkgd_msk,
                               raw, raw_perturbed)
        return terms.total, (terms, out.rgb_map)

    return loss_fn


def check_train_overflow(n_dropped: float, step: int) -> None:
    """Make compaction overflow in a train step loud: the gradient then
    came from a truncated point set.  ``MPSNERF_TRAIN_OVERFLOW``: ``warn``
    (default) prints, ``raise`` aborts, ``ignore`` says nothing."""
    if n_dropped <= 0:
        return
    policy = os.environ.get("MPSNERF_TRAIN_OVERFLOW", "warn")
    msg = (
        f"[TRAIN] step {step}: compaction overflow — {float(n_dropped):g} "
        f"in-body points dropped; gradients are truncated. Raise the "
        f"model's compact_fraction (or set MPSNERF_TRAIN_OVERFLOW=raise "
        f"to abort / =ignore to silence)."
    )
    if policy == "raise":
        raise RuntimeError(msg)
    if policy != "ignore":
        print(msg, file=sys.stderr)


def summarize_item_logs(logs: List[Tuple[LossTerms, torch.Tensor]],
                        step: int) -> Dict:
    """Average one item's per-view ``(terms, psnr)`` into the [TRAIN]-line
    dict (``n_dropped`` is the max over views) and run the overflow
    check."""
    def mean(xs):
        return float(np.mean([float(x) for x in xs]))

    out = {
        "loss": mean([t.total for t, _ in logs]),
        "img_loss": mean([t.img_raw for t, _ in logs]),
        "acc_loss": mean([t.acc for t, _ in logs]),
        "psnr": mean([p for _, p in logs]),
        "normal_smooth_loss": mean([t.normal_smooth for t, _ in logs]),
        "smpl_normal_loss": mean([t.smpl_normal for t, _ in logs]),
        "n_dropped": max(float(t.n_dropped) for t, _ in logs),
    }
    check_train_overflow(out["n_dropped"], step)
    return out


def train_rays(tp_input: Dict, k: int, device):
    """View ``k``'s training rays from the item's stacks (numpy arrays or
    tensors): ``(rays_o, rays_d, near, far, target_rgb, bkgd_msk)``."""
    def get(key):
        return torch.as_tensor(tp_input[key][k], dtype=torch.float32,
                               device=device)

    return (get("ray_o_all"), get("ray_d_all"), get("near_all")[:, 0],
            get("far_all")[:, 0], get("rgb_all"), get("bkgd_msk_all"))


class Trainer:
    """The host loop: per loader item, one optimizer step per output view;
    ``global_step`` counts view-steps.  The Adam state starts fresh, also
    after :meth:`restore` (the reference's resume)."""

    def __init__(self, model: MPSNeRF, cfg: TrainConfig, device="cuda",
                 start_step: int = 0, seed: int = 0):
        self.device = torch.device(device)
        self.model = model.to(self.device).train()
        self.cfg = cfg
        self.step = start_step
        self.params = list(self.model.parameters())
        self.optimizer = make_optimizer(self.model, cfg)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._loss = {False: make_loss_fn(self.model, cfg, smooth=False),
                      True: make_loss_fn(self.model, cfg, smooth=True)}
        self.last_logs: List[Tuple[LossTerms, torch.Tensor]] = []

    @property
    def global_step(self) -> int:
        return self.step

    def smooth_now(self) -> bool:
        return (self.cfg.smooth_loss
                and self.step % self.cfg.smooth_interval == 0)

    def view_step(self, smpl: SMPLModel, sp_input, tp_input, k: int,
                  u=None, delta=None):
        """One optimizer step on output view ``k``; returns the detached
        ``(LossTerms, psnr)``."""
        smooth = self.smooth_now()
        rays = train_rays(tp_input, k, self.device)
        self.optimizer.zero_grad(set_to_none=True)
        total, (terms, _) = self._loss[smooth](
            smpl, sp_input, tp_input, *rays, u=u, delta=delta,
            generator=self.generator)
        # for the parameters only: no gradient of the canonical points (a
        # leaf of the smooth step's normal) is computed, e.g. in K2
        total.backward(inputs=self.params)
        lr = lr_at_step(self.cfg, self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        terms = LossTerms(*(t.detach() for t in terms))
        return terms, mse2psnr(torch.clamp(terms.img_raw, min=1e-10))

    def train_item(self, smpl: SMPLModel, sp_input, tp_input) -> Dict:
        """One loader item: a view-step per output view (``tp_input``
        carries the item's ray stacks).  Returns averaged scalars."""
        n_views = int(tp_input["rgb_all"].shape[0])
        self.last_logs = [self.view_step(smpl, sp_input, tp_input, k)
                          for k in range(n_views)]
        return summarize_item_logs(self.last_logs, self.step)

    def state(self) -> Dict:
        """The checkpoint payload: step, model and optimizer state."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def restore(self, state: Dict, load_optimizer: bool = False) -> None:
        """Load a :meth:`state` payload; Adam restarts fresh unless asked."""
        self.model.load_state_dict(state["model"])
        self.step = int(state["step"])
        self.optimizer = make_optimizer(self.model, self.cfg)
        if load_optimizer:
            self.optimizer.load_state_dict(state["optimizer"])
