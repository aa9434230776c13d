"""Whole-view rendering for serving and eval (port of the global-compaction
path of ``mpsnerf_tpu/eval/runner.py:ViewRenderer``).

One view, in order: the box cull (only rays that hit the body's AABB run;
the rest provably composite to the background), the latent encoded once
and cached on the source item, the plan pre-pass, the capacity rounded up
to a multiple of the tile, the fine pre-pass (exact 5 cm mask and
nearest-vertex ids), the render, and the scatter of the rendered rays into
the full image.  Capacity buckets, prewarming, async dispatch and the
chunked fallback of the JAX runner are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from mpsnerf_torch.data import attach_body_grid, to_device_input
from mpsnerf_torch.models.mps_nerf import MPSNeRF
from mpsnerf_torch.renderer.render import (
    fine_rays_compact,
    plan_rays_compact,
    render_rays_compact,
)


class RenderedView(NamedTuple):
    rgb: torch.Tensor   # (H*W, 3) on the renderer's device (0 if culled)
    acc: torch.Tensor   # (H*W,) accumulated opacity (0 if culled)
    n_dropped: int      # valid points lost to capacity (always 0)
    hit_rays: int       # rays that ran (box-cull survivors)
    n_candidates: int   # body-grid candidate samples
    capacity: int       # candidate buffer
    n_body: int         # samples within 5 cm of the body
    fine_capacity: int  # body-point buffer the tail tiles cover


def view_rays(item: Dict, k: int, device):
    """View ``k``'s rays that hit the body's box, as tensors on ``device``:
    ``((rays_o, rays_d, near, far), hit indices, pixel count)``."""
    hit = np.asarray(item["mask_at_box_all"][k]).reshape(-1)
    sel = np.flatnonzero(hit)
    rays = []
    for key in ("ray_o_all", "ray_d_all", "near_all", "far_all"):
        x = np.asarray(item[key][k], np.float32).reshape(hit.shape[0], -1)[sel]
        rays.append(torch.from_numpy(
            np.ascontiguousarray(x if x.shape[1] == 3 else x[:, 0])).to(device))
    return rays, sel, hit.shape[0]


class ViewRenderer:
    """Renders full views of a target item conditioned on a source item."""

    def __init__(
        self,
        model: MPSNeRF,
        smpl_selector: Callable,  # gender int -> SMPLModel
        n_samples: int = 128,
        tile: int = 16384,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.smpl_selector = smpl_selector
        self.n_samples = n_samples
        self.tile = tile

    def _round_up(self, count: int) -> int:
        return max(1, -(-count // self.tile)) * self.tile

    def _device_side(self, item: Dict) -> Dict:
        """The item's device tensors, cached on the item (rebuilt when
        the item gained keys, e.g. a body grid)."""
        need = {k for k in item if not k.startswith("_")}
        cached = item.get("_torch_cache")
        if cached is None or cached[0] != self.device or not need <= cached[2]:
            cached = (self.device, to_device_input(item, self.device), need)
            item["_torch_cache"] = cached
        return cached[1]

    def _latent_for(self, sp_item: Dict, sp: Dict) -> torch.Tensor:
        cached = sp_item.get("_latent_cache")
        if cached is None or cached.device != self.device:
            with torch.no_grad():
                cached = self.model.encode(sp["img_all"])
            sp_item["_latent_cache"] = cached
        return cached

    @torch.no_grad()
    def render_view(self, sp_item: Dict, tp_item: Dict, k: int) -> RenderedView:
        """Render target view ``k`` of ``tp_item`` conditioned on
        ``sp_item``.  Rays that miss the body's box composite to the black
        background without running."""
        if "body_grid" not in tp_item:
            attach_body_grid(tp_item)
        sp = self._device_side(sp_item)
        tp = self._device_side(tp_item)
        smpl = self.smpl_selector(int(sp_item["gender"])).to(self.device)
        latent = self._latent_for(sp_item, sp)

        (ro, rd, nr, fr), sel, n_total = view_rays(tp_item, k, self.device)
        n = ro.shape[0]

        # capacities cover the pre-passes' exact counts, so nothing drops
        plan = plan_rays_compact(smpl, tp, ro, rd, nr, fr, self.n_samples,
                                 cap_max=self._round_up(n * self.n_samples))
        count = int(plan.n_valid)
        cap = self._round_up(count)
        fplan, fids = fine_rays_compact(smpl, tp, ro, rd, nr, fr,
                                        self.n_samples, plan, cap)
        n_body = int(fplan.n_valid)
        fcap = self._round_up(n_body)
        rgb, _, acc, n_dropped = render_rays_compact(
            self.model, smpl, sp, tp, latent, ro, rd, nr, fr, self.n_samples,
            capacity=cap, fine_capacity=fcap, plan=plan, fine_plan=fplan,
            fine_ids=fids, tile=self.tile,
        )
        n_dropped = int(n_dropped)
        assert n_dropped == 0, (n_dropped, count, cap, n_body, fcap)

        idx = torch.from_numpy(sel).to(self.device)
        rgb_full = torch.zeros(n_total, 3, device=self.device)
        rgb_full[idx] = rgb
        acc_full = torch.zeros(n_total, device=self.device)
        acc_full[idx] = acc
        return RenderedView(rgb_full, acc_full, n_dropped, n, count, cap,
                            n_body, fcap)
