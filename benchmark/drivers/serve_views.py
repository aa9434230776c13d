"""Serving mixes: one client, closed loop, asks the served bundle for
target views of one subject, one at a time, and waits for each image on
the host.

Set-up exports the seeded model with the port's ``export_serving_bundle``
into ``$TMPDIR``, loads it as ``ServedRenderer``, runs its ``warmup()`` and
one view of the window's, so that the window finds the source's item
cache and latent warm.  The window asks ``render_view(item, item, k)`` for
the ring's cameras that are not inputs, in an order drawn from the seed.
The check renders a sample of the finished views' rays with the plain
reference.

Traffic parameters: ``cameras`` (the ring), ``inputs`` (the source views),
``pose_seed`` (the subject's pose), ``check_views``, ``check_rays``,
``profile_views``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import program, scene
from benchmark.harness.trace import Launches, profiled
from benchmark.reference import plain


def setup(ctx) -> Dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    size = int(cfg["image_size"])
    rig = scene.synthetic_rig(int(cfg["n_verts"]), int(cfg["rig_seed"]))
    subject = scene.Subject(rig, int(tr["cameras"]), size)
    params = scene.pose_params(np.random.default_rng(int(tr["pose_seed"])))
    item = subject.item(params, 0, tr["inputs"], range(int(tr["cameras"])))
    args = program.program_args(cfg)
    model, weights = program.build_model(args, ctx.seed, dev)

    from mpsnerf_torch.serve.bundle import (
        ServedRenderer, export_serving_bundle)

    bundle = os.path.join(ctx.tmp, f"bundle-{os.getpid()}")
    export_serving_bundle(bundle, args, model,
                          {int(item["gender"]): program.smpl_model(rig, dev)},
                          item, item, n_samples=args.N_samples,
                          tile=int(tr.get("tile", 16384)), mesh_chunk=0)
    del model
    served = ServedRenderer(bundle, device=dev)
    served.warmup()
    views = [k for k in range(int(tr["cameras"])) if k not in tr["inputs"]]
    rng = np.random.default_rng([ctx.seed, 7])
    served.render_view(item, item, views[0])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"served": served, "item": item, "rig": rig, "weights": weights,
            "views": views, "rng": rng, "args": args, "done": []}


def _orders(st):
    while True:
        yield from st["rng"].permutation(st["views"]).tolist()


def window(ctx, st, seconds: float, traced: bool) -> Dict:
    served, item = st["served"], st["item"]
    view_of = served._renderer(None)
    n_body, ends = [], []
    order = _orders(st)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        k = next(order)
        img = served.render_view(item, item, k)
        st["done"].append((k, img))
        n_body.append(view_of.last_view.n_body)
        ends.append(time.perf_counter())
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    views = np.diff([t0] + ends) * 1e3
    print("views ms: min %.1f median %.1f max %.1f" % (
        views.min(), np.median(views), views.max()), file=sys.stderr)
    return {"wall_s": wall, "units": len(st["done"]), "n_body": n_body}


def profile(ctx, st):
    """``profile_views`` more views under the profiler, with the kernels'
    launches recorded."""
    served, item = st["served"], st["item"]
    order = _orders(st)
    n = int(ctx.traffic.get("profile_views", 1))
    with Launches() as launches:
        trace = profiled(lambda: [served.render_view(item, item, next(order))
                                  for _ in range(n)])
    return trace, launches, n


def release(ctx, st):
    st.pop("served")


def _picks(ctx, st):
    """A sample, drawn from the seed, of the finished views (the one with
    the most box rays among them) and of each one's box rays."""
    tr, box = ctx.traffic, st["item"]["mask_at_box_all"]
    rng = np.random.default_rng([ctx.seed, 11])
    done = st["done"]
    longest = max(range(len(done)), key=lambda i: box[done[i][0]].sum())
    rest = [i for i in range(len(done)) if i != longest]
    picks = []
    for i in [longest] + rng.permutation(rest)[
            :int(tr["check_views"]) - 1].tolist():
        hit = np.flatnonzero(box[done[i][0]])
        picks.append((i, np.sort(rng.choice(
            hit, min(len(hit), int(tr["check_rays"])), replace=False))))
    return picks


def _reference(ctx, st, picks, tf32: bool):
    """The plain reference's colours of the picked rays, its products in
    TF32 where ``tf32``."""
    dev, item, P = ctx.device, st["item"], st["weights"]
    rig = scene.rig_tensors(st["rig"], dev)
    it = scene.item_tensors(item, dev)
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    out = []
    try:
        with torch.no_grad():
            sc = plain.make_scene(rig, it, it)
            latent = plain.encode(P, sc.images, train=False)
            for i, sel in picks:
                k = st["done"][i][0]

                def rays(key, width):
                    return torch.as_tensor(
                        item[key][k][sel].reshape(-1, width), device=dev)

                out.append(plain.render_rays(
                    P, sc, latent, rays("ray_o_all", 3), rays("ray_d_all", 3),
                    rays("near_all", 1)[:, 0], rays("far_all", 1)[:, 0],
                    st["args"].N_samples).cpu().numpy())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return out


def check(ctx, st):
    """``view_mad``: the largest, over the picked views, of the mean
    absolute gap between the served and the reference's colours at the
    picked rays; ``off_box_max``: the largest colour of a ray off the
    box (the background is 0)."""
    picks = _picks(ctx, st)
    ref = _reference(ctx, st, picks, tf32=False)
    box = st["item"]["mask_at_box_all"]
    mad = max(float(np.abs(st["done"][i][1][sel] - r).mean())
              for (i, sel), r in zip(picks, ref))
    off = max(float(np.abs(img[~box[k]]).max(initial=0.0))
              for k, img in st["done"])
    return {"view_mad": mad, "off_box_max": off}


def control(ctx, st):
    """The control: the reference with TF32 products in the program's
    place, judged as the program is."""
    picks = _picks(ctx, st)
    ref = _reference(ctx, st, picks, tf32=False)
    low = _reference(ctx, st, picks, tf32=True)
    return {"view_mad": max(float(np.abs(a - b).mean())
                            for a, b in zip(low, ref))}
