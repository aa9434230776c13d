#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpsnerf_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints progress lines ending in ok/FAIL; any failure exits
non-zero):
  1. the card's name and power limit; build every CUDA kernel from
     ``mpsnerf_torch/csrc`` (one nvcc per source, all started together);
  2. every kernel against its plain PyTorch version on the card: the exact
     1-NN (K1) at 131,072 x 6890 and at the fine pre-pass shape of the
     full-width view (d2 to 1e-6, >= 99.9 % equal ids, every other id a
     tie in exact d2); the packed-key 1-NN at 131,072 x 6890 (ids 100 %
     equal); the patch grid-sample K2 forward (1e-6), backward (at each
     pair of need_image/need_coords) and double backward (each output to
     1e-5 of its max |value|) at the training shapes, latent
     3x128x128x128 (channels-last as the encoder gives it, with g in both
     layouts, and (V, C, H, W)-contiguous, whose per-call copy is counted)
     and RGB 3x3x512x512 at 64,512 points; once phase 5 has captured them,
     the backward and double backward again on a plain and a smooth
     step's real latent inputs (and the flags those steps asked for);
  3. CUDA against CPU at 64^2 (full 6890-vertex rig, seeded weights, TF32
     off): the serving render (pixels 1e-4, counts exact), and one plain
     and one smooth training loss (perturb 0, the same injected smooth
     delta): loss terms 1e-4, each parameter gradient to 1e-3 of its
     tensor's max |grad|;
  4. serving at full width: 3 input views at 512^2, the flagship model
     with seeded weights, 128 samples per ray, ``ViewRenderer.render_view``
     for 3 requests after one warm-up view; each request must drop
     nothing, give finite pixels, accumulate opacity > 0.5 on > 1 % of the
     pixels and launch K1 at least twice and K2 forward; the encoded
     latent must be channels-last and K2 must copy no layout;
  5. training at full width: ``Trainer.train_item`` on two items of the
     synthetic train split (3 input views at 512^2, 4 output views, 1000
     rays per view-step, 128 samples, perturb 1), 8 view-steps of which 2
     smooth; every step must drop nothing, give finite loss terms and
     change the parameters, and K2 must copy no layout; then ms per plain
     and per smooth step by CUDA events, peak memory, launches per step
     and a profiler breakdown with K2's share of the busy time;
  6. the 1-NN variant probe (``mpsnerf_torch.tools.knn_variant_probe``) at
     2,572,288 x 6890;
  7. one ``{"kernels": [...]}`` line: each kernel's launches on its path
     and its times against its bound, the plain version and a library
     call; for K2 also the RGB, the other image layout, and the backward
     on each captured set (``captured``: plain step, smooth step inner,
     smooth step) beside the yardstick of autograd through
     ``F.grid_sample`` (not the same function at the border);
  8. the device line, last.

Launch counts are set to 0 just before each path (phases 4, 5, 6) and
read just after; launches made to compare or time a kernel do not count.
Weights are random, from seed 0, with the density head's bias set to +4 so
that the body renders opaque.  This script imports nothing of jax or of
the JAX package.
"""

import copy
import json
import subprocess
import sys
import time

FLOPS_FP32 = 67e12   # H100 SXM fp32 rate outside the tensor cores
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 rate
OPS_PER_PAIR = 8     # 3 subtractions, 3 products, 2 additions

KNN_SOURCE = "mpsnerf_torch/csrc/nearest_vertex.cu"
KNN_REPLACES = "mpsnerf_tpu/ops/knn.py:76 (_nn_kernel, pallas_call at :139)"
PACKED_SOURCE = "mpsnerf_torch/csrc/nearest_vertex_packed.cu"
PACKED_REPLACES = ("tools/knn_variant_probe.py:68 (kernel_vT via nn_vT, "
                   "pallas_call at :115)")
GS_SOURCE = "mpsnerf_torch/csrc/grid_sample_patch.cu"
GS_REPLACES = {
    "grid_sample_patch_fwd": "mpsnerf_tpu/ops/grid_sample.py:96 "
    "(grid_sample_2d_patch forward, a jax.custom_vjp compiled by XLA)",
    "grid_sample_patch_bwd": "mpsnerf_tpu/ops/grid_sample.py:132 "
    "(_grid_sample_2d_patch_bwd: the VJP of grid_sample_2d, :19)",
    "grid_sample_patch_bwd2": "mpsnerf_tpu/ops/grid_sample.py:142 "
    "(JAX autodiff of that VJP, run by the smooth loss)",
}
KERNEL_NAMES = ("nearest_vertex", "nearest_vertex_packed",
                "grid_sample_patch_fwd", "grid_sample_patch_bwd",
                "grid_sample_patch_bwd2")
TRAIN_SHAPES = {"latent": (3, 128, 128, 128), "rgb": (3, 3, 512, 512)}
TRAIN_POINTS = 64512  # the tail capacity of 1000 rays x 128 samples


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Device time per call of every kernel ``fn`` launches, from
    torch.profiler (the call time of ``cuda_ms`` also holds the host's
    enqueue time when that is the longer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_rows(prof)) \
        / 1e3 / reps


def host_us(fn, reps):
    """Host time per call to enqueue ``fn`` (no synchronisation inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def _counters():
    from mpsnerf_torch.ops import grid_sample, knn

    return (knn.LAUNCHES, grid_sample.LAUNCHES)


def reset_counts():
    from mpsnerf_torch.ops import grid_sample

    for counter in _counters() + (grid_sample.LAYOUT_COPIES,):
        for k in counter:
            counter[k] = 0


def layout_copies():
    """Channels-last copies K2's wrappers made since the last reset."""
    from mpsnerf_torch.ops import grid_sample

    return grid_sample.LAYOUT_COPIES["grid_sample_patch"]


def read_counts():
    out = {}
    for counter in _counters():
        out.update(counter)
    return out


class uncounted:
    """Launches inside the block (comparisons, timings) leave the counts
    as they were.  (Layout copies are counted on: phase 2 reads them; each
    path resets them before it runs.)"""

    def __enter__(self):
        self.saved = [dict(c) for c in _counters()]

    def __exit__(self, *exc):
        for counter, saved in zip(_counters(), self.saved):
            counter.update(saved)


def fail(msg):
    log(msg)
    raise SystemExit(1)


def compare_knn(q, v):
    """Kernel against plain on the same inputs; returns max |d2 diff|."""
    import torch

    from mpsnerf_torch.ops import knn

    with uncounted():
        d2_k, ids_k = knn.nearest_vertex_cuda(q, v)
        d2_p, ids_p = knn.nearest_vertex_plain(q, v, block_elems=1 << 26)
        torch.cuda.synchronize()
    err = float((d2_k - d2_p).abs().max())
    same = float((ids_k == ids_p).double().mean())
    diff = ids_k != ids_p
    # every differing id must be a tie in exact d2 (the diff form at each id)
    tie = bool(torch.equal(knn._d2(q[diff] - v[ids_k[diff]]),
                           knn._d2(q[diff] - v[ids_p[diff]])))
    ok = err <= 1e-6 and same >= 0.999 and tie
    log(f"[2] knn {q.shape[0]} x {v.shape[0]}: max|d2 diff| {err:.3g}, "
        f"equal ids {same:.6f}, differing ids all ties {tie}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)
    return err


def compare_packed(q, v):
    """The packed-key kernel at every variant against its plain version:
    ids 100 % equal.  Returns max |d2 diff|."""
    import torch

    from mpsnerf_torch.ops import knn
    from mpsnerf_torch.tools.knn_variant_probe import VARIANTS

    with uncounted():
        d2_p, ids_p = knn.nearest_vertex_packed_plain(q, v,
                                                      block_elems=1 << 26)
        worst, equal = 0.0, True
        for qpt, tile in VARIANTS:
            d2_k, ids_k = knn.nearest_vertex_packed_cuda(q, v, qpt=qpt,
                                                         tile=tile)
            torch.cuda.synchronize()
            equal &= bool(torch.equal(ids_k, ids_p))
            worst = max(worst, float((d2_k - d2_p).abs().max()))
    log(f"[2] packed knn {q.shape[0]} x {v.shape[0]}, {len(VARIANTS)} "
        f"variants: ids all equal to plain {equal}, max|d2 diff| "
        f"{worst:.3g}: {'ok' if equal and worst == 0.0 else 'FAIL'}")
    if not (equal and worst == 0.0):
        raise SystemExit(1)
    return worst


def k2_inputs(shape, n, seed, dev):
    """Image, coords (10 % outside [-1, 1] in x or in y, 5 % on pixel
    positions and the borders), upstream g and the double backward's
    (gg_image, gg_coords)."""
    import torch

    v, c, h, w = shape
    g = torch.Generator().manual_seed(seed)
    image = torch.randn(v, c, h, w, generator=g)
    coords = torch.rand(v, n, 2, generator=g) * 2.0 - 1.0
    n_out, n_px = n // 10, n // 20
    idx = torch.arange(n_out)
    axis = idx % 2
    inside = coords[:, idx, axis]
    coords[:, idx, axis] = torch.sign(inside) * (1.0 + 0.3 * inside.abs())
    px = torch.randint(0, w, (v, n_px), generator=g).float()
    py = torch.randint(0, h, (v, n_px), generator=g).float()
    coords[:, n_out:n_out + n_px, 0] = px / (w - 1) * 2.0 - 1.0
    coords[:, n_out:n_out + n_px, 1] = py / (h - 1) * 2.0 - 1.0
    coords[:, n_out + n_px:n_out + n_px + 8] = torch.tensor([1.0, -1.0])
    tensors = (image, coords, torch.randn(v, c, n, generator=g),
               torch.randn(v, c, h, w, generator=g),
               torch.randn(v, n, 2, generator=g))
    return [t.to(dev) for t in tensors]


def channels_last(x):
    """The same values with the channels innermost in memory (the
    encoder's latent; for g, the layout the train step's g arrives in)."""
    import torch

    if x.dim() == 4:
        return x.contiguous(memory_format=torch.channels_last)
    return x.permute(0, 2, 1).contiguous().permute(0, 2, 1)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def rel_errors(kernel_outs, plain_outs, labels, exact=None):
    """Max |kernel - plain| / max |plain| per output, to 1e-5 (None
    outputs must agree); returns (ok, worst abs error, text).  A scatter
    whose terms cancel can leave two fp32 sums in different orders further
    apart than that: where ``exact`` gives an output's float64 sum, the
    kernel passes beyond 1e-5 only if it is no farther from that sum than
    the plain version is."""
    ok, worst, parts = True, 0.0, []
    for i, (label, a, b) in enumerate(zip(labels, kernel_outs, plain_outs)):
        if a is None or b is None:
            ok &= a is None and b is None
            parts.append(f"{label} none {a is None and b is None}")
            continue
        rel = _rel(a, b)
        text = f"{label} {rel:.2g}"
        good = rel <= 1e-5
        ref = exact(i) if exact is not None and not good else None
        if ref is not None:
            rk, rp = _rel(a.double(), ref), _rel(b.double(), ref)
            good = rk <= rp
            text += f" (to the float64 sum: kernel {rk:.2g}, plain {rp:.2g})"
        ok &= good
        worst = max(worst, float((a - b).abs().max()))
        parts.append(text)
    return ok, worst, ", ".join(parts)


def scatter_f64(g, image, coords):
    """The backward's image gradient summed in float64 from the float32
    corners and weights: the exact sum both fp32 versions round."""
    from mpsnerf_torch.ops import grid_sample as gs

    k = gs._Corners(coords, image.shape[2], image.shape[3])
    gd = g.double()
    return gs._scatter(image.shape, k.lin,
                       [gd * wt.double()[:, None, :] for wt in k.w])


BWD_FLAGS = ((True, True), (True, False), (False, True))


def compare_k2_bwd(tag, g, image, coords, flags=BWD_FLAGS):
    """The backward kernel against its plain version at each (need_image,
    need_coords); returns (ok, worst abs error, text)."""
    import torch

    from mpsnerf_torch.ops import grid_sample as gs

    ok, worst, texts = True, 0.0, []
    for need in flags:
        with uncounted():
            k = gs.grid_sample_patch_bwd_cuda(g, image, coords, *need)
            torch.cuda.synchronize()
        p = gs.grid_sample_patch_backward_plain(g, image, coords, *need)
        o, w, t = rel_errors(
            k, p, ("d_image", "d_coords"),
            exact=lambda i: scatter_f64(g, image, coords) if i == 0 else None)
        ok, worst = ok and o, max(worst, w)
        texts.append(f"need {int(need[0])}{int(need[1])}: {t}")
    return ok, worst, f"{tag} bwd " + "; ".join(texts)


def compare_k2(name, shape, dev):
    """K2's three kernels against their plain versions at the training
    shape, on the image as the main path lays it out (the latent
    channels-last, the RGB as (V, 3, H, W)) and, for the latent, on a
    (V, C, H, W)-contiguous copy too (the wrappers copy that one, and
    count the copy); g in both layouts.  Returns the max abs error of
    each kernel."""
    import torch

    from mpsnerf_torch.ops import grid_sample as gs

    image, coords, g, gg_i, gg_c = k2_inputs(shape, TRAIN_POINTS, 1, dev)
    cases = [("nchw", image, g)]
    if name == "latent":
        cases = [("channels-last", channels_last(image), channels_last(g)),
                 ("channels-last, g (V,C,N)", channels_last(image), g)] \
            + cases
    need = (True, True, True)
    err = dict.fromkeys(("grid_sample_patch_fwd", "grid_sample_patch_bwd",
                         "grid_sample_patch_bwd2"), 0.0)
    ok_all = True
    for label, img, gv in cases:
        copies0 = gs.LAYOUT_COPIES["grid_sample_patch"]
        with uncounted():
            fk = gs.grid_sample_patch_fwd_cuda(img, coords)
            b2k = gs.grid_sample_patch_bwd2_cuda(gv, img, coords, gg_i, gg_c,
                                                 need)
            torch.cuda.synchronize()
        fp = gs.grid_sample_2d_patch_plain(img, coords)
        b2p = gs.grid_sample_patch_double_backward_plain(
            gv, img, coords, gg_i, gg_c, need)
        f_err = float((fk - fp).abs().max())
        ok = f_err <= 1e-6 and fk.shape == fp.shape
        b_ok, b_err, b_text = compare_k2_bwd(label, gv, img, coords)
        b2_ok, b2_err, b2_text = rel_errors(b2k, b2p, ("d_g", "d_image",
                                                       "d_coords"))
        ok &= b_ok and b2_ok
        # beyond the border in one axis the coordinate gradient still has
        # its component along the border
        with uncounted():
            dc = gs.grid_sample_patch_bwd_cuda(gv, img, coords, False,
                                               True)[1]
        outside = bool((dc[:, :TRAIN_POINTS // 10].abs().sum(-1) > 0)
                       .float().mean() > 0.5)
        copies = gs.LAYOUT_COPIES["grid_sample_patch"] - copies0
        wide_spread = img.shape[1] % 4 == 0 and img.stride(1) != 1
        ok &= outside and copies == (4 if wide_spread else 0)
        ok_all &= ok
        for kname, e in (("grid_sample_patch_fwd", f_err),
                         ("grid_sample_patch_bwd", b_err),
                         ("grid_sample_patch_bwd2", b2_err)):
            err[kname] = max(err[kname], e)
        log(f"[2] K2 {name} {tuple(shape)} ({label}) at {TRAIN_POINTS} "
            f"points: fwd max|diff| {f_err:.3g}; relative to max: {b_text}; "
            f"bwd2 {b2_text}; coordinate gradient beyond the border nonzero "
            f"{outside}; layout copies {copies}: {'ok' if ok else 'FAIL'}")
    if not ok_all:
        raise SystemExit(1)
    return err


def compare_captured(captured):
    """Phase 2 on the inputs phase 5 captured (real coordinates): each
    backward set with the flags its step used and with both outputs, and
    the double backward; returns the worst abs error of each kernel."""
    import torch

    from mpsnerf_torch.ops import grid_sample as gs

    err = {"grid_sample_patch_bwd": 0.0, "grid_sample_patch_bwd2": 0.0}
    # the steps asked for exactly these: the plain step no coordinate
    # gradient, the smooth step's inner normal gradients no image scatter
    ok_all = set(captured["bwd"]) == {"plain step", "smooth step inner",
                                      "smooth step"}
    log(f"[2] K2 backward calls of a plain and a smooth step on the latent: "
        + ", ".join(f"{k} need {tuple(map(int, need))}"
                    for k, (_, need) in captured["bwd"].items())
        + f": {'ok' if ok_all else 'FAIL'}")
    for label, (args, need) in captured["bwd"].items():
        flags = (need,) if need == (True, True) else (need, (True, True))
        ok, worst, text = compare_k2_bwd(label, *args, flags=flags)
        err["grid_sample_patch_bwd"] = max(err["grid_sample_patch_bwd"],
                                           worst)
        ok_all &= ok
        log(f"[2] K2 on captured inputs {tuple(args[1].shape)} x "
            f"{args[2].shape[1]}, {text}: {'ok' if ok else 'FAIL'}")
    args = captured["bwd2"]
    with uncounted():
        k = gs.grid_sample_patch_bwd2_cuda(*args)
        torch.cuda.synchronize()
    ok, worst, text = rel_errors(
        k, gs.grid_sample_patch_double_backward_plain(*args),
        ("d_g", "d_image", "d_coords"))
    err["grid_sample_patch_bwd2"] = worst
    ok_all &= ok
    log(f"[2] K2 on captured inputs, smooth step bwd2: {text}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok_all:
        raise SystemExit(1)
    return err


def fine_prepass_inputs(smpl, tp, rays, n_samples, tile):
    """The 1-NN inputs of the view's fine pre-pass: the candidate points in
    SMPL space (at the capacity the render uses) and the posed vertices."""
    from mpsnerf_torch.ops.compact import compact, resize_plan
    from mpsnerf_torch.ops.composite import stratified_z_vals
    from mpsnerf_torch.renderer.render import plan_rays_compact
    from mpsnerf_torch.smpl.lbs import PoseTransforms, world_to_smpl

    ro, rd, nr, fr = rays
    plan = plan_rays_compact(smpl, tp, ro, rd, nr, fr, n_samples)
    cap = max(1, -(-int(plan.n_valid) // tile)) * tile
    z = stratified_z_vals(nr[:, None], fr[:, None], n_samples)
    pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    tf = PoseTransforms.create(smpl, tp["params"])
    q = world_to_smpl(compact(resize_plan(plan, cap), pts), tf.R, tf.Th)
    return q.contiguous(), world_to_smpl(tp["vertices"], tf.R, tf.Th)


def seeded_model(device):
    import torch

    from mpsnerf_torch.models.mps_nerf import MPSNeRF

    torch.manual_seed(0)
    model = MPSNeRF()
    with torch.no_grad():
        model.alpha_linear.bias.fill_(4.0)
    return model.to(device).eval()


def device_rows(prof):
    """Device-side kernel rows of a profile (operator rows repeat their
    kernels' time), largest first."""
    import torch

    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return rows


def log_profile(tag, what, rows, wall_ms, unprofiled_ms, watch):
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"[{tag}] profiled {what}: kernels busy {busy_ms:.1f} ms of "
        f"{unprofiled_ms:.1f} ms unprofiled time "
        f"({100 * busy_ms / unprofiled_ms:.1f} %; idle "
        f"{100 * (1 - busy_ms / unprofiled_ms):.1f} %), profiled wall "
        f"{wall_ms:.1f} ms, {len(rows)} kernel names, "
        f"{sum(e.count for e in rows)} launches")
    shown = rows[:10] + [e for e in rows[10:]
                         if any(w in e.key for w in watch)]
    for e in shown:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.count:6d} x  {e.key[:100]}")
    k2_ms = sum(e.self_device_time_total for e in rows
                if "grid_sample" in e.key) / 1e3
    log(f"[{tag}] K2 kernels in {what}: {k2_ms:.3f} ms, "
        f"{100 * k2_ms / busy_ms:.1f} % of the busy time")


def breakdown(renderer, smpl, item, k, unprofiled_ms):
    """Where one view's time goes: the three stages of render_view timed
    apart (synchronised between stages), then the same view under
    torch.profiler: the kernels' summed device time against the view's
    unprofiled time (the device's busy share), and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpsnerf_torch.renderer.render import (
        fine_rays_compact, plan_rays_compact, render_rays_compact,
    )

    from mpsnerf_torch.eval.runner import view_rays

    dev = renderer.device
    rays = view_rays(item, k, dev)[0]
    sp = tp = renderer._device_side(item)
    latent = renderer._latent_for(item, sp)
    if not latent.is_contiguous(memory_format=torch.channels_last):
        fail(f"[4] the encoded latent {tuple(latent.shape)} is not "
             f"channels-last (strides {latent.stride()}): FAIL")
    n, tile, ns = rays[0].shape[0], renderer.tile, renderer.n_samples
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    def round_up(c):
        return max(1, -(-c // tile)) * tile

    plan = timed("plan pre-pass", lambda: plan_rays_compact(
        smpl, tp, *rays, ns, cap_max=round_up(n * ns)))
    cap = round_up(int(plan.n_valid))
    fplan, fids = timed("fine pre-pass (1 knn launch)",
                        lambda: fine_rays_compact(smpl, tp, *rays, ns, plan,
                                                  cap))
    fcap = round_up(int(fplan.n_valid))
    timed(f"render ({fcap // tile} tail tiles, 1 knn launch each)",
          lambda: render_rays_compact(
              renderer.model, smpl, sp, tp, latent, *rays, ns, capacity=cap,
              fine_capacity=fcap, plan=plan, fine_plan=fplan, fine_ids=fids,
              tile=tile))
    log("[4] stages of view %d: %s" % (k, ", ".join(
        f"{name} {ms:.1f} ms" for name, ms in stages.items())))

    torch.cuda.synchronize()
    with uncounted(), profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render_view(item, item, k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log_profile("4", f"view {k}", device_rows(prof), wall_ms, unprofiled_ms,
                ("nearest_vertex", "grid_sample"))


def compare_training(dev):
    """One plain and one smooth training loss at 64^2 on the CPU and on
    the card with the same weights, rays and smooth delta (perturb 0):
    loss terms to 1e-4, every parameter gradient to 1e-3 of its tensor's
    max |grad|."""
    import torch

    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.train.trainer import (
        TrainConfig, make_loss_fn, train_rays,
    )

    ds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=64,
                               n_verts=6890, split="train", n_rays=32)
    item = ds.get_item(0, instance_idx=0)
    cfg = TrainConfig(perturb=0.0)
    base = seeded_model("cpu")
    delta = 0.01 * torch.randn(32 * cfg.n_samples, 3,
                               generator=torch.Generator().manual_seed(1))
    res = {}
    with uncounted():
        for name, device in (("cpu", "cpu"), ("cuda", dev)):
            model = copy.deepcopy(base).to(device)
            rig = ds.smpl_for(0, device=device)
            inp = to_device_input(item, device, rays=True)
            for smooth in (False, True):
                model.zero_grad(set_to_none=True)
                total, (terms, _) = make_loss_fn(model, cfg, smooth)(
                    rig, inp, inp, *train_rays(inp, 0, device),
                    delta=delta.to(device))
                total.backward()
                res[name, smooth] = (
                    {f: float(getattr(terms, f).detach())
                     for f in terms._fields},
                    {n: p.grad.detach().cpu() for n, p in
                     model.named_parameters()})
    ok_all = True
    for smooth in (False, True):
        (ta, ga), (tb, gb) = res["cpu", smooth], res["cuda", smooth]
        terr = max(abs(ta[f] - tb[f]) for f in ta)
        gerr = max(float((ga[n] - gb[n]).abs().max())
                   / max(float(ga[n].abs().max()), 1e-30) for n in ga)
        ok = terr <= 1e-4 and gerr <= 1e-3 and ta["n_dropped"] == 0
        ok_all &= ok
        log(f"[3] 64^2 {'smooth' if smooth else 'plain'} train loss cuda vs "
            f"cpu: total {tb['total']:.6f}/{ta['total']:.6f}, max|term diff| "
            f"{terr:.3g}, max grad diff / tensor max {gerr:.3g}, normal "
            f"losses {tb['normal_smooth']:.4g}/{tb['smpl_normal']:.4g}: "
            f"{'ok' if ok else 'FAIL'}")
    if not ok_all:
        raise SystemExit(1)


def train_full_width(dev):
    """Phase 5; returns the launches on the main path, the timed steps'
    records and the captured K2 inputs of a plain and a smooth step."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    ds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=512,
                               n_verts=6890, split="train", n_rays=1000)
    smpl = ds.smpl_for(0, device=dev)
    items = [to_device_input(ds.get_item(0, instance_idx=0), dev, rays=True)
             for _ in range(2)]
    log(f"[5] train scene: 6890 verts, 3 input views at 512^2, 4 output "
        f"views x 1000 rays, 2 items built in {time.perf_counter() - t0:.1f} s")
    trainer = Trainer(seeded_model(dev), TrainConfig(), device=dev, seed=0)
    params = list(trainer.model.parameters())
    changed = []
    before = {}

    def pre_hook(opt, args, kwargs):
        before["p"] = [p.detach().clone() for p in params]

    def post_hook(opt, args, kwargs):
        changed.append(sum(bool((a != p).any()) for a, p in
                           zip(before["p"], params)) / len(params))

    h1 = trainer.optimizer.register_step_pre_hook(pre_hook)
    h2 = trainer.optimizer.register_step_post_hook(post_hook)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logs = []
    for item in items:
        trainer.train_item(smpl, item, item)
        logs += trainer.last_logs
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    copies = layout_copies()
    h1.remove()
    h2.remove()
    n_smooth = sum(1 for terms, _ in logs if float(terms.smpl_normal) > 0)
    ok = len(logs) == 8 and trainer.global_step == 8 and n_smooth == 2
    for s, (terms, psnr) in enumerate(logs):
        finite = all(math.isfinite(float(t)) for t in terms)
        good = finite and float(terms.n_dropped) == 0 and changed[s] > 0.9
        ok &= good
        log(f"[5] step {s} ({'smooth' if s % 4 == 0 else 'plain'}): loss "
            f"{float(terms.total):.5f} (img {float(terms.img_raw):.5f}, acc "
            f"{float(terms.acc):.5f}, normal smooth "
            f"{float(terms.normal_smooth):.4g}, smpl normal "
            f"{float(terms.smpl_normal):.4g}), psnr {float(psnr):.2f}, "
            f"n_dropped {float(terms.n_dropped):g}, parameter tensors "
            f"changed {100 * changed[s]:.0f} %: {'ok' if good else 'FAIL'}")
    main_ok = ok and copies == 0 and all(
        launches[k] > 0 for k in KERNEL_NAMES if k != "nearest_vertex_packed")
    log(f"[5] 8 view-steps ({n_smooth} smooth) in {wall:.2f} s wall (first "
        f"steps included); launches {json.dumps(launches)}; K2 layout "
        f"copies {copies}: {'ok' if main_ok else 'FAIL'}")
    if not main_ok:
        raise SystemExit(1)

    # steps 8..12 timed one by one: smooth 8 and 12, plain 9-11
    torch.cuda.reset_peak_memory_stats()
    records = []
    for _ in range(5):
        smooth = trainer.smooth_now()
        counts0 = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        terms, _ = trainer.view_step(smpl, items[1], items[1],
                                     trainer.step % 4)
        end.record()
        torch.cuda.synchronize()
        counts1 = read_counts()
        records.append({"smooth": smooth, "ms": start.elapsed_time(end),
                        "launches": {k: counts1[k] - counts0[k]
                                     for k in KERNEL_NAMES},
                        "n_dropped": float(terms.n_dropped)})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for kind in (False, True):
        rs = [r for r in records if r["smooth"] == kind]
        times = ", ".join("%.1f" % r["ms"] for r in rs)
        mean = sum(r["ms"] for r in rs) / len(rs)
        log(f"[5] {'smooth' if kind else 'plain'} step: {times} ms (CUDA "
            f"events; mean {mean:.1f}), launches per step "
            f"{json.dumps(rs[0]['launches'])}")
    log(f"[5] peak device memory over the timed steps {peak:.2f} GiB")

    for smooth in (False, True):
        # the step counter picks the kind (it moves the lr by < 0.1 %)
        trainer.step += (-trainer.step) % 4 if smooth else \
            (1 if trainer.step % 4 == 0 else 0)
        unprofiled = [r["ms"] for r in records if r["smooth"] == smooth][-1]
        torch.cuda.synchronize()
        with uncounted(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            trainer.view_step(smpl, items[1], items[1], trainer.step % 4)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        log_profile("5", f"{'smooth' if smooth else 'plain'} step",
                    device_rows(prof), wall_ms, unprofiled,
                    ("nearest_vertex", "grid_sample"))
    return launches, records, capture_k2_inputs(trainer, smpl, items[1])


def capture_k2_inputs(trainer, smpl, item):
    """The latent's K2 backward inputs as one plain and one smooth step
    give them (real points project onto clustered pixels, unlike the
    uniform coords of phase 2), one set per (need_image, need_coords) the
    steps asked for: the plain step's (1, 0), the smooth step's inner
    normal gradients (0, 1) and its outer backward (1, 1); and the smooth
    step's double backward inputs.  Copied for phase 2's comparison and
    phase 7's timings."""
    import torch

    from mpsnerf_torch.ops import grid_sample as gs

    names = {(True, False): "plain step", (False, True): "smooth step inner",
             (True, True): "smooth step"}
    bwd, bwd2 = {}, []
    wrapped = {"grid_sample_patch_bwd_cuda": gs.grid_sample_patch_bwd_cuda,
               "grid_sample_patch_bwd2_cuda": gs.grid_sample_patch_bwd2_cuda}

    def keep(tensors):
        # copies with the same strides: the layouts are part of the inputs
        return [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                    device=t.device).copy_(t)
                if isinstance(t, torch.Tensor) else t for t in tensors]

    def spy_bwd(g, image, coords, need_image, need_coords):
        need = (need_image, need_coords)
        if image.shape[1] > 3 and names[need] not in bwd:
            bwd[names[need]] = (keep((g, image, coords)), need)
        return wrapped["grid_sample_patch_bwd_cuda"](g, image, coords, *need)

    def spy_bwd2(g, image, coords, *rest):
        if image.shape[1] > 3 and not bwd2:
            bwd2.extend(keep((g, image, coords, *rest)))
        return wrapped["grid_sample_patch_bwd2_cuda"](g, image, coords, *rest)

    try:
        gs.grid_sample_patch_bwd_cuda = spy_bwd
        gs.grid_sample_patch_bwd2_cuda = spy_bwd2
        with uncounted():
            for smooth in (False, True):
                trainer.step += (-trainer.step) % 4 if smooth else \
                    (1 if trainer.step % 4 == 0 else 0)
                trainer.view_step(smpl, item, item, trainer.step % 4)
    finally:
        for name, fn in wrapped.items():
            setattr(gs, name, fn)
    return {"bwd": bwd, "bwd2": bwd2}


def _bwd_work(v, c, h, w, n, need):
    """Bytes (each input read once, each output written once) and
    operations of one backward with the flags ``need``."""
    need_image, need_coords = need
    img_b, pts_b, vcn = 4 * v * h * w * c, 4 * v * n * 2, 4 * v * c * n
    nbytes = vcn + pts_b + (img_b if need_image else 0) \
        + ((img_b + pts_b) if need_coords else 0)
    ops = v * c * n * ((8 if need_image else 0) + (20 if need_coords else 0))
    return nbytes, ops


def _bound(nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / FLOPS_FP32 * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _library_bwd(g, image, coords, need):
    """The yardstick: autograd of F.grid_sample(padding_mode="border",
    align_corners=True) on the same inputs and flags.  Not the same
    function at the border (its derivative there is the clamped
    position's, not the 4-corner form's)."""
    import torch
    import torch.nn.functional as F

    img = image.detach().requires_grad_(need[0])
    grid = coords.detach()[:, :, None, :].requires_grad_(need[1])
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    wrt = [t for t, want in zip((img, grid), need) if want]
    gl = g[..., None]
    return lambda: torch.autograd.grad(out, wrt, gl, retain_graph=True)


LIBRARY_BWD_NOTE = ("autograd of F.grid_sample(padding_mode='border', "
                    "align_corners=True) with the same flags: a yardstick, "
                    "not the same function at the border")


def k2_times(dev, errs, captured):
    """K2's kernels at the training shapes: kernel, plain, library and
    bound.  Forward on the latent as the path lays it (channels-last) and
    on a (V, C, H, W)-contiguous copy (the wrapper then copies per call),
    and on the RGB as it lies and on one channels-last copy.  Backward on
    uniform coords and on each captured set with the flags its step used
    (and with both outputs); double backward on uniform and on the smooth
    step's inputs."""
    import torch
    import torch.nn.functional as F

    from mpsnerf_torch.ops import grid_sample as gs

    out = {}
    for which, shape in TRAIN_SHAPES.items():
        image, coords, g, gg_i, gg_c = k2_inputs(shape, TRAIN_POINTS, 2, dev)
        v, c, h, w = shape
        n = TRAIN_POINTS
        if which == "latent":
            image = channels_last(image)
        other = image.contiguous() if which == "latent" else \
            channels_last(image)
        img_b, pts_b, vcn = 4 * v * h * w * c, 4 * v * n * 2, 4 * v * c * n
        with uncounted():
            def kernel():
                return gs.grid_sample_patch_fwd_cuda(image, coords)

            def library():
                return F.grid_sample(image, coords[:, :, None, :],
                                     mode="bilinear", padding_mode="border",
                                     align_corners=True)

            fwd = {
                "ms": cuda_ms(kernel, 50),
                "other_ms": cuda_ms(lambda: gs.grid_sample_patch_fwd_cuda(
                    other, coords), 50),
                "plain_ms": cuda_ms(lambda: gs.grid_sample_2d_patch_plain(
                    image, coords), 5),
                "library_ms": cuda_ms(library, 50),
                "device_ms": device_ms(kernel, 20),
                "library_device_ms": device_ms(library, 20),
                "host_us": host_us(kernel, 200),
                "library_host_us": host_us(library, 200),
            }
            fwd["bound_ms"], fwd["bound_by"] = _bound(
                img_b + pts_b + vcn, v * c * n * 7 + v * n * 12)
            need = (True, True)
            bwd = {
                "ms": cuda_ms(lambda: gs.grid_sample_patch_bwd_cuda(
                    g, image, coords, *need), 10),
                "device_ms": device_ms(lambda: gs.grid_sample_patch_bwd_cuda(
                    g, image, coords, *need), 10),
                "plain_ms": cuda_ms(lambda: gs.grid_sample_patch_backward_plain(
                    g, image, coords, *need), 3),
                "library_ms": cuda_ms(_library_bwd(g, image, coords, need),
                                      10),
            }
            bwd["bound_ms"], bwd["bound_by"] = _bound(
                *_bwd_work(v, c, h, w, n, need))
            if which == "rgb":  # the smooth step's RGB call: coords only
                bwd["coords_only_ms"] = cuda_ms(
                    lambda: gs.grid_sample_patch_bwd_cuda(
                        g, image, coords, False, True), 10)
            n3 = (True, True, True)
            bwd2 = {
                "ms": cuda_ms(lambda: gs.grid_sample_patch_bwd2_cuda(
                    g, image, coords, gg_i, gg_c, n3), 10),
                "plain_ms": cuda_ms(
                    lambda: gs.grid_sample_patch_double_backward_plain(
                        g, image, coords, gg_i, gg_c, n3), 3),
                "library_ms": None,
            }
            bwd2["bound_ms"], bwd2["bound_by"] = _bound(
                2 * vcn + 3 * img_b + 3 * pts_b, v * c * n * 60)
        other_name = "nchw_ms" if which == "latent" else "channels_last_ms"
        fwd[other_name] = fwd.pop("other_ms")
        for name, rec in (("grid_sample_patch_fwd", fwd),
                          ("grid_sample_patch_bwd", bwd),
                          ("grid_sample_patch_bwd2", bwd2)):
            rec["max_abs_err"] = errs[which][name]
            rec["shape"] = [list(shape), n]
            if which == "latent":
                out[name] = rec
            else:
                out[name]["rgb"] = rec
            lib = rec["library_ms"]
            extra = ", ".join(
                f"{k} {val:.4f}" for k, val in rec.items()
                if k.endswith(("_ms", "_us")) and k not in (
                    "ms", "plain_ms", "library_ms", "bound_ms"))
            log(f"[7] {name} {which} {tuple(shape)} x {n}: kernel "
                f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, "
                f"library {'-' if lib is None else f'{lib:.4f}'} ms, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                + (f"; {extra}" if extra else ""))
    out["grid_sample_patch_bwd"]["library_note"] = LIBRARY_BWD_NOTE

    sets = {}
    for label, (args, need) in captured["bwd"].items():
        g, image, coords = args
        v, c, h, w = image.shape
        n = coords.shape[1]
        with uncounted():
            rec = {
                "need": list(need),
                "ms": cuda_ms(lambda: gs.grid_sample_patch_bwd_cuda(
                    g, image, coords, *need), 10),
                "device_ms": device_ms(
                    lambda: gs.grid_sample_patch_bwd_cuda(
                        g, image, coords, *need), 10),
                "both_outputs_ms": cuda_ms(
                    lambda: gs.grid_sample_patch_bwd_cuda(
                        g, image, coords, True, True), 10),
                "plain_ms": cuda_ms(
                    lambda: gs.grid_sample_patch_backward_plain(
                        g, image, coords, *need), 3),
                "library_ms": cuda_ms(_library_bwd(g, image, coords, need),
                                      10),
                "shape": [list(image.shape), n],
                "g_strides": list(g.stride()),
                "image_strides": list(image.stride()),
            }
        rec["bound_ms"], rec["bound_by"] = _bound(
            *_bwd_work(v, c, h, w, n, need))
        sets[label.replace(" ", "_")] = rec
        log(f"[7] grid_sample_patch_bwd on the {label}'s latent inputs "
            f"{tuple(image.shape)} x {n}, need {need}: kernel "
            f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}; both outputs "
            f"{rec['both_outputs_ms']:.4f}), "
            f"plain {rec['plain_ms']:.3f} ms, library "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms")
    out["grid_sample_patch_bwd"]["captured"] = sets
    for label in ("plain_step", "smooth_step"):
        out["grid_sample_patch_bwd"][f"{label}_inputs_ms"] = sets[label]["ms"]
    args = captured["bwd2"]
    with uncounted():
        ms = cuda_ms(lambda: gs.grid_sample_patch_bwd2_cuda(*args), 10)
    out["grid_sample_patch_bwd2"]["smooth_step_inputs_ms"] = ms
    log(f"[7] grid_sample_patch_bwd2 on the smooth step's latent inputs "
        f"{tuple(args[1].shape)} x {args[2].shape[1]}: {ms:.4f} ms")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np

    from mpsnerf_torch import cuda_build
    from mpsnerf_torch.data import attach_body_grid, to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.eval.runner import ViewRenderer, view_rays
    from mpsnerf_torch.ops import knn
    from mpsnerf_torch.tools.knn_variant_probe import run_probe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. card, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    sources = ("nearest_vertex", "nearest_vertex_packed", "grid_sample_patch")
    cuda_build.build_kernels(sources)
    for name in sources:
        ptxas = " | ".join(
            line.strip().split("ptxas info    : ")[-1]
            for line in cuda_build.BUILD_LOGS.get(name, "").splitlines()
            if "registers" in line)
        log(f"[1] {name}.cu: {ptxas or 'cached'}")
    log(f"[1] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}: built {len(sources)} sources in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- the full-width scene (host), needed for phase 2's second shape
    n_samples, tile = 128, 16384
    t0 = time.perf_counter()
    ds = SyntheticHumanDataset(n_poses=1, n_cameras=6, input_views=[0, 2, 4],
                               image_size=512, n_verts=6890)
    item = ds.get_item(0, instance_idx=0)
    smpl = ds.smpl_for(0, device=dev)
    log(f"[4] scene: 6890 verts, views 0,2,4 in, 512^2, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 2. kernels against plain
    rng = np.random.default_rng(0)
    verts = torch.from_numpy(item["vertices"]).to(dev)
    base = item["vertices"][rng.integers(0, 6890, 131072)]
    q = torch.from_numpy((base + rng.normal(size=base.shape) * 0.05)
                         .astype(np.float32)).to(dev)
    compare_knn(q, verts)
    packed_err = compare_packed(q, verts)
    attach_body_grid(item)
    tp = to_device_input(item, dev)
    fine_q, fine_v = fine_prepass_inputs(
        smpl, tp, view_rays(item, 1, dev)[0], n_samples, tile)
    max_err = compare_knn(fine_q, fine_v)
    k2_errs = {which: compare_k2(which, shape, dev)
               for which, shape in TRAIN_SHAPES.items()}

    # ---- 3. CUDA against CPU at 64^2: serving render, then training
    small = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=64,
                                  n_verts=6890)
    s_item = small.get_item(0, instance_idx=0)
    cpu_model = seeded_model("cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    outs = {}
    with uncounted():
        for name, model, device in (("cpu", cpu_model, "cpu"),
                                    ("cuda", gpu_model, dev)):
            it = copy.deepcopy(s_item)
            rig = small.smpl_for(0, device=device)
            r = ViewRenderer(model, lambda g, rig=rig: rig,
                             n_samples=n_samples, tile=4096, device=device)
            outs[name] = r.render_view(it, it, 3)
    a, b = outs["cpu"], outs["cuda"]
    px = float((a.rgb - b.rgb.cpu()).abs().max())
    ok = (px <= 1e-4 and a.n_dropped == b.n_dropped == 0
          and a.n_body == b.n_body and a.n_candidates == b.n_candidates)
    log(f"[3] 64^2 slice cuda vs cpu: max|pixel diff| {px:.3g}, n_dropped "
        f"{b.n_dropped}/{a.n_dropped}, candidates {b.n_candidates}/"
        f"{a.n_candidates}, fine n_valid {b.n_body}/{a.n_body}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        return 1
    compare_training(dev)

    # ---- 4. serving at full width, 3 requests
    model = seeded_model(dev)
    renderer = ViewRenderer(model, lambda g: smpl, n_samples=n_samples,
                            tile=tile, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    renderer.render_view(item, item, 1)  # warm-up (encodes the latent)
    torch.cuda.synchronize()
    log(f"[4] warm-up view in {time.perf_counter() - t0:.2f} s")
    reset_counts()
    launches, view_ms = [], []
    for k in (1, 3, 5):
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = renderer.render_view(item, item, k)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_counts()
        n_launch = after["nearest_vertex"] - before["nearest_vertex"]
        n_fwd = (after["grid_sample_patch_fwd"]
                 - before["grid_sample_patch_fwd"])
        opaque = float((out.acc > 0.5).float().mean())
        finite = bool(torch.isfinite(out.rgb).all())
        ok = (out.n_dropped == 0 and finite and opaque > 0.01
              and n_launch >= 2 and n_fwd >= 2
              and out.rgb.shape == (512 * 512, 3))
        launches.append(n_launch)
        view_ms.append(start.elapsed_time(end))
        log(f"[4] view {k}: {view_ms[-1]:.1f} ms (CUDA events), "
            f"{wall * 1e3:.1f} ms wall; hit rays {out.hit_rays}, candidates "
            f"{out.n_candidates}, capacity {out.capacity}, body points "
            f"{out.n_body}, fine capacity {out.fine_capacity}, knn launches "
            f"{n_launch}, K2 forward launches {n_fwd}, n_dropped "
            f"{out.n_dropped}, acc>0.5 on {100 * opaque:.1f} % of pixels, "
            f"finite {finite}: {'ok' if ok else 'FAIL'}")
        if not ok:
            return 1
    serving_launches = read_counts()
    copies = layout_copies()
    log(f"[4] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean view "
        f"{sum(view_ms) / len(view_ms):.1f} ms; launches "
        f"{json.dumps(serving_launches)}; K2 layout copies {copies}: "
        f"{'ok' if copies == 0 else 'FAIL'}")
    if copies:
        return 1
    breakdown(renderer, smpl, item, 1, view_ms[0])
    del renderer, model
    torch.cuda.empty_cache()

    # ---- 5. training at full width
    train_launches, _, captured = train_full_width(dev)
    # phase 2 on the inputs phase 5 captured
    for name, e in compare_captured(captured).items():
        k2_errs["latent"][name] = max(k2_errs["latent"][name], e)

    # ---- 6. the variant probe
    reset_counts()
    probe = run_probe(device=dev, log=lambda m: log(f"[6] {m}"))
    probe_launches = read_counts()
    ok = all(r["equal_plain"] for r in probe["variants"].values())
    log(f"[6] probe: every variant equal to the plain packed version {ok}; "
        f"packed launches {probe_launches['nearest_vertex_packed']}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        return 1

    # ---- 7. kernel times against their bounds
    n, nv = fine_q.shape[0], fine_v.shape[0]
    with uncounted():
        ms = cuda_ms(lambda: knn.nearest_vertex_cuda(fine_q, fine_v), 10)
        plain_ms = cuda_ms(
            lambda: knn.nearest_vertex_plain(fine_q, fine_v,
                                             block_elems=1 << 26), 2)

        def library(qq, vv):
            for s in range(0, qq.shape[0], 65536):
                torch.cdist(qq[s:s + 65536], vv).min(dim=1)

        library_ms = cuda_ms(lambda: library(fine_q, fine_v), 2)
        pq, pv = (torch.rand(2_572_288, 3, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev) * 2.4 - 1.2,
            fine_v)
        packed_library_ms = cuda_ms(lambda: library(pq, pv), 2)
    ops_ms = n * nv * OPS_PER_PAIR / FLOPS_FP32 * 1e3
    bytes_ms = (n * 12 + nv * 12 + n * 8 + n * 4) / HBM_BYTES_S * 1e3
    records = [{
        "name": "nearest_vertex", "route": "cuda", "source": KNN_SOURCE,
        "replaces": KNN_REPLACES,
        "launches": train_launches["nearest_vertex"],
        "launches_serving": serving_launches["nearest_vertex"],
        "launches_per_view": launches, "shape": [n, nv],
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }]
    log(f"[7] knn at the fine pre-pass shape {n} x {nv}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms, cdist+min {library_ms:.1f} ms, bound "
        f"{records[0]['bound_ms']:.3f} ms")
    pn, pnv = probe["shape"]
    default = probe["variants"]["qpt4_tile1152"]
    best = min(probe["variants"].items(), key=lambda kv: kv[1]["ms"])
    p_ops = pn * pnv * OPS_PER_PAIR / FLOPS_FP32 * 1e3
    p_bytes = (pn * 12 + pnv * 12 + pn * 8 + pn * 4) / HBM_BYTES_S * 1e3
    records.append({
        "name": "nearest_vertex_packed", "route": "cuda",
        "source": PACKED_SOURCE, "replaces": PACKED_REPLACES,
        "launches": probe_launches["nearest_vertex_packed"],
        "shape": [pn, pnv], "max_abs_err": packed_err,
        "ms": default["ms"], "variant": "qpt4_tile1152",
        "best_variant": best[0], "best_ms": best[1]["ms"],
        "plain_ms": probe["plain_ms"], "bound_ms": max(p_ops, p_bytes),
        "bound_by": "operations" if p_ops >= p_bytes else "bytes",
        "library_ms": packed_library_ms, "k1_ms_same_shape": probe["k1_ms"],
    })
    for name, rec in k2_times(dev, k2_errs, captured).items():
        records.append({
            "name": name, "route": "cuda", "source": GS_SOURCE,
            "replaces": GS_REPLACES[name], "launches": train_launches[name],
            "launches_serving": serving_launches[name], **rec})
    log(f"[7] total {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
