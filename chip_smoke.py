#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpsnerf_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints progress lines ending in ok/FAIL; any failure exits
non-zero):
  1. the card's name and power limit; build every CUDA kernel from
     ``mpsnerf_torch/csrc`` (one nvcc per source, all started together);
     count the 1-NN kernels' instructions per pair in their SASS (fails
     where they differ from what the bounds assume);
  2. every kernel against its plain PyTorch version on the card: K1's
     bucket build on the rig, the posed rig, 1, 31 and 33 vertices and a
     20,000-vertex table (table and boxes bit-equal); the exact 1-NN (K1,
     bucketed and culled) at 131,072 x 6890, at the fine
     pre-pass shape of the full-width view, on those queries in random
     order, and on a 20,000-vertex table (the streamed path): ids 100 %
     equal and d2 bit-equal; the packed-key 1-NN at 131,072 x 6890 (ids
     100 % equal); the patch grid-sample K2 forward (1e-6), backward (at
     each pair of need_image/need_coords) and double backward (each output
     to 1e-5 of its max |value|; with a gg image in both layouts and
     without one) at the training shapes, latent 3x128x128x128
     (channels-last as the encoder gives it, with g in both layouts, and
     (V, C, H, W)-contiguous, whose per-call copy is counted) and RGB
     3x3x512x512 at 64,512 points; once phases 4 and 5 have captured
     them, K1 on a served view's tail tile and on a plain step's two
     calls (ids and d2 equal; the pairs the kernel evaluated beside the
     plain emulation's), and K2's backward and double backward on a plain
     and a smooth step's real latent inputs (and the flags those steps
     asked for);
  3. CUDA against CPU at 64^2 (full 6890-vertex rig, seeded weights, TF32
     off): the serving render, the chunked path and the chunked path at
     ``n_importance`` 4 (pixels 1e-4, counts exact), one plain and one
     smooth training loss at ``n_importance`` 0 and 4 (perturb 0, the same
     injected smooth delta): loss terms 1e-4, each parameter gradient to
     1e-3 of its tensor's max |grad|; ``run_synthetic_eval`` (every
     per-image metric to 1e-4 relative);
  4. serving at full width: 3 input views at 512^2, the flagship model
     with seeded weights, 128 samples per ray, ``ViewRenderer`` for 3
     requests after one warm-up view (each timed from the request to its
     image on the device, ``render_view_async``; the host's fetch and
     scatter, ``finish_view``, apart); each request must drop
     nothing, give finite pixels, accumulate opacity > 0.5 on > 1 % of the
     pixels and launch K1 at least twice and K2 forward; the encoded
     latent must be channels-last and K2 must copy no layout; K1's and
     all kernels' launches per view;
  5. training at full width: ``Trainer.train_item`` on two items of the
     synthetic train split (3 input views at 512^2, 4 output views, 1000
     rays per view-step, 128 samples, perturb 1), 8 view-steps of which 2
     smooth; every step must drop nothing, give finite loss terms and
     change the parameters, and K2 must copy no layout; then ms per plain
     and per smooth step by CUDA events, peak memory, launches per step
     and a profiler breakdown with K2's share of the busy time;
  6. the 1-NN variant probe (``mpsnerf_torch.tools.knn_variant_probe``) at
     2,572,288 x 6890;
  7. kernel times: each kernel's times against its bound, the plain
     version and a library call; for K1 every shape the path launches
     (``shapes``: the fine pre-pass, a tail tile, the plain step's mask and
     canonical calls, random order, the streamed path) with its bound
     (what any exact 1-NN must do: the bytes, and one pair per query), the
     pairs it evaluated and the time the card needs for those and for
     every pair (the instructions a pair counted in phase 1's SASS, over
     132 SMs x 128 lanes x the card's maximum SM clock); for K2 also the
     RGB, the other image layout, and the backward and double backward on
     each captured set beside the yardstick of autograd through
     ``F.grid_sample`` (not the same function at the border);
  8. the eval entry point at full width (the phase-4 scene and seeded
     model, ``args`` from ``configs/canonical_transformer.txt`` through
     ``mpsnerf_torch.config``): ``run_synthetic_eval`` into a temporary
     directory (6 views), pipelined and with the sequential loop (time per
     image, launches per view, finite metrics, 12 PNGs and the metrics
     files; every metric array equal and every file byte-equal between the
     two); views 1 and 3 through two async handles in flight, equal to
     ``render_view``; view 1 on the global path, the chunked path (within
     1e-4 of the global image) and the chunked path at ``n_importance`` 64
     (time, overflow chunks, peak memory, acc > 0.5 share, finite); one
     smooth and two plain train steps at ``n_importance`` 64 (times,
     ``n_dropped``, finite, launches); then phase 2's comparisons on the
     inputs these paths gave the kernels: K1 and K2 forward on one chunk
     of that view rendered as the overflow fallback does (uncompacted, 2.3M
     points), and K1, K2 forward, backward and double backward on a plain
     and a smooth step at ``n_importance`` 64;
  then one ``{"kernels": [...]}`` line: each kernel's record from phase 7
     with its launches on each path (``launches``: phase 5;
     ``launches_serving``: phase 4; ``launches_eval``,
     ``launches_hier_plain``, ``launches_hier_smooth``: phase 8);
  9. the device line, last.

Launch counts are set to 0 just before each path (phases 4, 5, 6, 8) and
read just after; launches made to compare or time a kernel do not count.
``--stop-after N`` ends the run after phase N (a short check of a new
kernel); it then prints no result lines.
Weights are random, from seed 0, with the density head's bias set to +4 so
that the body renders opaque.  This script imports nothing of jax or of
the JAX package.
"""

import collections
import copy
import json
import subprocess
import sys
import time

FLOPS_FP32 = 67e12   # H100 SXM fp32 rate outside the tensor cores (FMA = 2)
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 rate
FP32_LANES = 132 * 128  # H100 SXM: fp32 instructions issued a clock
# arithmetic instructions per query-vertex pair that the sources lead one
# to expect, none fused: K1's visit loop (3 subtractions, 3 products, 2
# additions, a compare and 2 selects); the packed kernel's (the same 8, one
# LOP3 for the key, one integer min).  Phase 1 counts them in the build's
# SASS (visit_loop_instructions), fails where they are a whole instruction
# off, and the bounds take the counted ones.
K1_INSTR_PER_PAIR = 11
PACKED_INSTR_PER_PAIR = 10
PAIR_OPCODES = ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "SEL",
                "LOP3", "VIMNMX", "VIMNMX3", "IMNMX")
STREAMED_VERTS = 20000  # above the shared-memory table's 12,032 vertices

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
KERNEL_NAMES = ("nearest_vertex", "vertex_buckets", "nearest_vertex_packed",
                "grid_sample_patch_fwd", "grid_sample_patch_bwd",
                "grid_sample_patch_bwd2")
BUCKETS_REPLACES = ("mpsnerf_tpu/ops/knn.py:76 (_nn_kernel; the table "
                    "build is part of K1's redesign, the TPU kernel has "
                    "none)")
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


SLEEP_CYCLES = 100_000_000  # >= 50 ms at the H100's 1980 MHz maximum


def device_ms(fn, reps):
    """Device time per call of ``fn``: CUDA events around ``reps`` calls
    that the host queues behind a sleep kernel, so that the card runs them
    back to back whatever the host's enqueue time (the call time of
    ``cuda_ms`` also holds that time when it is the longer).  None (not
    measured) where queueing them took the host longer than the sleep."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if queued_ms >= 0.8 * SLEEP_CYCLES / 1980e3:
        log(f"[7] device time not measured: queueing took {queued_ms:.1f} ms")
        return None
    return start.elapsed_time(end) / reps


def fmt(x, spec=".4f"):
    """``x`` formatted, or "not measured" for None."""
    return "not measured" if x is None else format(x, spec)


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


def knn_pairs(q, v, buckets):
    """The query-vertex pairs K1 evaluates on these inputs (its counter,
    passed only here; the path passes none)."""
    import torch

    from mpsnerf_torch.ops import knn

    pairs = torch.zeros(1, dtype=torch.int64, device=q.device)
    with uncounted():
        knn.nearest_vertex_cuda(q, v, buckets, pairs=pairs)
    return int(pairs)


def compare_buckets(label, v):
    """The bucket-build kernel against its plain version: table and boxes
    bit-equal."""
    import torch

    from mpsnerf_torch.ops import knn

    with uncounted():
        k = knn.build_vertex_buckets_cuda(v)
        torch.cuda.synchronize()
    p = knn.build_vertex_buckets_plain(v)
    ok = (torch.equal(k.table, p.table) and torch.equal(k.boxes, p.boxes)
          and k.n_verts == p.n_verts)
    log(f"[2] bucket build {label} ({v.shape[0]} vertices, "
        f"{k.boxes.shape[0]} buckets): table and boxes bit-equal to plain "
        f"{ok}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)


def compare_knn(label, q, v, buckets=None, emulate=False):
    """K1 against its plain version on the same inputs: ids 100 % equal
    and d2 bit-equal; with ``emulate``, the pairs the kernel evaluated
    beside the plain emulation of its culled search.  Returns (max |d2
    diff|, pairs evaluated)."""
    import torch

    from mpsnerf_torch.ops import knn

    if buckets is None:
        buckets = knn.build_vertex_buckets(v)
    with uncounted():
        d2_k, ids_k = knn.nearest_vertex_cuda(q, v, buckets)
        torch.cuda.synchronize()
    d2_p, ids_p = knn.nearest_vertex_plain(q, v, block_elems=1 << 26)
    err = float((d2_k - d2_p).abs().max()) if q.shape[0] else 0.0
    same = bool(torch.equal(ids_k, ids_p))
    bits = bool(torch.equal(d2_k, d2_p))
    pairs = knn_pairs(q, v, buckets)
    text = ""
    if emulate:
        _, ids_e, pairs_e = knn.nearest_vertex_bucketed_plain(q, buckets)
        text = (f", plain emulation of the culled search: {pairs_e} pairs "
                f"(equal {pairs_e == pairs}), ids equal "
                f"{bool(torch.equal(ids_e, ids_p))}")
    ok = same and bits
    log(f"[2] knn {label} {q.shape[0]} x {v.shape[0]} "
        f"({buckets.boxes.shape[0]} buckets): ids equal {same}, d2 "
        f"bit-equal {bits} (max|diff| {err:.3g}); pairs evaluated {pairs} "
        f"({100 * pairs / max(1, q.shape[0] * v.shape[0]):.2f} % of brute "
        f"force){text}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)
    return err, pairs


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
    # the double backward's gg image lies like the image in the first case
    # (its channel-tiled kernel) and as (V, C, H, W) in the others (its
    # per-point kernel)
    cases = [("nchw", image, g, gg_i)]
    if name == "latent":
        cases = [("channels-last", channels_last(image), channels_last(g),
                  channels_last(gg_i)),
                 ("channels-last, g (V,C,N)", channels_last(image), g, gg_i)] \
            + cases
    need = (True, True, True)
    err = dict.fromkeys(("grid_sample_patch_fwd", "grid_sample_patch_bwd",
                         "grid_sample_patch_bwd2"), 0.0)
    ok_all = True
    for label, img, gv, ggv in cases:
        copies0 = gs.LAYOUT_COPIES["grid_sample_patch"]
        with uncounted():
            fk = gs.grid_sample_patch_fwd_cuda(img, coords)
            torch.cuda.synchronize()
        fp = gs.grid_sample_2d_patch_plain(img, coords)
        f_err = float((fk - fp).abs().max())
        ok = f_err <= 1e-6 and fk.shape == fp.shape
        b_ok, b_err, b_text = compare_k2_bwd(label, gv, img, coords)
        b2_texts, b2_err = [], 0.0
        for gg_label, gg in (("gg image", ggv), ("no gg image", None)):
            with uncounted():
                b2k = gs.grid_sample_patch_bwd2_cuda(gv, img, coords, gg,
                                                     gg_c, need)
                torch.cuda.synchronize()
            b2p = gs.grid_sample_patch_double_backward_plain(
                gv, img, coords, gg, gg_c, need)
            o, e, t = rel_errors(b2k, b2p, ("d_g", "d_image", "d_coords"))
            ok &= o
            b2_err = max(b2_err, e)
            b2_texts.append(f"{gg_label}: {t}")
        b2_text = "; ".join(b2_texts)
        ok &= b_ok
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


def compare_fwd(label, image, coords, step=1 << 19):
    """K2's forward against its plain version on captured inputs, to 1e-6
    (phase 2's tolerance).  The plain version runs in slices of ``step``
    points: its four corner gathers of the latent at a fallback chunk's
    2.3M points would need ~20 GB at once.  Returns (ok, max abs error)."""
    import torch

    from mpsnerf_torch.ops import grid_sample as gs

    with uncounted():
        k = gs.grid_sample_patch_fwd_cuda(image, coords)
        torch.cuda.synchronize()
    err = 0.0
    for i in range(0, coords.shape[1], step):
        p = gs.grid_sample_2d_patch_plain(image, coords[:, i:i + step])
        err = max(err, float((k[:, :, i:i + step] - p).abs().max()))
    ok = err <= 1e-6 and tuple(k.shape) == (*image.shape[:2], coords.shape[1])
    log(f"[2] K2 forward on captured inputs, {label}: "
        f"{tuple(image.shape)} x {coords.shape[1]}, max|diff| {err:.3g}: "
        f"{'ok' if ok else 'FAIL'}")
    return ok, err


def compare_captured(captured, tag="", emulate=True):
    """Phase 2 on inputs that a path captured (real coordinates): K1 on
    each captured call (with ``emulate``, beside the plain emulation of its
    culled search); K2's forward on each captured call; where a train
    step's K2 calls were captured, each backward set with the flags its
    step used and with both outputs, and the double backward with its flags
    and with every output.  ``tag`` prefixes the labels.  Returns the worst
    abs error of each kernel, K2's keyed by (kernel, "latent" or "rgb")."""
    import torch

    from mpsnerf_torch.ops import grid_sample as gs

    err = {"nearest_vertex": 0.0}
    ok_all = True
    for label, (q, v, b) in captured["knn"].items():
        e, _ = compare_knn(tag + label, q, v, b, emulate=emulate)
        err["nearest_vertex"] = max(err["nearest_vertex"], e)
    for label, (image, coords) in captured.get("fwd", {}).items():
        ok, e = compare_fwd(tag + label, image, coords)
        key = ("grid_sample_patch_fwd",
               "latent" if image.shape[1] > 3 else "rgb")
        err[key] = max(err.get(key, 0.0), e)
        ok_all &= ok
    if "bwd" not in captured:
        if not ok_all:
            raise SystemExit(1)
        return err
    # the steps asked for exactly these: the plain step and the smooth
    # step's outer backward no coordinate gradient (the trainer's backward
    # is taken for the parameters), its inner normal gradients no image
    # scatter
    want = {"plain step": (True, False), "smooth step inner": (False, True),
            "smooth step": (True, False)}
    flags_ok = {k: need for k, (_, need) in captured["bwd"].items()} == want
    ok_all &= flags_ok
    log(f"[2] {tag}K2 backward calls of a plain and a smooth step on the "
        f"latent: " + ", ".join(f"{k} need {tuple(map(int, need))}"
                                for k, (_, need) in captured["bwd"].items())
        + f": {'ok' if flags_ok else 'FAIL'}")
    key = ("grid_sample_patch_bwd", "latent")
    err[key] = 0.0
    for label, (args, need) in captured["bwd"].items():
        flags = (need,) if need == (True, True) else (need, (True, True))
        ok, worst, text = compare_k2_bwd(label, *args, flags=flags)
        err[key] = max(err[key], worst)
        ok_all &= ok
        log(f"[2] {tag}K2 on captured inputs {tuple(args[1].shape)} x "
            f"{args[2].shape[1]}, {text}: {'ok' if ok else 'FAIL'}")
    args = captured["bwd2"]
    flags_ok = tuple(args[-1]) == (True, True, False) and args[3] is None
    log(f"[2] {tag}K2 double backward of the smooth step on the latent: need "
        f"(d g, d image, d coords) = {tuple(map(int, args[-1]))}, gg image "
        f"{'none' if args[3] is None else 'given'}: "
        f"{'ok' if flags_ok else 'FAIL'}")
    ok_all &= flags_ok
    key = ("grid_sample_patch_bwd2", "latent")
    err[key] = 0.0
    for need in (tuple(args[-1]), (True, True, True)):
        run = (*args[:-1], need)
        with uncounted():
            k = gs.grid_sample_patch_bwd2_cuda(*run)
            torch.cuda.synchronize()
        ok, worst, text = rel_errors(
            k, gs.grid_sample_patch_double_backward_plain(*run),
            ("d_g", "d_image", "d_coords"))
        err[key] = max(err[key], worst)
        ok_all &= ok
        log(f"[2] {tag}K2 on captured inputs {tuple(args[1].shape)} x "
            f"{args[2].shape[1]}, smooth step bwd2, need "
            f"{tuple(map(int, need))}: {text}: {'ok' if ok else 'FAIL'}")
    if not ok_all:
        raise SystemExit(1)
    return err


def capture_view_knn(renderer, item, k):
    """K1's inputs in one served view: the fine pre-pass call and the
    middle tail tile (canonical points against ``t_vertices``, with the
    view's buckets)."""
    from mpsnerf_torch.ops import knn

    calls = []
    wrapped = knn.nearest_vertex_cuda

    def spy(query, verts, buckets=None, pairs=None):
        calls.append((query.clone(), verts, buckets))
        return wrapped(query, verts, buckets, pairs)

    try:
        knn.nearest_vertex_cuda = spy
        with uncounted():
            renderer.render_view(item, item, k)
    finally:
        knn.nearest_vertex_cuda = wrapped
    tiles = calls[1:]
    q, v, b = tiles[len(tiles) // 2]
    return {"tail tile": (q, v, b)}, len(tiles)


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
    unprofiled time (the device's busy share), and the top kernels.
    Returns the kernel launches of the profiled view."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpsnerf_torch.renderer.render import (
        fine_rays_compact, plan_rays_compact, render_rays_compact,
    )

    from mpsnerf_torch.eval.runner import view_rays

    dev = renderer.device
    rays = view_rays(item, k, dev, item["mask_at_box_all"][k])[0]
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
        pending = renderer.render_view_async(item, item, k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        renderer.finish_view(pending)
    rows = device_rows(prof)
    log_profile("4", f"view {k}", rows, wall_ms, unprofiled_ms,
                ("nearest_vertex", "grid_sample"))
    return sum(e.count for e in rows)


def compare_training(dev, n_importance=0):
    """One plain and one smooth training loss at 64^2 on the CPU and on
    the card with the same weights, rays and smooth delta (perturb 0, so
    the importance samples of ``n_importance`` are deterministic): loss
    terms to 1e-4, every parameter gradient to 1e-3 of its tensor's max
    |grad|."""
    import torch

    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.train.trainer import (
        TrainConfig, make_loss_fn, train_rays,
    )

    ds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=64,
                               n_verts=6890, split="train", n_rays=32)
    item = ds.get_item(0, instance_idx=0)
    cfg = TrainConfig(perturb=0.0, n_importance=n_importance)
    base = seeded_model("cpu")
    delta = 0.01 * torch.randn(32 * (cfg.n_samples + n_importance), 3,
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
                total.backward(inputs=list(model.parameters()))
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
        log(f"[3] 64^2 {'smooth' if smooth else 'plain'} train loss "
            f"(n_importance {n_importance}) cuda vs cpu: total {tb['total']:.6f}/{ta['total']:.6f}, max|term diff| "
            f"{terr:.3g}, max grad diff / tensor max {gerr:.3g}, normal "
            f"losses {tb['normal_smooth']:.4g}/{tb['smpl_normal']:.4g}: "
            f"{'ok' if ok else 'FAIL'}")
    if not ok_all:
        raise SystemExit(1)


def eval_args():
    """The eval entry point's ``args``: the flagship config as the port's
    parser reads it (``N_samples 128``, ``chunk 12000``)."""
    import pathlib

    from mpsnerf_torch.config import parse_args

    config = pathlib.Path(__file__).resolve().parent / "configs"
    return parse_args(["--config",
                       str(config / "canonical_transformer.txt")])


def compare_synthetic_eval(small, cpu_model, gpu_model, dev):
    """``run_synthetic_eval`` at 64^2 on the CPU and on the card with the
    same weights: every per-image metric to 1e-4 relative."""
    import tempfile

    import numpy as np

    from mpsnerf_torch.eval.runner import run_synthetic_eval

    res = {}
    with uncounted(), tempfile.TemporaryDirectory() as tmp:
        for name, model, device in (("cpu", cpu_model, "cpu"),
                                    ("cuda", gpu_model, dev)):
            rig = small.smpl_for(0, device=device)
            res[name] = run_synthetic_eval(
                eval_args(), model, lambda g, rig=rig: rig,
                f"{tmp}/{name}", small, verbose=False, device=device)
    keys = [f"{p}_{m}" for p in ("novel_pose", "novel_view")
            for m in ("mse", "psnr", "ssim")]
    err = max(float(np.max(np.abs(res["cuda"][k] - res["cpu"][k])
                           / np.maximum(np.abs(res["cpu"][k]), 1e-30)))
              for k in keys)
    ok = err <= 1e-4 and all(np.isfinite(res["cuda"][k]).all() for k in keys)
    log(f"[3] 64^2 run_synthetic_eval cuda vs cpu: psnr "
        f"{res['cuda']['novel_view_mean_human'][1]:.4f}/"
        f"{res['cpu']['novel_view_mean_human'][1]:.4f} (novel view), "
        f"{res['cuda']['novel_pose_mean_human'][1]:.4f}/"
        f"{res['cpu']['novel_pose_mean_human'][1]:.4f} (novel pose); max "
        f"relative metric diff {err:.3g}: {'ok' if ok else 'FAIL'}")
    if not ok:
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
    return launches, records, capture_train_inputs(trainer, smpl, items[1])


def timed_eval(args, model, smpl, ds, dev, pipelined):
    """``run_synthetic_eval`` into a temporary directory, pipelined (as
    it runs) or with the protocol's sequential loop; returns (the metrics,
    seconds inside the protocol, launches, the files written: path ->
    SHA-256 of the bytes)."""
    import hashlib
    import os
    import tempfile

    import torch

    from mpsnerf_torch.eval import runner

    protocol = runner.evaluate_novel_view_pose
    spent = {}

    def timed(*a, render_async=None, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = protocol(*a, render_async=render_async if pipelined else None,
                       **kw)
        torch.cuda.synchronize()
        spent["s"] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        runner.evaluate_novel_view_pose = timed
        try:
            reset_counts()
            metric = runner.run_synthetic_eval(args, model, lambda g: smpl,
                                               tmp, ds, verbose=False,
                                               device=dev)
            launches = read_counts()
        finally:
            runner.evaluate_novel_view_pose = protocol
        files = {}
        for d, _, fs in os.walk(tmp):
            for f in fs:
                with open(os.path.join(d, f), "rb") as fh:
                    files[os.path.relpath(os.path.join(d, f), tmp)] = \
                        hashlib.sha256(fh.read()).hexdigest()
    return metric, spent["s"], launches, files


def capture_fallback_chunk(renderer, item, k):
    """K1's and K2 forward's inputs in one chunk of view ``k`` rendered as
    the chunked path's overflow fallback renders it (uncompacted: every
    point runs the single-phase 1-NN and the tail): the first chunk of the
    shuffled box-hit rays, and of each kernel's calls the largest (the
    fine pass, at ``n_samples + n_importance`` points a ray)."""
    import numpy as np
    import torch

    from mpsnerf_torch.ops import grid_sample as gs
    from mpsnerf_torch.ops import knn

    calls = {"knn": {}, "fwd": {}}
    wrapped_fwd, wrapped_knn = gs.grid_sample_patch_fwd_cuda, \
        knn.nearest_vertex_cuda

    def spy_knn(query, verts, buckets=None, pairs=None):
        label = "fallback canonical" if buckets is not None else \
            "fallback mask"
        old = calls["knn"].get(label)
        if old is None or query.shape[0] >= old[0].shape[0]:
            calls["knn"][label] = (query.clone(), verts.clone(), buckets)
        return wrapped_knn(query, verts, buckets, pairs)

    def spy_fwd(image, coords):
        label = "fallback " + ("latent" if image.shape[1] > 3 else "rgb")
        old = calls["fwd"].get(label)
        if old is None or coords.shape[1] >= old[1].shape[1]:
            calls["fwd"][label] = (image, coords.clone())
        return wrapped_fwd(image, coords)

    smpl, sp, tp, latent, rays, _, _ = renderer._prep_view(
        item, item, k, renderer._view_ray_mask(item, k))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(
        rays[0].shape[0])[:renderer.chunk]).to(rays[0].device)
    try:
        gs.grid_sample_patch_fwd_cuda = spy_fwd
        knn.nearest_vertex_cuda = spy_knn
        with uncounted(), torch.no_grad():
            renderer._chunk(renderer._model_nc, smpl, sp, tp, latent,
                            [x[perm] for x in rays])
            torch.cuda.synchronize()
    finally:
        gs.grid_sample_patch_fwd_cuda = wrapped_fwd
        knn.nearest_vertex_cuda = wrapped_knn
    return calls


def eval_full_width(dev, ds, smpl):
    """Phase 8: the eval entry point at full width.  Returns the launches
    of its runs (``eval``: run_synthetic_eval, pipelined; ``hier_plain``
    and ``hier_smooth``: train steps at n_importance 64) and the worst
    abs error of each kernel on the inputs these paths gave it."""
    import math

    import numpy as np
    import torch

    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.eval.runner import ViewRenderer
    from mpsnerf_torch.train.trainer import TrainConfig, Trainer

    args = eval_args()
    if (args.N_samples, args.chunk, args.N_importance) != (128, 12000, 0):
        fail(f"[8] configs/canonical_transformer.txt parsed to N_samples "
             f"{args.N_samples}, chunk {args.chunk}, N_importance "
             f"{args.N_importance}: FAIL")
    model = seeded_model(dev)
    out = {}
    runs = {}
    for pipelined in (True, False):
        metric, secs, launches, files = timed_eval(args, model, smpl, ds,
                                                   dev, pipelined)
        runs[pipelined] = (metric, secs, files)
        n_views = (metric["novel_pose_psnr"].size
                   + metric["novel_view_psnr"].size)
        finite = all(np.isfinite(metric[f"{p}_{m}"]).all()
                     for p in ("novel_pose", "novel_view")
                     for m in ("mse", "psnr", "ssim"))
        pngs = [f for f in files if f.endswith(".png")]
        ok = (finite and n_views == 6 and len(pngs) == 12
              and "metrics.json" in files and "metrics.npy" in files
              and all(launches[k] > 0 for k in ("nearest_vertex",
                                                "vertex_buckets",
                                                "grid_sample_patch_fwd")))
        mode = "pipelined" if pipelined else "sequential"
        if pipelined:
            out["eval"] = launches
        log(f"[8] run_synthetic_eval ({mode}): {n_views} views (3 novel "
            f"pose, 3 novel view) in {secs:.2f} s inside the protocol, "
            f"{1e3 * secs / n_views:.1f} ms per image; "
            f"psnr {metric['novel_pose_mean_human'][1]:.3f} (novel pose) / "
            f"{metric['novel_view_mean_human'][1]:.3f} (novel view), ssim "
            f"{metric['novel_pose_mean_human'][2]:.4f} / "
            f"{metric['novel_view_mean_human'][2]:.4f}; launches per view: K1 "
            f"{launches['nearest_vertex'] / n_views:.1f}, bucket builds "
            f"{launches['vertex_buckets'] / n_views:.1f}, K2 forward "
            f"{launches['grid_sample_patch_fwd'] / n_views:.1f}; "
            f"{len(pngs)} PNGs, metrics.json and metrics.npy written: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)
    (mp, sp_, fp), (ms, ss, fs) = runs[True], runs[False]
    same_metrics = mp.keys() == ms.keys() and all(
        np.array_equal(np.asarray(mp[k]), np.asarray(ms[k])) for k in mp)
    same_files = fp == fs
    ok = same_metrics and same_files
    log(f"[8] pipelined {sp_:.2f} s against sequential {ss:.2f} s; every "
        f"metric array equal {same_metrics}; the {len(fp)} files (12 PNGs, "
        f"metrics.json, metrics.npy) byte-equal {same_files}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)

    # the async handles against the synchronous render: views 1 and 3 on
    # the eval's renderer (the global path), two handles in flight
    item = ds.get_item(0, instance_idx=0)
    r = ViewRenderer(model, lambda g: smpl, chunk=min(args.chunk, 8192),
                     n_samples=args.N_samples, device=dev)
    with uncounted():
        sync = [r.render_view(item, item, k) for k in (1, 3)]
        handles = [r.render_view_async(item, item, k) for k in (1, 3)]
        on_card = all(h.done is None and all(
            isinstance(x, torch.Tensor)
            and x.device.type == torch.device(dev).type for x in h.out)
            for h in handles)
        equal = [bool(np.array_equal(r.finish_view(h), img))
                 for h, img in zip(handles, sync)]
    ok = on_card and all(equal) and not np.array_equal(sync[0], sync[1])
    log(f"[8] views 1 and 3, two async handles in flight (device outputs "
        f"held until finished {on_card}) against render_view: images "
        f"equal {equal}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)

    # view 1 on the chunked path against the global path
    views = {}
    fallback = None
    for label, opts in (("global", {}),
                        ("chunked", dict(global_compact=False)),
                        ("chunked n_importance 64",
                         dict(global_compact=False, n_importance=64))):
        r = ViewRenderer(model, lambda g: smpl, chunk=args.chunk,
                         n_samples=args.N_samples, device=dev, **opts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rgb = r.render_view(item, item, 1)
        secs = time.perf_counter() - t0
        st = r.last_view
        views[label] = rgb
        log(f"[8] view 1, {label} (chunk {r.chunk}): {1e3 * secs:.1f} ms, "
            f"hit rays {st.hit_rays}, overflow chunks {st.n_overflow_chunks} "
            f"({st.n_dropped} points dropped and rendered again "
            f"uncompacted), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, acc>0.5 "
            f"on {100 * float((st.acc > 0.5).mean()):.2f} % of pixels, finite "
            f"{bool(np.isfinite(rgb).all())}")
        if not np.isfinite(rgb).all():
            fail("[8] non-finite pixels: FAIL")
        if opts.get("n_importance"):
            fallback = capture_fallback_chunk(r, item, 1)
        del r
    px = float(np.abs(views["chunked"] - views["global"]).max())
    log(f"[8] view 1 chunked against global: max|pixel diff| {px:.3g}: "
        f"{'ok' if px <= 1e-4 else 'FAIL'}")
    if px > 1e-4:
        raise SystemExit(1)
    del views
    torch.cuda.empty_cache()
    # the kernels on the inputs of a fallback chunk at n_importance 64
    errs = compare_captured(fallback, tag="n_importance 64 ", emulate=False)
    del fallback

    # one smooth and two plain steps at n_importance 64
    tds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=512,
                                n_verts=6890, split="train", n_rays=1000)
    titem = to_device_input(tds.get_item(0, instance_idx=0), dev, rays=True)
    tsmpl = tds.smpl_for(0, device=dev)
    trainer = Trainer(seeded_model(dev), TrainConfig(n_importance=64),
                      device=dev, seed=0)
    torch.cuda.reset_peak_memory_stats()
    for s in range(3):
        smooth = trainer.smooth_now()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        terms, psnr = trainer.view_step(tsmpl, titem, titem, s)
        end.record()
        torch.cuda.synchronize()
        launches = read_counts()
        finite = all(math.isfinite(float(t)) for t in terms)
        need = ["nearest_vertex", "vertex_buckets", "grid_sample_patch_fwd",
                "grid_sample_patch_bwd"] + (["grid_sample_patch_bwd2"]
                                            if smooth else [])
        ok = finite and all(launches[k] > 0 for k in need)
        kind = "smooth" if smooth else "plain"
        out.setdefault(f"hier_{kind}", launches)
        log(f"[8] n_importance 64 {kind} step {s}: "
            f"{start.elapsed_time(end):.1f} ms (CUDA events), loss "
            f"{float(terms.total):.5f}, psnr {float(psnr):.2f}, n_dropped "
            f"{float(terms.n_dropped):g}, finite {finite}; launches "
            f"{json.dumps(launches)}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)
    log(f"[8] peak device memory over the n_importance 64 steps "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # the kernels on the inputs of a plain and a smooth step at
    # n_importance 64 (K1 and K2 at the union of the samples)
    captured = capture_train_inputs(trainer, tsmpl, titem)
    for key, e in compare_captured(captured, tag="n_importance 64 ").items():
        errs[key] = max(errs.get(key, 0.0), e)
    return out, errs


def capture_train_inputs(trainer, smpl, item):
    """The inputs of K1 and of the latent's K2 forward, backward and double
    backward as one plain and one smooth step give them (real points
    project onto clustered pixels, unlike the uniform coords of phase 2):
    K1's two calls of the plain step's last query (the 5 cm mask against
    the posed vertices, the canonical lookup against ``t_vertices``; with
    ``n_importance`` the fine pass, at the union of the samples); the
    latent's forward of each step's last query; K2's backward of the plain
    step, of the smooth step's inner normal gradients and of its outer
    backward, with the flags each asked for; the smooth step's first
    double backward with its flags.  Copied for phase 2's comparison and
    phase 7's timings."""
    import torch

    from mpsnerf_torch.ops import grid_sample as gs
    from mpsnerf_torch.ops import knn

    step = {"smooth": False}
    fwd, bwd, bwd2, nn = {}, {}, [], {}
    wrapped = {"grid_sample_patch_fwd_cuda": gs.grid_sample_patch_fwd_cuda,
               "grid_sample_patch_bwd_cuda": gs.grid_sample_patch_bwd_cuda,
               "grid_sample_patch_bwd2_cuda": gs.grid_sample_patch_bwd2_cuda}
    wrapped_knn = knn.nearest_vertex_cuda

    def keep(tensors):
        # copies with the same strides: the layouts are part of the inputs
        return [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                    device=t.device).copy_(t)
                if isinstance(t, torch.Tensor) else t for t in tensors]

    def spy_fwd(image, coords):
        if image.shape[1] > 3:
            label = "smooth step" if step["smooth"] else "plain step"
            fwd[label] = keep((image, coords))
        return wrapped["grid_sample_patch_fwd_cuda"](image, coords)

    def spy_bwd(g, image, coords, need_image, need_coords):
        need = (need_image, need_coords)
        label = ("plain step" if not step["smooth"] else
                 "smooth step" if need_image else "smooth step inner")
        if image.shape[1] > 3 and label not in bwd:
            bwd[label] = (keep((g, image, coords)), need)
        return wrapped["grid_sample_patch_bwd_cuda"](g, image, coords, *need)

    def spy_bwd2(g, image, coords, *rest):
        if image.shape[1] > 3 and not bwd2:
            bwd2.extend(keep((g, image, coords, *rest)))
        return wrapped["grid_sample_patch_bwd2_cuda"](g, image, coords, *rest)

    def spy_knn(query, verts, buckets=None, pairs=None):
        if not step["smooth"]:
            label = "train canonical" if buckets is not None else \
                "train mask"
            nn[label] = (query.clone(), verts.clone(), buckets)
        return wrapped_knn(query, verts, buckets, pairs)

    try:
        for name, spy in zip(wrapped, (spy_fwd, spy_bwd, spy_bwd2)):
            setattr(gs, name, spy)
        knn.nearest_vertex_cuda = spy_knn
        with uncounted():
            for smooth in (False, True):
                trainer.step += (-trainer.step) % 4 if smooth else \
                    (1 if trainer.step % 4 == 0 else 0)
                step["smooth"] = smooth
                trainer.view_step(smpl, item, item, trainer.step % 4)
    finally:
        for name, fn in wrapped.items():
            setattr(gs, name, fn)
        knn.nearest_vertex_cuda = wrapped_knn
    return {"fwd": fwd, "bwd": bwd, "bwd2": bwd2, "knn": nn}


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


def _bwd2_work(v, c, h, w, n, gg_image, gg_coords, need):
    """Bytes and operations of one double backward with these upstream
    gradients and flags (each input the outputs need read once, each
    output written once)."""
    need_g, need_i, need_c = need
    need_i = need_i and gg_coords
    img_b, pts_b, vcn = 4 * v * h * w * c, 4 * v * n * 2, 4 * v * c * n
    reads_corners = need_g or need_c
    nbytes = pts_b + (vcn if need_i or need_c else 0) \
        + (img_b if gg_coords and reads_corners else 0) \
        + (img_b if gg_image and reads_corners else 0) \
        + (pts_b if gg_coords else 0) + (vcn if need_g else 0) \
        + (img_b if need_i else 0) + (pts_b if need_c else 0)
    ops = v * c * n * ((7 if gg_image and need_g else 0)
                       + (17 if gg_coords and need_g else 0)
                       + (8 if need_i else 0)
                       + (18 if gg_image and need_c else 0)
                       + (5 if gg_coords and need_c else 0))
    return nbytes, ops


def _library_bwd2(g, image, coords, gg_image, gg_coords, need):
    """The yardstick of the double backward: a second ``autograd.grad``
    over a first one taken with ``create_graph`` through
    F.grid_sample(padding_mode="border", align_corners=True), with the
    same upstream gradients and flags (not the same function at the
    border)."""
    import torch
    import torch.nn.functional as F

    img = image.detach().requires_grad_(True)
    grid = coords.detach()[:, :, None, :].requires_grad_(True)
    gv = g.detach()[..., None].requires_grad_(need[0])
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    d_img, d_grid = torch.autograd.grad(out, (img, grid), gv,
                                        create_graph=True)
    outs, ups = [], []
    if gg_image is not None:
        outs.append(d_img)
        ups.append(gg_image)
    if gg_coords is not None:
        outs.append(d_grid)
        ups.append(gg_coords[:, :, None, :])
    wrt = [t for t, want in zip((gv, img, grid), need) if want]
    return lambda: torch.autograd.grad(outs, wrt, ups, retain_graph=True,
                                       allow_unused=True)


LIBRARY_BWD_NOTE = ("autograd of F.grid_sample(padding_mode='border', "
                    "align_corners=True) with the same flags: a yardstick, "
                    "not the same function at the border")
LIBRARY_BWD2_NOTE = ("a second autograd.grad over a first one taken with "
                     "create_graph through F.grid_sample(padding_mode="
                     "'border', align_corners=True), same upstream gradients "
                     "and flags: a yardstick, not the same function at the "
                     "border")


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
            n3, n_smooth = (True, True, True), (True, True, False)
            gg_l = channels_last(gg_i) if which == "latent" else gg_i
            if which == "rgb":  # the smooth step's RGB flags
                n_smooth = (True, False, False)

            def bwd2_kernel(gg=gg_l, need=n3):
                return gs.grid_sample_patch_bwd2_cuda(g, image, coords, gg,
                                                      gg_c, need)

            bwd2 = {
                "ms": cuda_ms(bwd2_kernel, 10),
                "device_ms": device_ms(bwd2_kernel, 10),
                "no_gg_image_ms": cuda_ms(
                    lambda: bwd2_kernel(None, n_smooth), 10),
                "no_gg_image_need": list(n_smooth),
                "plain_ms": cuda_ms(
                    lambda: gs.grid_sample_patch_double_backward_plain(
                        g, image, coords, gg_l, gg_c, n3), 3),
                "library_ms": maybe_ms(lambda: _library_bwd2(
                    g, image, coords, gg_l, gg_c, n3), 10),
                "library_no_gg_image_ms": maybe_ms(lambda: _library_bwd2(
                    g, image, coords, None, gg_c, n_smooth), 10),
            }
            bwd2["bound_ms"], bwd2["bound_by"] = _bound(
                *_bwd2_work(v, c, h, w, n, True, True, n3))
            bwd2["no_gg_image_bound_ms"] = _bound(
                *_bwd2_work(v, c, h, w, n, False, True, n_smooth))[0]
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
                if k.endswith(("_ms", "_us")) and val is not None
                and k not in ("ms", "plain_ms", "library_ms", "bound_ms"))
            log(f"[7] {name} {which} {tuple(shape)} x {n}: kernel "
                f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, "
                f"library {'-' if lib is None else f'{lib:.4f}'} ms, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                + (f"; {extra}" if extra else ""))
    out["grid_sample_patch_bwd"]["library_note"] = LIBRARY_BWD_NOTE
    out["grid_sample_patch_bwd2"]["library_note"] = LIBRARY_BWD2_NOTE

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
            f"{rec['ms']:.4f} ms (device {fmt(rec['device_ms'])}; both outputs "
            f"{rec['both_outputs_ms']:.4f}), "
            f"plain {rec['plain_ms']:.3f} ms, library "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms")
    out["grid_sample_patch_bwd"]["captured"] = sets
    for label in ("plain_step", "smooth_step"):
        out["grid_sample_patch_bwd"][f"{label}_inputs_ms"] = sets[label]["ms"]
    args = captured["bwd2"]
    g, image, coords, gg_image, gg_coords, need = args
    v, c, h, w = image.shape
    n = coords.shape[1]
    everything = (*args[:-1], (True, True, True))
    with uncounted():
        rec = {
            "need": list(need),
            "ms": cuda_ms(lambda: gs.grid_sample_patch_bwd2_cuda(*args), 10),
            "device_ms": device_ms(
                lambda: gs.grid_sample_patch_bwd2_cuda(*args), 10),
            "all_outputs_ms": cuda_ms(
                lambda: gs.grid_sample_patch_bwd2_cuda(*everything), 10),
            "plain_ms": cuda_ms(
                lambda: gs.grid_sample_patch_double_backward_plain(*args), 3),
            "library_ms": maybe_ms(lambda: _library_bwd2(*args), 10),
            "shape": [list(image.shape), n],
        }
    rec["bound_ms"], rec["bound_by"] = _bound(*_bwd2_work(
        v, c, h, w, n, gg_image is not None, gg_coords is not None, need))
    out["grid_sample_patch_bwd2"]["captured"] = {"smooth_step": rec}
    out["grid_sample_patch_bwd2"]["smooth_step_inputs_ms"] = rec["ms"]
    log(f"[7] grid_sample_patch_bwd2 on the smooth step's latent inputs "
        f"{tuple(image.shape)} x {n}, need {need}: kernel {rec['ms']:.4f} ms "
        f"(device {fmt(rec['device_ms'])}; all outputs "
        f"{rec['all_outputs_ms']:.4f}), plain {rec['plain_ms']:.3f} ms, "
        f"library {rec['library_ms']} ms, bound {rec['bound_ms']:.4f} ms")
    return out


def knn_times(sets, clock_mhz, per_pair):
    """K1 at each shape the path launches (and random order, and the
    streamed path): the kernel with its buckets built beforehand (as the
    path passes them), the bucket build, the bound, the pairs evaluated
    with the time the card's issue rate needs for them and for every pair,
    ``cdist`` + ``min`` and, below 1M queries, the plain version.  Returns
    {label: record}."""
    import torch

    from mpsnerf_torch.ops import knn

    rate = FP32_LANES * clock_mhz * 1e6  # fp32 instructions a second
    out = {}
    for label, (q, v, b) in sets.items():
        n, nv = q.shape[0], v.shape[0]
        if b is None:
            b = knn.build_vertex_buckets(v)
        with uncounted():
            rec = {
                "shape": [n, nv],
                "ms": cuda_ms(lambda: knn.nearest_vertex_cuda(q, v, b), 20),
                "device_ms": device_ms(
                    lambda: knn.nearest_vertex_cuda(q, v, b), 10),
                "host_us": host_us(lambda: knn.nearest_vertex_cuda(q, v, b),
                                   50),
                "build_ms": cuda_ms(lambda: knn.build_vertex_buckets(v), 10),
                "pairs": knn_pairs(q, v, b),
                "library_ms": cuda_ms(lambda: knn_library(q, v), 2),
            }
            if n < 1_000_000:
                rec["plain_ms"] = cuda_ms(lambda: knn.nearest_vertex_plain(
                    q, v, block_elems=1 << 26), 2)
        bytes_ms = (n * 12 + nv * 12 + n * 8 + n * 4) / HBM_BYTES_S * 1e3
        # the bound: what any exact 1-NN of these queries must do, whatever
        # its design: read each query and vertex once, write each result
        # once, and evaluate at least one pair (its answer) per query
        ops_ms = n * per_pair / rate * 1e3
        rec["bound_ms"] = max(bytes_ms, ops_ms)
        rec["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        # beside it, not the bound: the same rate on the pairs this design
        # evaluated, and on every pair (brute force)
        rec["pairs_bound_ms"] = max(
            bytes_ms, rec["pairs"] * per_pair / rate * 1e3)
        rec["brute_force_bound_ms"] = max(
            bytes_ms, n * nv * per_pair / rate * 1e3)
        rec["pairs_share"] = rec["pairs"] / max(1, n * nv)
        out[label.replace(" ", "_")] = rec
        log(f"[7] knn {label} {n} x {nv}: kernel {rec['ms']:.4f} ms (device "
            f"{fmt(rec['device_ms'])}; host {rec['host_us']:.1f} us a call; "
            f"bucket build {rec['build_ms']:.3f}), bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); pairs "
            f"{rec['pairs']} ({100 * rec['pairs_share']:.2f} %) at "
            f"{rec['pairs_bound_ms']:.4f} ms, brute force at "
            f"{rec['brute_force_bound_ms']:.4f} ms; cdist+min "
            f"{rec['library_ms']:.3f} ms"
            + (f", plain {rec['plain_ms']:.3f} ms" if "plain_ms" in rec
               else ""))
    return out


def maybe_ms(make, reps):
    """``cuda_ms`` of the call ``make()`` returns, or None (logged) where
    PyTorch has no such call (a yardstick only)."""
    try:
        return cuda_ms(make(), reps)
    except (RuntimeError, NotImplementedError) as e:
        log(f"[7] library call unavailable: {str(e).splitlines()[0][:160]}")
        return None


def buckets_record(v, train_launches, serving_launches, clock_mhz):
    """The bucket build's line of phase 7, on the posed rig: kernel, plain
    version and the card's bound (each vertex read once, the table and
    boxes written once; the bitonic sort's compare-exchanges, ~4
    instructions each, over the card's issue rate).  No PyTorch call
    builds the same table."""
    from mpsnerf_torch.ops import knn

    nv = v.shape[0]
    nb = -(-nv // knn.BUCKET)
    p2 = 1 << (nv - 1).bit_length()
    stages = p2.bit_length() * (p2.bit_length() - 1) // 2
    with uncounted():
        rec = {
            "name": "vertex_buckets", "route": "cuda", "source": KNN_SOURCE,
            "replaces": BUCKETS_REPLACES,
            "launches": train_launches["vertex_buckets"],
            "launches_serving": serving_launches["vertex_buckets"],
            "shape": [nv], "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: knn.build_vertex_buckets_cuda(v), 20),
            "device_ms": device_ms(lambda: knn.build_vertex_buckets_cuda(v),
                                   10),
            "host_us": host_us(lambda: knn.build_vertex_buckets_cuda(v), 50),
            "plain_ms": cuda_ms(lambda: knn.build_vertex_buckets_plain(v), 10),
            "library_ms": None,
        }
    bytes_ms = (nv * 12 + nb * knn.BUCKET * 16 + nb * 32) / HBM_BYTES_S * 1e3
    ops_ms = p2 // 2 * stages * 4 / (FP32_LANES * clock_mhz * 1e6) * 1e3
    rec["bound_ms"] = max(bytes_ms, ops_ms)
    rec["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"[7] bucket build {nv} vertices: kernel {rec['ms']:.4f} ms (device "
        f"{fmt(rec['device_ms'])}, host {rec['host_us']:.1f} us), plain "
        f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.6f} ms "
        f"({rec['bound_by']})")
    return rec


def knn_library(q, v):
    """``torch.cdist`` + ``min`` in blocks of 65,536 queries (the
    yardstick; the port never calls it)."""
    import torch

    for s in range(0, q.shape[0], 65536):
        torch.cdist(q[s:s + 65536], v).min(dim=1)


KNN_GOALS_MS = {"tail_tile": 0.05, "fine_prepass": 3.0, "train_mask": 0.12,
                "train_canonical": 0.12}


def sass_blocks(name):
    """The SASS of each kernel in the built library of ``csrc/<name>.cu``
    (``cuobjdump -sass``) as its basic blocks, each a Counter of opcodes
    (a block ends at a label and after a branch)."""
    import collections
    import os
    import re

    from mpsnerf_torch import cuda_build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(cuda_build._target(name))],
                          capture_output=True, text=True, check=True).stdout
    out, blocks = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            blocks = out[m.group(1)] = [collections.Counter()]
            continue
        if blocks is None:
            continue
        if re.match(r"\s*\.L_\w+:", line):
            blocks.append(collections.Counter())
            continue
        m = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            line)
        if m:
            op = m.group(2).split(".")[0]
            blocks[-1][op] += 1
            if op in ("BRA", "BRX", "JMP", "EXIT", "RET", "CALL", "BREAK"):
                blocks.append(collections.Counter())
    return out


def visit_loop_instructions(blocks, kernel, expected):
    """Arithmetic instructions per query-vertex pair in the pair loop of
    every instance of ``kernel``: its basic block with the most FMUL (the
    unrolled loop; 3 FMUL a pair), the PAIR_OPCODES in it over its pairs.
    Returns (the fewest over the instances, whether every instance is
    within one instruction of ``expected``, log text)."""
    counts, text = [], []
    for fn, bbs in blocks.items():
        if kernel not in fn:
            continue
        body = max(bbs, key=lambda c: c["FMUL"])
        pairs = body["FMUL"] / 3
        counts.append(sum(body[op] for op in PAIR_OPCODES) / max(pairs, 1))
        instance = fn[fn.index(kernel) + len(kernel):][:6]  # e.g. ILi4EE
        text.append(f"{instance}: {counts[-1]:.3f} a pair over {pairs:g} "
                    "pairs (" + ", ".join(f"{op} {body[op]}" for op in
                                          PAIR_OPCODES if body[op]) + ")")
    ok = bool(counts) and all(abs(c - expected) < 1 for c in counts)
    return (min(counts) if counts else None), ok, "; ".join(text)


def card_clock_mhz():
    """The card's maximum SM clock (MHz) from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0].split()[0])


def streamed_table(verts, seed):
    """A table of STREAMED_VERTS vertices (too large for the kernel's
    shared-memory copy): the rig and jittered copies of it."""
    import torch

    g = torch.Generator(device=verts.device).manual_seed(seed)
    reps = -(-STREAMED_VERTS // verts.shape[0])
    more = [verts + 0.01 * torch.randn(verts.shape, generator=g,
                                       device=verts.device)
            for _ in range(reps - 1)]
    return torch.cat([verts] + more)[:STREAMED_VERTS].contiguous()


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-after", type=int, default=9,
                    help="end after this phase (no result lines)")
    stop_after = ap.parse_args(argv).stop_after

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
    clock_mhz = card_clock_mhz()
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
        f"CUDA {torch.version.cuda}, max SM clock {clock_mhz:.0f} MHz: built "
        f"{len(sources)} sources in {time.perf_counter() - t0:.1f} s")
    instr = {}  # instructions a pair, counted: the bounds use these
    for name, kernel, expected in (
            ("nearest_vertex", "nearest_vertex_kernel", K1_INSTR_PER_PAIR),
            ("nearest_vertex_packed", "nearest_vertex_packed_kernel",
             PACKED_INSTR_PER_PAIR)):
        blocks = sass_blocks(name)
        for fn, bbs in blocks.items():
            counts = sum(bbs, collections.Counter())
            log(f"[1] SASS {fn[:60]}: {sum(counts.values())} instructions; "
                + ", ".join(f"{op} {k}" for op, k in counts.most_common(14)))
        instr[name], ok, text = visit_loop_instructions(blocks, kernel,
                                                        expected)
        log(f"[1] {kernel} pair loop: {text}; {expected} expected: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            return 1

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
    for label, v in (("rig", verts), ("1 vertex", verts[:1]),
                     ("31 vertices", verts[:31]), ("33 vertices", verts[:33]),
                     ("jittered rig (scratch sort)",
                      streamed_table(verts, 1))):
        compare_buckets(label, v.contiguous())
    knn_err, _ = compare_knn("near the vertices", q, verts)
    packed_err = compare_packed(q, verts)
    attach_body_grid(item)
    tp = to_device_input(item, dev)
    fine_q, fine_v = fine_prepass_inputs(
        smpl, tp, view_rays(item, 1, dev, item["mask_at_box_all"][1])[0],
        n_samples, tile)
    compare_buckets("posed rig (fine pre-pass)", fine_v)
    fine_b = knn.build_vertex_buckets(fine_v)
    perm = torch.randperm(fine_q.shape[0],
                          generator=torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    knn_sets = {"fine prepass": (fine_q, fine_v, fine_b),
                "random order": (fine_q[perm].contiguous(), fine_v, fine_b)}
    big_v = streamed_table(verts, 1)
    knn_sets["streamed"] = (q, big_v, knn.build_vertex_buckets(big_v))
    for label, (kq, kv, kb) in knn_sets.items():
        knn_err = max(knn_err, compare_knn(label, kq, kv, kb)[0])
    k2_errs = {which: compare_k2(which, shape, dev)
               for which, shape in TRAIN_SHAPES.items()}
    if stop_after <= 2:
        log(f"[2] stopping after phase 2 ({time.perf_counter() - t_start:.0f}"
            " s)")
        return 0

    # ---- 3. CUDA against CPU at 64^2: serving render, then training
    small = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=64,
                                  n_verts=6890)
    s_item = small.get_item(0, instance_idx=0)
    cpu_model = seeded_model("cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    ok_all = True
    for label, opts in (("global", {}),
                        ("chunked", dict(global_compact=False)),
                        ("chunked n_importance 4",
                         dict(global_compact=False, n_importance=4))):
        outs = {}
        with uncounted():
            for name, model, device in (("cpu", cpu_model, "cpu"),
                                        ("cuda", gpu_model, dev)):
                it = copy.deepcopy(s_item)
                rig = small.smpl_for(0, device=device)
                r = ViewRenderer(model, lambda g, rig=rig: rig,
                                 n_samples=n_samples, tile=4096,
                                 device=device, **opts)
                outs[name] = (r.render_view(it, it, 3), r.last_view)
        (a, sa), (b, sb) = outs["cpu"], outs["cuda"]
        px = float(np.abs(a - b).max())
        ok = (px <= 1e-4 and sa.n_dropped == sb.n_dropped
              and sa.n_body == sb.n_body and sa.hit_rays == sb.hit_rays
              and sa.n_candidates == sb.n_candidates
              and sa.n_overflow_chunks == sb.n_overflow_chunks)
        ok_all &= ok
        log(f"[3] 64^2 {label} render cuda vs cpu: max|pixel diff| {px:.3g}, "
            f"n_dropped {sb.n_dropped}/{sa.n_dropped}, candidates "
            f"{sb.n_candidates}/{sa.n_candidates}, fine n_valid {sb.n_body}/"
            f"{sa.n_body}, overflow chunks {sb.n_overflow_chunks}/"
            f"{sa.n_overflow_chunks}: {'ok' if ok else 'FAIL'}")
    if not ok_all:
        return 1
    for n_imp in (0, 4):
        compare_training(dev, n_imp)
    compare_synthetic_eval(small, cpu_model, gpu_model, dev)
    if stop_after <= 3:
        return 0

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
        # the view's time: from the request to its image on the device;
        # the host's fetch and scatter into the full image (finish_view)
        # are timed apart
        t0 = time.perf_counter()
        start.record()
        pending = renderer.render_view_async(item, item, k)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        rgb = renderer.finish_view(pending)
        finish_ms = (time.perf_counter() - t0) * 1e3
        out = renderer.last_view
        after = read_counts()
        n_launch = after["nearest_vertex"] - before["nearest_vertex"]
        n_fwd = (after["grid_sample_patch_fwd"]
                 - before["grid_sample_patch_fwd"])
        opaque = float((out.acc > 0.5).mean())
        finite = bool(np.isfinite(rgb).all())
        ok = (out.n_dropped == 0 and finite and opaque > 0.01
              and n_launch >= 2 and n_fwd >= 2
              and rgb.shape == (512 * 512, 3))
        launches.append(n_launch)
        view_ms.append(start.elapsed_time(end))
        log(f"[4] view {k}: {view_ms[-1]:.1f} ms (CUDA events), "
            f"{wall * 1e3:.1f} ms wall, then {finish_ms:.1f} ms to fetch "
            f"and scatter the image (host); hit rays {out.hit_rays}, candidates "
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
    view_launches = breakdown(renderer, smpl, item, 1, view_ms[0])
    log(f"[4] launches per served view (view 1): K1 {launches[0]}, bucket "
        f"builds {serving_launches['vertex_buckets'] // 3}, all kernels "
        f"{view_launches}")
    tail_sets, n_tiles = capture_view_knn(renderer, item, 1)
    log(f"[4] captured K1's inputs of view 1: the fine pre-pass and tail "
        f"tile {n_tiles // 2} of {n_tiles}")
    del renderer, model
    torch.cuda.empty_cache()

    # ---- 5. training at full width
    train_launches, _, captured = train_full_width(dev)
    captured["knn"] = {**tail_sets, **captured["knn"]}
    # phase 2 on the inputs phases 4 and 5 captured
    for key, e in compare_captured(captured).items():
        if key == "nearest_vertex":
            knn_err = max(knn_err, e)
        else:
            k2_errs[key[1]][key[0]] = max(k2_errs[key[1]][key[0]], e)

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
    knn_sets = {"fine prepass": knn_sets["fine prepass"],
                **captured["knn"],
                "random order": knn_sets["random order"],
                "streamed": knn_sets["streamed"]}
    shapes = knn_times(knn_sets, clock_mhz, instr["nearest_vertex"])
    for label, goal in KNN_GOALS_MS.items():
        ms = shapes[label]["ms"]
        log(f"[7] knn goal {label} <= {goal} ms: {ms:.4f} ms, "
            f"{'met' if ms <= goal else 'missed'}")
    fine = shapes["fine_prepass"]
    with uncounted():
        fine["plain_ms"] = cuda_ms(lambda: knn.nearest_vertex_plain(
            fine_q, fine_v, block_elems=1 << 26), 2)
        pq, pv = (torch.rand(2_572_288, 3, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev) * 2.4 - 1.2,
            fine_v)
        packed_library_ms = cuda_ms(lambda: knn_library(pq, pv), 2)
    records = [{
        "name": "nearest_vertex", "route": "cuda", "source": KNN_SOURCE,
        "replaces": KNN_REPLACES,
        "launches": train_launches["nearest_vertex"],
        "launches_serving": serving_launches["nearest_vertex"],
        "launches_per_view": launches, "shape": fine["shape"],
        "max_abs_err": knn_err, "ms": fine["ms"], "plain_ms": fine["plain_ms"],
        "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
        "pairs_bound_ms": fine["pairs_bound_ms"],
        "brute_force_bound_ms": fine["brute_force_bound_ms"],
        "pairs": fine["pairs"], "library_ms": fine["library_ms"],
        "instructions_per_pair": instr["nearest_vertex"],
        "clock_mhz": clock_mhz,
        "shapes": shapes,
    }]
    log(f"[7] knn at the fine pre-pass shape {fine['shape']}: kernel "
        f"{fine['ms']:.3f} ms, plain {fine['plain_ms']:.1f} ms, cdist+min "
        f"{fine['library_ms']:.1f} ms, bound {fine['bound_ms']:.4f} ms "
        f"({fine['bound_by']}); its {fine['pairs']} pairs at "
        f"{fine['pairs_bound_ms']:.3f} ms, brute force at "
        f"{fine['brute_force_bound_ms']:.3f} ms")
    records.append(buckets_record(fine_v, train_launches, serving_launches,
                                  clock_mhz))
    pn, pnv = probe["shape"]
    default = probe["variants"]["qpt4_tile1152"]
    best = min(probe["variants"].items(), key=lambda kv: kv[1]["ms"])
    rate = FP32_LANES * clock_mhz * 1e6
    p_ops = pn * pnv * instr["nearest_vertex_packed"] / rate * 1e3
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
        "instructions_per_pair": instr["nearest_vertex_packed"],
        "library_ms": packed_library_ms, "k1_ms_same_shape": probe["k1_ms"],
    })
    log(f"[7] packed knn {pn} x {pnv}: {default['ms']:.3f} ms, bound "
        f"{records[-1]['bound_ms']:.3f} ms ({instr['nearest_vertex_packed']} "
        f"instructions a pair); K1 on the same inputs {probe['k1_ms']:.3f} ms")
    for name, rec in k2_times(dev, k2_errs, captured).items():
        records.append({
            "name": name, "route": "cuda", "source": GS_SOURCE,
            "replaces": GS_REPLACES[name], "launches": train_launches[name],
            "launches_serving": serving_launches[name], **rec})
    if stop_after <= 7:
        return 0

    # ---- 8. the eval entry point at full width
    eval_launches, eval_errs = eval_full_width(dev, ds, smpl)
    for rec in records:
        for run, counts in eval_launches.items():
            rec[f"launches_{run}"] = counts[rec["name"]]
        for key, e in eval_errs.items():
            if key == rec["name"]:
                rec["max_abs_err"] = max(rec["max_abs_err"], e)
            elif key[0] == rec["name"]:
                sub = rec if key[1] == "latent" else rec["rgb"]
                sub["max_abs_err"] = max(sub["max_abs_err"], e)
    log(f"[8] total {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
