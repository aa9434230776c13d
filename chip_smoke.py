#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpsnerf_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one progress line; any failure exits non-zero):
  1. the card's name and power limit; build every CUDA kernel from
     ``mpsnerf_torch/csrc`` (one nvcc per source, all started together);
  2. the 1-NN kernel against its plain PyTorch version on the card, at
     131,072 queries x 6890 vertices and at the fine pre-pass shape of the
     full-width view (d2 to 1e-6, >= 99.9 % equal ids, every other id a tie
     in exact d2);
  3. the slice on CUDA against the same slice on the CPU at 64^2 (full
     6890-vertex rig, 3 input views, seeded weights, TF32 off): pixels to
     1e-4, n_dropped and the fine plan's n_valid exact;
  4. the slice at full width: 3 input views at 512^2, the flagship model
     with seeded weights, 128 samples per ray, ``ViewRenderer.render_view``
     for 3 requests after one warm-up view; each request must drop nothing,
     give finite pixels, accumulate opacity > 0.5 on > 1 % of the pixels
     and launch the 1-NN kernel at least twice;
  5. one ``{"kernels": [...]}`` line with the kernel's launches on the main
     path and its times at the fine pre-pass shape;
  6. the device line, last.

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


def compare_knn(q, v):
    """Kernel against plain on the same inputs; returns max |d2 diff|."""
    import torch

    from mpsnerf_torch.ops import knn

    before = knn.LAUNCHES["nearest_vertex"]
    d2_k, ids_k = knn.nearest_vertex_cuda(q, v)
    d2_p, ids_p = knn.nearest_vertex_plain(q, v, block_elems=1 << 26)
    torch.cuda.synchronize()
    knn.LAUNCHES["nearest_vertex"] = before  # comparison launches do not count
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render_view(item, item, k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernel events only (operator rows repeat their kernels)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"[4] profiled view {k}: kernels busy {busy_ms:.1f} ms of "
        f"{unprofiled_ms:.1f} ms unprofiled view time "
        f"({100 * busy_ms / unprofiled_ms:.1f} %; idle "
        f"{100 * (1 - busy_ms / unprofiled_ms):.1f} %), profiled wall "
        f"{wall_ms:.1f} ms, {len(rows)} kernel names, "
        f"{sum(e.count for e in rows)} launches")
    shown = rows[:10] + [e for e in rows[10:] if "nearest_vertex" in e.key]
    for e in shown:
        log(f"[4]   {e.self_device_time_total / 1e3:8.1f} ms "
            f"{e.count:6d} x  {e.key[:100]}")


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
    cuda_build.build_kernels(["nearest_vertex"])
    ptxas = " | ".join(
        line.strip() for line in cuda_build.BUILD_LOGS.get(
            "nearest_vertex", "").splitlines() if "registers" in line)
    log(f"[1] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}: built nearest_vertex.cu in "
        f"{time.perf_counter() - t0:.1f} s ({ptxas or 'cached'})")

    # ---- the full-width scene (host), needed for phase 2's second shape
    n_samples, tile = 128, 16384
    t0 = time.perf_counter()
    ds = SyntheticHumanDataset(n_poses=1, n_cameras=6, input_views=[0, 2, 4],
                               image_size=512, n_verts=6890)
    item = ds.get_item(0, instance_idx=0)
    smpl = ds.smpl_for(0, device=dev)
    log(f"[4] scene: 6890 verts, views 0,2,4 in, 512^2, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 2. kernel against plain
    rng = np.random.default_rng(0)
    verts = torch.from_numpy(item["vertices"]).to(dev)
    base = item["vertices"][rng.integers(0, 6890, 131072)]
    q = torch.from_numpy((base + rng.normal(size=base.shape) * 0.05)
                         .astype(np.float32)).to(dev)
    compare_knn(q, verts)
    attach_body_grid(item)
    tp = to_device_input(item, dev)
    fine_q, fine_v = fine_prepass_inputs(
        smpl, tp, view_rays(item, 1, dev)[0], n_samples, tile)
    max_err = compare_knn(fine_q, fine_v)

    # ---- 3. CUDA slice against CPU slice at 64^2
    small = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=64,
                                  n_verts=6890)
    s_item = small.get_item(0, instance_idx=0)
    cpu_model = seeded_model("cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    outs = {}
    for name, model, device in (("cpu", cpu_model, "cpu"),
                                ("cuda", gpu_model, dev)):
        it = copy.deepcopy(s_item)
        rig = small.smpl_for(0, device=device)
        r = ViewRenderer(model, lambda g, rig=rig: rig, n_samples=n_samples,
                         tile=4096, device=device)
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

    # ---- 4. full width, 3 requests
    model = seeded_model(dev)
    renderer = ViewRenderer(model, lambda g: smpl, n_samples=n_samples,
                            tile=tile, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    renderer.render_view(item, item, 1)  # warm-up (encodes the latent)
    torch.cuda.synchronize()
    log(f"[4] warm-up view in {time.perf_counter() - t0:.2f} s")
    knn.LAUNCHES["nearest_vertex"] = 0
    launches, view_ms = [], []
    for k in (1, 3, 5):
        before = knn.LAUNCHES["nearest_vertex"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = renderer.render_view(item, item, k)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = knn.LAUNCHES["nearest_vertex"] - before
        opaque = float((out.acc > 0.5).float().mean())
        finite = bool(torch.isfinite(out.rgb).all())
        ok = (out.n_dropped == 0 and finite and opaque > 0.01
              and n_launch >= 2 and out.rgb.shape == (512 * 512, 3))
        launches.append(n_launch)
        view_ms.append(start.elapsed_time(end))
        log(f"[4] view {k}: {view_ms[-1]:.1f} ms (CUDA events), "
            f"{wall * 1e3:.1f} ms wall; hit rays {out.hit_rays}, candidates "
            f"{out.n_candidates}, capacity {out.capacity}, body points "
            f"{out.n_body}, fine capacity {out.fine_capacity}, knn launches "
            f"{n_launch}, n_dropped {out.n_dropped}, acc>0.5 on "
            f"{100 * opaque:.1f} % of pixels, finite {finite}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            return 1
    total_launches = knn.LAUNCHES["nearest_vertex"]
    log(f"[4] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean view "
        f"{sum(view_ms) / len(view_ms):.1f} ms")
    breakdown(renderer, smpl, item, 1, view_ms[0])

    # ---- 5. kernel times at the fine pre-pass shape
    n, nv = fine_q.shape[0], fine_v.shape[0]
    ms = cuda_ms(lambda: knn.nearest_vertex_cuda(fine_q, fine_v), 10)
    plain_ms = cuda_ms(
        lambda: knn.nearest_vertex_plain(fine_q, fine_v, block_elems=1 << 26),
        2)

    def library():
        for s in range(0, n, 65536):
            torch.cdist(fine_q[s:s + 65536], fine_v).min(dim=1)

    library_ms = cuda_ms(library, 2)
    knn.LAUNCHES["nearest_vertex"] = total_launches
    ops_ms = n * nv * OPS_PER_PAIR / FLOPS_FP32 * 1e3
    bytes_ms = (n * 12 + nv * 12 + n * 8 + n * 4) / HBM_BYTES_S * 1e3
    record = {
        "name": "nearest_vertex", "route": "cuda", "source": KNN_SOURCE,
        "replaces": KNN_REPLACES, "launches": total_launches,
        "launches_per_view": launches, "shape": [n, nv],
        "max_abs_err": max_err, "ms": ms, "kernel_ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }
    log(f"[5] knn at the fine pre-pass shape {n} x {nv}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms, cdist+min {library_ms:.1f} ms, bound "
        f"{record['bound_ms']:.3f} ms; total {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
