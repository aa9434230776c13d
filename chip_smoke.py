#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpsnerf_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints progress lines ending in ok/FAIL; any failure exits
non-zero):
  1. the card's name and power limit, and whether PIL imports (the
     loaders' JPEG decoder; PNG needs none); build every CUDA kernel from
     ``mpsnerf_torch/csrc`` (one nvcc per source, all started together);
     count the 1-NN kernels' instructions per pair in their SASS (fails
     where they differ from what the bounds assume);
  2. every kernel against its plain PyTorch version on the card: K1's
     bucket build on the rig, the posed rig, 1, 31, 33, 8192, 8193,
     16,384, 16,385 and 20,000 vertices, and on tables whose vertices are
     all equal, lie on a plane or (all but two) in one Morton cell, at
     6890 and 16,385 vertices (table and boxes bit-equal); the exact 1-NN
     (K1, bucketed and culled) at 131,072 x 6890, at the fine
     pre-pass shape of the full-width view, on those queries in random
     order, and on a 20,000-vertex table (the streamed path): ids 100 %
     equal and d2 bit-equal; the packed-key 1-NN at 131,072 x 6890 (ids
     100 % equal); the patch grid-sample K2 forward (1e-6), backward (at
     each pair of need_image/need_coords) and double backward (each output
     to 1e-5 of its max |value|; with a gg image in both layouts and
     without one) at the training shapes, latent 3x128x128x128
     (channels-last as the encoder gives it, with g in both layouts, and
     (V, C, H, W)-contiguous, which the wrappers copy per call) and RGB
     3x3x512x512 at 64,512 points; once phases 4 and 5 have captured
     them, K1 on a served view's tail tile and on a plain step's two
     calls (ids and d2 equal; the pairs the kernel evaluated beside the
     plain emulation's), and K2's backward and double backward on a plain
     and a smooth step's real latent inputs (and the flags those steps
     asked for); the LayerNorm kernel against its plain version at a
     served tail tile's rows (49,152 and 32,768 x 155) and at a few rows
     of widths 155, 128 and 37 (each output to 1e-6 of its max |value|);
  3. CUDA against CPU at 64^2 (full 6890-vertex rig, seeded weights, TF32
     off): the serving render, the chunked path and the chunked path at
     ``n_importance`` 4 (pixels 1e-4, counts exact), one plain and one
     smooth training loss at ``n_importance`` 0 and 4 (perturb 0, the same
     injected smooth delta): loss terms 1e-4, each parameter gradient to
     1e-3 of its tensor's max |grad|; ``run_synthetic_eval`` (every
     per-image metric to 1e-4 relative);
  4. serving at full width: 3 input views at 512^2, the flagship model
     with seeded weights, 128 samples per ray, ``ViewRenderer``: one
     warm-up view, whose encoded latent must be channels-last and which
     captures the tail's CUDA graphs (its LayerNorm launches must be the
     first tile's eager run's and the capture's, 4 each, and every tail
     tile replayed); then 3 requests (``render_view_async``, then
     ``finish_view``), each of which must drop nothing, give finite
     pixels, accumulate opacity > 0.5 on > 1 % of the pixels, launch K1
     at least twice and K2 forward, replay every tail tile and launch no
     LayerNorm; K1's and the LayerNorm's launches per view;
  5. training at full width: ``Trainer.train_item`` on two items of the
     synthetic train split (3 input views at 512^2, 4 output views, 1000
     rays per view-step, 128 samples, perturb 1), 8 view-steps of which 2
     smooth; every step must drop nothing, give finite loss terms and
     change the parameters, and every kernel of the path must launch;
  6. the 1-NN variant probe (``mpsnerf_torch.tools.knn_variant_probe``) at
     2,572,288 x 6890;
  7. kernel times: each kernel's times against its bound, the plain
     version and a library call; for K1 every shape the path launches
     (``shapes``: the fine pre-pass, a tail tile, the plain step's mask and
     canonical calls, random order, the streamed path) with its bound
     (what any exact 1-NN must do: the bytes, and one pair per query), the
     pairs it evaluated and the time the card needs for those and for
     every pair (the instructions a pair counted in phase 1's SASS, over
     132 SMs x 128 lanes x the card's maximum SM clock); for the bucket
     build on the posed rig its bytes-only bound, the launch floor (a
     one-element torch op), ``torch.sort`` of its keys as a yardstick and
     the SM cycles of its phases; for K2 also the
     RGB, the other image layout, and the backward and double backward on
     each captured set beside the yardstick of autograd through
     ``F.grid_sample`` (not the same function at the border); for the
     LayerNorm its call and device times at a served tail tile's two row
     counts against its bytes bound, its plain version and
     ``F.layer_norm`` (none of its launches on the train step);
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
  9. the training CLI at full width: a THuman-layout fixture in a
     temporary directory (24 ring cameras with distortion, the 6890-vertex
     synthetic rig posed and rendered, images and masks as PNG by the
     port's writer, ``annots.npy``, ``new_vertices/``, ``new_params/``,
     ``X_vertices.npy``, ``data/THuman_1_human_list.txt`` whose 25
     training names are all the 512^2 subject and whose name 25 is a 256^2
     held-out one); ``run_nerf_batch_torch.main`` with
     ``configs/canonical_transformer.txt`` and ``--batch_size 1`` for 3
     items with the loader's 4 threads (checkpoints every 24 view-steps),
     then with ``--resume_optimizer 1`` for one more, then with
     ``--num_worker 0`` (items loaded in the loop) for two more; every
     view-step timed by CUDA events (one synchronisation a step) with
     finite terms and nothing dropped, parameters that change between
     checkpoints, the resumed step and Adam state equal to the
     checkpoint's (and fresh after a resume without the flag), the files
     under the JAX CLI's names, K1 and K2 launched; the host loader's ms
     per train item alone; ``run_thuman_eval`` on the saved weights cut to 1
     held-out human, 1 pose a pass, 256^2 (16 images: finite metrics, 34
     files); then phase 2's comparisons on a plain and a smooth step of
     this path;
  10. every option and variant of the model at full width, through
     ``factory.return_model`` on the flagship config with ``--model`` and
     the flags: (a) one smooth and one plain ``Trainer.view_step`` on phase
     5's 512^2 scene for each of ``coarse_batch``, ``direct_deform``,
     ``correction_batch``, ``correction_batch_blend``, and
     ``skinning_batch`` with ``correction_field``, ``skinning_field``,
     ``with_viewdirs``, ``human_sample 0``, ``mean_shape``, ``use_trans 0``,
     ``append_rgb 0``, ``compute_dtype bfloat16`` and the aggregate field in
     pair mode (a second pose as the source): step times by CUDA events,
     launches, finite losses, nothing dropped, the fields' parameters moved
     (the pair steps' image term 0 across poses), the 3D encoder's first
     call against a CPU copy on the same inputs (running statistics 1e-5);
     the host's ``build_plan`` time; (b) one served view each with
     ``correction_batch`` (512^2, global path), bf16 (512^2, pixels within
     1/255 of fp32's on the same weights) and ``human_sample 0`` (128^2,
     the chunked path over every ray): ms to the image on the device after
     a warm-up render; (c) ``run_nerf_batch_torch.main`` on the shipped
     ``configs/h36m.txt`` (``--batch_size 1``, items loaded in the loop
     from a generator seeded so that the first item pairs two poses) for 2
     pair items over a 1000^2 H36M-layout
     fixture written to a temporary directory and linked at the config's
     subject paths (a cross-pose item's image term 0, ``img_raw`` > 0),
     then ``run_h36m_eval`` at 256^2 (1 pose a pass); (d) phase 2's
     comparisons on what (a) gave the kernels: K1 on the aggregate field's
     and the pair variant's plain-step calls (pair mode's coarse-point 1-NN
     among them), K2 forward, K2 backward with the coordinate gradient on
     the latent and the RGB, the double backward of a smooth step with a
     deform field; K2's backward timed at the plain step's latent and RGB
     inputs beside autograd of ``F.grid_sample``;
  11. the numpy-era models and the legacy eval at full width: (a) one
     plain and one smooth ``Trainer.view_step`` on phase 5's 512^2 scene
     (the canonical sparse-conv plans attached) for each of
     ``correction_by_f3d``, ``correction_by_f3d_fagg`` (``--use_f2d 1``),
     ``correction_by_uvh_agg`` and ``correction_by_uvh_agg_fagg`` through
     ``factory.return_model`` on the flagship config, the trainer at step
     3: times by CUDA events, launches, finite terms, nothing dropped,
     both correction fields moved, the smooth step's Jacobian terms
     non-zero (``CorrectionF3D``; zero for ``CorrectionUvhAgg``, which
     has none); (b) one served view of ``correction_by_f3d_fagg`` at
     256^2 through ``ViewRenderer`` on the chunked path: ms to the image,
     finite pixels, the acc > 0.5 share; (c)
     ``run_nerf_batch_torch.main`` with ``--model correction_by_f3d_fagg
     --use_f2d 1 --data_set_type THuman_B_R`` on phase 9's THuman-layout
     fixture (15 pose entries): one item trained (24 view-steps, the
     canonical plans attached by the CLI, a checkpoint), then
     ``--save_weights 0 --image_scaling 0.5``, which reloads it:
     ``run_legacy_test``'s PSNR file, PNGs and both AVIs, each AVI's RIFF
     header and index parsed for its frame count and size (its first MJPG
     frame decoded by PIL), seconds per image; (d) phase 2's comparisons
     on what the kernels were given by ``correction_by_f3d_fagg``'s plain
     steps in (a) and in (c)'s training, and by the first chunk of (b)'s
     view and of (c)'s first eval view (524,288 and 1,536,000 points, the
     window samples on a (3,128,64,64) latent): K1 on the query's three
     calls, K2's forward on the 25 shifted window coordinates (some
     beyond the border) and the refined source points, and on the steps
     K2's backward with the coordinate gradient there and each window
     sample's backward;
  12. geometry and serving at full width (the flagship widths, phase 4's
     serving scene, the 6890-vertex rig): (a) ``extract_thuman_mesh_torch
     .main`` on the flagship config over a 512^2 THuman-layout fixture (24
     cameras, the seeded weights saved as its checkpoint) at ``--mesh_N``
     256, in the target frame and with ``--can_flag 1``: ms of the density
     queries, the K1 mask, the K=5 carve and marching cubes, vertex and
     triangle counts, ``n_dropped``, the vertices finite and inside the grid
     box; (b) ``render_thuman_mesh_torch.main`` on the two OBJ files (one
     camera, 512^2: the phase's depth cut): the RGBA PNGs decode, coverage
     > 0; (c)
     ``MeshAnimationRenderer`` baked at (a)'s canonical mesh, ``render_pose``
     at 512^2 from the item's 3 cameras, fast and full: ms, hit pixels,
     sample points, finite pixels; (d) a port bundle of the seeded model
     (exported with ``shard_devices`` 2) served by ``BundleServer`` on
     127.0.0.1, port 0, in this process:
     /healthz, /manifest, /render?view=1 (equal to
     ``ViewRenderer.render_view`` within 1e-5), /camera at view 1's camera
     (equal to /render within 1e-5), /spiral (4 frames at 256^2, with and
     without ``format=video``: the AVI's index read back), /mesh?n=128 (its
     triangle count equal to a direct ``extract_density_mesh`` on the
     bundle's model), /animate?view=1 full and fast; then the sharded
     requests: /render?view=1&sharded=1 (its first starts 2 ranks that
     share the card over gloo), again with the ranks' counts set to 0,
     and /camera at view 1's camera with ``sharded=1``, each within 1e-5
     of the unsharded /render and of /render with ``global=0`` (the
     unsharded chunked path); the ranks' summed ``n_dropped``, the
     overflow blocks, the ranks' K1/K2 launches, K1 and K2's forward
     against their plain versions on rank 0's first query of the counted
     request, and no rank alive after ``BundleServer.stop()``; each
     request's wall ms with HTTP; (e) phase 2's comparisons on what (a)-(d)
     gave the kernels:
     K1 and K2's forward on the middle query chunk of each extraction, on
     the first chunk of the bake and of the animation samples, on the
     first served /spiral frame's fine pre-pass and first tail tile and on
     the served /mesh's middle query chunk, and K1 on a
     2,097,152-point slice of the 256^3 grid's mask call (ids and d2
     equal), with K1 timed on the whole grid (ms, pairs, bound) beside
     ``cdist`` + ``min`` in blocks of 65,536 queries over the whole grid;
  13. multi-device training and the sharded render (``mpsnerf_torch/
     parallel``): (a) 4 ranks spawned on the card (``parallel/launch.py``)
     over gloo (they share it), a (data 2, ray 2) mesh, the flagship
     widths and the 6890-vertex rig, two items of phase 5's 512^2 scene
     (one a data row, their 1000 rays a view in the loader's body-first
     order, 500 a rank by stride), 128 samples; after a warm-up pair, one
     plain and one smooth ``MeshTrainer`` step from the seeded weights with
     injected jitter and smooth deltas, against single-process references
     computed in this process on ray shards sliced here: the loss within
     1e-5 of the item mean (plain) and the shard mean (smooth), the
     reduced gradients within 1e-5 of max|g| of the mean over the same
     ray shards (the plain item mean's gradient gap and this process's
     repeat logged beside them), terms equal on every rank, parameters
     bit-equal across the ranks after each step, TF32 off, ``n_dropped``
     0; ms per step by each rank's CUDA events and the share of its
     gradient all-reduce; (d) the same ranks render view 1 of phase 4's
     item (its 132,024 mask-at-box rays in scan order) sharded 4 ways with
     ``make_sharded_render``'s compact path: pixels within 1e-5 of the
     single-process ``render_rays_compact``, every rank's ``n_dropped`` 0,
     ms by each rank's CUDA events; (e) phase 2's comparisons on rank 0's
     captured inputs of (a)'s plain and smooth step and of (d)'s first
     tail tile; (c) ``run_nerf_batch_torch.main`` on the flagship config
     as shipped (``batch_size 2``) with ``--mesh_devices 2`` over phase
     9's fixture for 2 batch steps: the CLI starts 2 ranks (gloo), both
     take 48 view-steps, finite logs, rank 0 alone writes the 2
     checkpoints and one scalar row a batch step, s per batch step; (b) a
     one-rank NCCL group on the card runs item 0's plain step through
     ``make_batched_train_step`` and an ``all_reduce``, equal to the
     single-process step;
  14. the jax-free tools (``mpsnerf_torch/tools``): (a)
     ``validate_dataset`` on phase 9's 512^2 THuman fixture (exit 0, its
     10 checks PASS) and on a copy with one mask removed (exit 1, naming
     the file); (b) ``train_proof``, ``generalization_proof`` and
     ``pair_train_proof`` on the card at a smoke size (2 items at 64^2,
     the 6890-vertex rig) into a temporary directory: finite losses, the
     JAX proofs' JSON keys, K1 and K2 (forward and backward) launched;
  then one ``{"kernels": [...]}`` line: each kernel's record from phase 7
     with its launches on each path (``launches``: phase 5;
     ``launches_serving``: phase 4's 3 requests, and the LayerNorm's
     ``launches_capture_view``: its warm-up view; ``launches_eval``,
     ``launches_hier_plain``, ``launches_hier_smooth``: phase 8;
     ``launches_cli``, ``launches_cli_eval``: phase 9;
     ``launches_variants``, ``launches_variant_views``,
     ``launches_h36m_cli``, ``launches_h36m_eval``: phase 10;
     ``launches_legacy``, ``launches_legacy_view``,
     ``launches_legacy_cli``, ``launches_legacy_eval``: phase 11;
     ``launches_mesh``, ``launches_animate``, ``launches_serve``,
     ``launches_sharded_serve`` (summed over its 2 ranks): phase 12;
     ``launches_multi_device``, ``launches_sharded_render``: phase 13
     (a) and (d), summed over the 4 ranks; ``launches_tools``: phase 14
     (b)), K2's backward record
     ``variant_plain_step`` (phase 10 (d)'s times) and K1's
     ``shapes["mesh_grid"]`` (phase 12 (e));
  15. the device line, last.

Launches are counted by kernel from outside the port: ``launch_spy``
wraps ``cuda_build.launch``, through which every hand-written kernel goes
on the stream, in this process and in every rank it spawns.  A CUDA
graph's replay makes no host call, so a replayed LayerNorm is not
counted; ``TileGraphs.graph_tiles`` shows the replays.  The counts are set
to 0 just before each path (phases 4, 5, 6, 8, 9, 10, 11, 12, 14, and in
every rank of phase 13 and of 12 (d)'s sharded request) and read just
after; launches made to compare or time a kernel do not count.
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

# the card's peaks and the kernels' bytes and operations, as the
# benchmark counts them (an image counts the pixels a launch touches)
from benchmark.harness.work import (
    FLOPS_FP32, HBM_BYTES_S, bound_s, k2_bwd2_work, k2_bwd_work, k2_fwd_work,
    touched_pixels,
)

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

LN_SOURCE = "mpsnerf_torch/csrc/layer_norm.cu"
LN_REPLACES = ("none: mpsnerf_tpu/models/transformer.py leaves the "
               "LayerNorm to XLA")
LN_ROWS = {"tile_3_views": 3 * 16384, "tile_2_views": 2 * 16384}
LN_WIDTH = 155  # the transformer's rows in both shipped configs
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


def bound_ms(nbytes, ops):
    """The benchmark's bound (``bound_s``) in ms, and what sets it: the
    bytes or the operations."""
    by = "bytes" if nbytes / HBM_BYTES_S >= ops / FLOPS_FP32 else "operations"
    return bound_s(nbytes, ops) * 1e3, by


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


# launches by kernel (its C symbol without "mpsnerf_") while a
# ``launch_spy`` is entered in this process
COUNTS = collections.Counter()
COUNTED = KERNEL_NAMES + ("layer_norm",)


class launch_spy:
    """While entered, wraps ``cuda_build.launch`` (every hand-written
    kernel goes on the stream through it) and counts each launch in
    ``COUNTS``.  Entered for the whole run and in every spawned rank."""

    def __enter__(self):
        from mpsnerf_torch import cuda_build

        self.module, self.launch = cuda_build, cuda_build.launch

        def counted(name, symbol, *args):
            self.launch(name, symbol, *args)
            COUNTS[symbol.removeprefix("mpsnerf_")] += 1

        cuda_build.launch = counted
        return self

    def __exit__(self, *exc):
        self.module.launch = self.launch


def reset_counts():
    COUNTS.clear()


def read_counts():
    return {k: COUNTS[k] for k in COUNTED}


class uncounted:
    """Launches inside the block (comparisons, timings) leave the counts
    as they were."""

    def __enter__(self):
        self.saved = COUNTS.copy()

    def __exit__(self, *exc):
        COUNTS.clear()
        COUNTS.update(self.saved)


def fail(msg):
    log(msg)
    raise SystemExit(1)


def bucket_tables(verts):
    """Phase 2's tables for the bucket build: the rig, 1, 31 and 33
    vertices (one run, short), 8192 and 8193 (the last full warp run and
    one more; the edge between the merge in shared memory and in the
    scratch), 16,384 and 16,385 (a power of two and one more), the
    20,000-vertex streamed table, and degenerate tables (every vertex
    equal, one flat axis, all but two vertices in one Morton cell, so the
    cell's order goes by id, and one axis of zeros of both signs), at 6890
    and in the scratch at 16,385.  ``torch.equal`` holds -0 equal to +0:
    the kernel orders -0 below +0 in a box, the plain ``amin``/``amax``
    return either."""
    import torch

    big = streamed_table(verts, 1)
    tables = [("rig", verts), ("1 vertex", verts[:1]),
              ("31 vertices", verts[:31]), ("33 vertices", verts[:33])]
    tables += [(f"{n} vertices", big[:n])
               for n in (8192, 8193, 16384, 16385)]
    tables.append(("jittered rig (scratch)", big))
    g = torch.Generator(device=verts.device).manual_seed(2)
    for n in (6890, 16385):
        flat = big[:n].clone()
        flat[:, 1] = 0.5
        zeros = big[:n].clone()
        zeros[:, 1] = 0.0
        zeros[::2, 1] = -0.0
        cell = 0.1234 + 1e-6 * torch.rand(n, 3, generator=g,
                                          device=verts.device)
        cell[0], cell[-1] = -1.0, 1.0
        tables += [(f"{n} equal vertices", verts[:1].expand(n, 3)),
                   (f"{n} vertices on a plane", flat),
                   (f"{n} vertices in one Morton cell", cell),
                   (f"{n} vertices on signed zeros", zeros)]
    return tables


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
    ``torch.equal`` (bit-equal, but for the sign of a zero box bound)."""
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


def layer_norm_inputs(rows, d, seed, dev):
    """Rows with an offset and a spread each, as the transformer's residual
    stream has, and an affine weight and bias."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = (3.0 * torch.randn(rows, d, generator=g, device=dev)
         + torch.randn(rows, 1, generator=g, device=dev))
    w = 1.0 + 0.5 * torch.randn(d, generator=g, device=dev)
    b = 0.5 * torch.randn(d, generator=g, device=dev)
    return x, w, b


def compare_layer_norm(dev):
    """Phase 2: the LayerNorm kernel against its plain version; returns
    the worst absolute error."""
    import torch

    from mpsnerf_torch.ops.layer_norm import layer_norm_cuda, layer_norm_plain

    cases = [(rows, LN_WIDTH) for rows in LN_ROWS.values()]
    cases += [(1, LN_WIDTH), (3, 128), (1000, 37)]
    ok, worst, parts = True, 0.0, []
    with uncounted(), torch.no_grad():
        for rows, d in cases:
            x, w, b = layer_norm_inputs(rows, d, rows + d, dev)
            out = layer_norm_cuda(x, w, b, 1e-5)
            ref = layer_norm_plain(x, w, b, 1e-5)
            rel = _rel(out, ref)
            ok &= rel <= 1e-6
            worst = max(worst, float((out - ref).abs().max()))
            parts.append(f"{rows} x {d} {rel:.2g}")
    log(f"[2] layer_norm against plain, max|diff| / max|plain|: "
        f"{', '.join(parts)} (1e-6): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)
    return worst


def layer_norm_record(dev, err, train_launches, serving_launches,
                      per_view, warm_up):
    """Phase 7: the LayerNorm kernel's record, timed at a served tail
    tile's two row counts (its 3 views' rows, and the last layer's 2).
    A replayed view launches none: ``warm_up`` counts the capturing
    view's, the first tile's eager run and the capture."""
    import torch
    import torch.nn.functional as F

    from mpsnerf_torch.ops.layer_norm import layer_norm_cuda, layer_norm_plain

    shapes = {}
    with uncounted(), torch.no_grad():
        for label, rows in LN_ROWS.items():
            x, w, b = layer_norm_inputs(rows, LN_WIDTH, rows, dev)
            bound, by = bound_ms((2 * rows * LN_WIDTH + 2 * LN_WIDTH) * 4,
                                 8 * rows * LN_WIDTH)
            kernel = lambda: layer_norm_cuda(x, w, b, 1e-5)  # noqa: E731
            dev_ms = device_ms(kernel, 200)
            shapes[label] = {
                "shape": [rows, LN_WIDTH], "ms": cuda_ms(kernel, 200),
                "device_ms": dev_ms,
                "plain_ms": cuda_ms(
                    lambda: layer_norm_plain(x, w, b, 1e-5), 50),
                "library_ms": cuda_ms(lambda: F.layer_norm(
                    x, (LN_WIDTH,), w, b, 1e-5), 200),
                "bound_ms": bound, "bound_by": by,
                "roofline_pct": None if dev_ms is None
                else 100 * bound / dev_ms}
            r = shapes[label]
            log(f"[7] layer_norm {rows} x {LN_WIDTH}: {r['ms']:.4f} ms a "
                f"call, device {fmt(r['device_ms'])} ms, bound "
                f"{bound:.4f} ms ({by}; {fmt(r['roofline_pct'], '.1f')} % "
                f"of the device time), plain {r['plain_ms']:.4f} ms, "
                f"F.layer_norm {r['library_ms']:.4f} ms")
    ok = train_launches["layer_norm"] == 0
    log(f"[7] layer_norm launches: train path {train_launches['layer_norm']}"
        f" (0: autograd records it), the capturing view {warm_up}, served "
        f"views {per_view} (replayed): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)
    main = shapes["tile_3_views"]
    return {
        "name": "layer_norm", "route": "cuda", "source": LN_SOURCE,
        "replaces": LN_REPLACES, "launches": train_launches["layer_norm"],
        "launches_serving": serving_launches["layer_norm"],
        "launches_per_view": per_view, "launches_capture_view": warm_up,
        "max_abs_err": err, **main, "shapes": shapes}


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
    (V, C, H, W)-contiguous copy too (the wrappers copy that one); g in
    both layouts.  Returns the max abs error of each kernel."""
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
        ok &= outside
        ok_all &= ok
        for kname, e in (("grid_sample_patch_fwd", f_err),
                         ("grid_sample_patch_bwd", b_err),
                         ("grid_sample_patch_bwd2", b2_err)):
            err[kname] = max(err[kname], e)
        log(f"[2] K2 {name} {tuple(shape)} ({label}) at {TRAIN_POINTS} "
            f"points: fwd max|diff| {f_err:.3g}; relative to max: {b_text}; "
            f"bwd2 {b2_text}; coordinate gradient beyond the border nonzero "
            f"{outside}: {'ok' if ok else 'FAIL'}")
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
    """Phase 5; returns the launches on the main path and the captured K1
    and K2 inputs of a plain and a smooth step."""
    import math

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
    reset_counts()
    logs = []
    for item in items:
        trainer.train_item(smpl, item, item)
        logs += trainer.last_logs
    launches = read_counts()
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
    main_ok = ok and all(
        launches[k] > 0 for k in KERNEL_NAMES if k != "nearest_vertex_packed")
    log(f"[5] 8 view-steps ({n_smooth} smooth); launches "
        f"{json.dumps(launches)}: {'ok' if main_ok else 'FAIL'}")
    if not main_ok:
        raise SystemExit(1)
    return launches, capture_train_inputs(trainer, smpl, items[1])


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


class train_capture:
    """Inside the block, keeps copies of the inputs of K1 and of the
    latent's K2 forward, backward and double backward as a plain and a
    smooth step give them (set ``.smooth`` before each step): K1's two
    calls of the plain step's last query (the 5 cm mask against the posed
    vertices, the canonical lookup against ``t_vertices``); the latent's
    forward of each step's last query; K2's backward of the plain step, of
    the smooth step's inner normal gradients and of its outer backward,
    with the flags each asked for; the smooth step's first double backward
    with its flags.  The launches go on to the kernels.  :meth:`result`
    gives them in ``compare_captured``'s form."""

    NAMES = ("grid_sample_patch_fwd_cuda", "grid_sample_patch_bwd_cuda",
             "grid_sample_patch_bwd2_cuda")

    def __init__(self):
        self.smooth = False
        self.fwd, self.bwd, self.bwd2, self.nn = {}, {}, [], {}

    def __enter__(self):
        import torch

        from mpsnerf_torch.ops import grid_sample as gs
        from mpsnerf_torch.ops import knn

        wrapped = {name: getattr(gs, name) for name in self.NAMES}
        wrapped_knn = knn.nearest_vertex_cuda
        self.restore = [(gs, n, f) for n, f in wrapped.items()] + [
            (knn, "nearest_vertex_cuda", wrapped_knn)]

        def keep(tensors):
            # copies with the same strides: the layouts are part of the
            # inputs
            return [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                        device=t.device).copy_(t)
                    if isinstance(t, torch.Tensor) else t for t in tensors]

        def spy_fwd(image, coords):
            label = "smooth step" if self.smooth else "plain step"
            if image.shape[1] > 3:
                self.fwd[label] = keep((image, coords))
            elif not self.smooth:
                self.fwd["plain step rgb"] = keep((image, coords))
            return wrapped["grid_sample_patch_fwd_cuda"](image, coords)

        def spy_bwd(g, image, coords, need_image, need_coords):
            need = (need_image, need_coords)
            label = ("plain step" if not self.smooth else
                     "smooth step" if need_image else "smooth step inner")
            if image.shape[1] > 3 and label not in self.bwd:
                self.bwd[label] = (keep((g, image, coords)), need)
            return wrapped["grid_sample_patch_bwd_cuda"](g, image, coords,
                                                         *need)

        def spy_bwd2(g, image, coords, *rest):
            if image.shape[1] > 3 and not self.bwd2:
                self.bwd2.extend(keep((g, image, coords, *rest)))
            return wrapped["grid_sample_patch_bwd2_cuda"](g, image, coords,
                                                          *rest)

        def spy_knn(query, verts, buckets=None, pairs=None):
            if not self.smooth:
                label = "train canonical" if buckets is not None else \
                    "train mask"
                self.nn[label] = (query.clone(), verts.clone(), buckets)
            return wrapped_knn(query, verts, buckets, pairs)

        for name, spy in zip(self.NAMES, (spy_fwd, spy_bwd, spy_bwd2)):
            setattr(gs, name, spy)
        knn.nearest_vertex_cuda = spy_knn
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.restore:
            setattr(mod, name, fn)

    def result(self):
        return {"fwd": self.fwd, "bwd": self.bwd, "bwd2": self.bwd2,
                "knn": self.nn}


def capture_train_inputs(trainer, smpl, item, tp=None):
    """The inputs of K1 and of the latent's K2 calls (``train_capture``)
    as one plain and one smooth step on ``item`` (a pair step's source,
    with ``tp`` its target) give them (real points project onto clustered
    pixels, unlike the uniform coords of phase 2); with ``n_importance``
    K1's calls are the fine pass's, at the union of the samples.  Copied
    for phase 2's comparison and phase 7's timings."""
    with train_capture() as cap, uncounted():
        for smooth in (False, True):
            trainer.step += (-trainer.step) % 4 if smooth else \
                (1 if trainer.step % 4 == 0 else 0)
            cap.smooth = smooth
            trainer.view_step(smpl, item, item if tp is None else tp,
                              trainer.step % 4)
    return cap.result()


# ---- phase 9: the CLI on a THuman-layout fixture ---------------------------

THUMAN_D = [-0.11, 0.05, 0.0006, -0.0004, -0.008]  # (k1, k2, p1, p2, k3)


def write_thuman_subject(root, size, n_frames, frame_of_pose, n_verts):
    """A THuman-layout subject rendered from the synthetic scene (24 ring
    cameras, the ``n_verts``-vertex rig of seed 0, the gender-0 rig of
    ``load_smpl_models``): ``annots.npy`` with distortion, per frame the
    24 images and masks as PNG (the port's writer), ``new_vertices/`` and
    ``new_params/``, and ``X_vertices.npy``.  Pose entry p of ``annots``
    shows frame ``frame_of_pose(p)``."""
    import os

    import numpy as np

    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.eval.protocol import encode_png, to8b

    ds = SyntheticHumanDataset(n_poses=n_frames, n_cameras=24,
                               input_views=list(range(24)), image_size=size,
                               n_verts=n_verts, split="train", n_rays=8)
    for sub in ("new_vertices", "new_params"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for f in range(n_frames):
        item = ds.get_item(f, instance_idx=0)
        for v in range(24):
            for sub, img in (("", np.transpose(item["img_all"][v], (1, 2, 0))),
                             ("mask_cihp", item["msk_all"][v] > 0)):
                path = os.path.join(root, sub, f"{v:02d}", f"{f}.png")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(encode_png(to8b(img.astype(np.float32))))
        np.save(os.path.join(root, "new_vertices", f"{f}.npy"),
                item["vertices"])
        np.save(os.path.join(root, "new_params", f"{f}.npy"),
                dict(item["params"]))
        if f == 0:
            np.save(os.path.join(root, "X_vertices.npy"), item["t_vertices"])
    cams = {"K": [c[0] for c in ds.cameras],
            "D": [np.array(THUMAN_D) for _ in ds.cameras],
            "R": [c[1] for c in ds.cameras], "T": [c[2] for c in ds.cameras]}
    n_poses = 1 + max(frame_of_pose.keys())
    ims = [{"ims": [f"{v:02d}/{frame_of_pose.get(p, 0)}.png"
                    for v in range(24)]} for p in range(n_poses)]
    np.save(os.path.join(root, "annots.npy"), {"cams": cams, "ims": ims})


def write_thuman_fixture(tmp, size, n_verts, eval_size=None):
    """Phase 9's fixture under ``tmp``: a training subject at ``size``^2
    with 2 frames under 20 pose entries (the config's poses_num), with
    ``eval_size`` a held-out subject (its start pose 20 and the next, and
    pose 0), and ``data/THuman_1_human_list.txt`` whose first 25 names are
    the training subject and name 25 the held-out one.  Returns the
    training subject's root (the CLI's ``--data_root``)."""
    import os

    root = os.path.join(tmp, "thuman")
    train_root = os.path.join(root, "fixture_train_F")
    write_thuman_subject(train_root, size, 2, {p: p % 2 for p in range(20)},
                         n_verts)
    if eval_size:
        write_thuman_subject(os.path.join(root, "fixture_eval_F"), eval_size,
                             3, {0: 0, 20: 1, 21: 2}, n_verts)
    os.makedirs(os.path.join(tmp, "data"))
    with open(os.path.join(tmp, "data", "THuman_1_human_list.txt"),
              "w") as f:
        f.write("fixture_train_F\n" * 25 + "fixture_eval_F\n")
    return train_root


class step_timer:
    """Times every ``Trainer.view_step`` by CUDA events (one
    synchronisation a step) and keeps its flags and terms."""

    def __init__(self, sync=True):
        self.records, self.sync = [], sync

    def __enter__(self):
        import torch

        from mpsnerf_torch.train.trainer import Trainer

        self.orig = Trainer.view_step
        timer = self

        def timed(trainer, *a, **k):
            smooth = trainer.smooth_now()
            if timer.sync:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            terms, psnr = timer.orig(trainer, *a, **k)
            if timer.sync:
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
            else:
                ms = (time.perf_counter() - t0) * 1e3
            timer.records.append({"smooth": smooth, "ms": ms,
                                  "terms": terms, "psnr": psnr})
            return terms, psnr

        Trainer.view_step = timed
        return self

    def __exit__(self, *exc):
        from mpsnerf_torch.train.trainer import Trainer

        Trainer.view_step = self.orig


def _adam_equal(saved, live):
    """The optimizer state dicts hold the same step counts and moments."""
    import torch

    if saved["state"].keys() != live["state"].keys():
        return False
    return all(torch.equal(torch.as_tensor(a[k]).cpu(),
                           torch.as_tensor(live["state"][i][k]).cpu())
               for i, a in saved["state"].items() for k in a)


def cli_on_the_card(dev, size=512, eval_size=256, n_verts=6890,
                    overrides=()):
    """Phase 9: ``run_nerf_batch_torch.main`` on the flagship config
    (``--batch_size 1``) over a THuman-layout fixture, then a resume with
    ``--resume_optimizer``, then one with the items loaded in the loop,
    then ``run_thuman_eval`` on the weights it saved; then K1 and K2
    against their plain versions on a train step of this path.  Returns
    the launches of the three CLI runs (``cli``) and of
    the eval (``cli_eval``) and the kernels' worst errors.  ``size``,
    ``eval_size`` and ``overrides`` (more CLI flags) shrink it for a
    rehearsal on the CPU."""
    import math
    import os
    import pathlib
    import tempfile

    import numpy as np
    import torch

    import run_nerf_batch_torch
    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.eval import runner
    from mpsnerf_torch.factory import return_dataset, return_model
    from mpsnerf_torch.smpl.assets import load_smpl_models
    from mpsnerf_torch.train.trainer import Trainer

    on_card = torch.device(dev).type == "cuda"
    config = pathlib.Path(__file__).resolve().parent / "configs"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="mpsnerf_cli_") as tmp:
        t0 = time.perf_counter()
        train_root = write_thuman_fixture(tmp, size, n_verts, eval_size)
        log(f"[9] THuman-layout fixture: 24 cameras with distortion "
            f"{THUMAN_D}, train subject {size}^2 x 2 frames, held-out "
            f"subject {eval_size}^2 x 3 frames, {n_verts}-vertex rig, PNG; "
            f"written in {time.perf_counter() - t0:.1f} s")
        base = os.path.join(tmp, "logs")
        argv = ["--config", str(config / "canonical_transformer.txt"),
                "--data_root", train_root, "--batch_size", "1",
                "--basedir", base, "--i_print", "24", "--i_weights", "24",
                "--i_testset", "1000000", "--device", str(dev),
                *overrides]
        try:
            os.chdir(tmp)  # the loaders read data/ from the working dir
            restores = []
            orig_restore = Trainer.restore

            def spy_restore(trainer, state, load_optimizer=False):
                orig_restore(trainer, state, load_optimizer)
                restores.append(dict(
                    step=trainer.step, load=load_optimizer,
                    adam=copy.deepcopy(trainer.optimizer.state_dict())))

            if on_card:
                torch.cuda.synchronize()
            reset_counts()
            runs, timers = [], []
            Trainer.restore = spy_restore
            try:
                # 3 items with the loader's 4 threads; a resume with Adam's
                # state for 1; 2 items loaded in the loop (no threads)
                for extra in (["--N_iteration", "71"],
                              ["--N_iteration", "95",
                               "--resume_optimizer", "1"],
                              ["--N_iteration", "143", "--num_worker", "0"]):
                    t1 = time.perf_counter()
                    with step_timer(on_card) as timer:
                        runs.append(run_nerf_batch_torch.main(argv + extra))
                    timers.append(timer)
                    wall = time.perf_counter() - t1
                    run = runs[-1]
                    line = []
                    for kind in (False, True):
                        # each run's first step (lazy set-up) left out
                        ms = [r["ms"] for r in timer.records[1:]
                              if r["smooth"] == kind]
                        line.append(
                            f"{'smooth' if kind else 'plain'} mean "
                            f"{sum(ms) / len(ms):.1f} ms (min {min(ms):.1f}, "
                            f"max {max(ms):.1f}, {len(ms)})")
                    log(f"[9] CLI {' '.join(extra)}: steps {run.start_step} "
                        f"-> {run.trainer.global_step} in {wall:.1f} s wall "
                        f"({run.args.num_worker} workers -> "
                        f"{min(run.args.num_worker, 4)} loader threads); "
                        f"view-steps ({'CUDA events' if on_card else 'wall'})"
                        f": {', '.join(line)}")
            finally:
                Trainer.restore = orig_restore
            cli_launches = read_counts()
            exp = runs[0].args.expname
            ckpts = os.path.join(base, exp, "checkpoints")
            saved = {s: torch.load(os.path.join(ckpts, s),
                                   map_location="cpu", weights_only=True)
                     for s in sorted(os.listdir(ckpts))}
            args = runs[0].args
            torch.manual_seed(args.seed)
            init = return_model(args).state_dict()

            # every step: finite terms, nothing dropped; 6 smooth an item
            records = [r for t in timers for r in t.records]
            finite = all(math.isfinite(float(x)) for r in records
                         for x in r["terms"])
            dropped = max(float(r["terms"].n_dropped) for r in records)
            n_smooth = sum(r["smooth"] for r in records)
            item_dropped = max(lg["n_dropped"] for run in runs
                               for lg in run.logs)

            def changed(a, b):
                return float(np.mean([not torch.equal(a[k], b[k])
                                      for k in a]))

            states = [init] + [saved[k]["model"] for k in sorted(saved)]
            moved = [changed(a, b) for a, b in zip(states, states[1:])]
            adam_ok = (len(restores) == 2 and restores[0]["step"] == 72
                       and restores[0]["load"]
                       and _adam_equal(saved["000072"]["optimizer"],
                                       restores[0]["adam"])
                       and restores[1]["step"] == 96
                       and not restores[1]["load"]
                       and restores[1]["adam"]["state"] == {})
            need = [k for k in KERNEL_NAMES if k != "nearest_vertex_packed"]
            launched = all(cli_launches[k] > 0 for k in need)
            ok = (finite and dropped == 0 and item_dropped == 0
                  and len(records) == 144 and n_smooth == 36
                  and [r.start_step for r in runs] == [0, 72, 96]
                  and runs[2].trainer.global_step == 144
                  and sorted(saved) == [f"{24 * i:06d}" for i in range(1, 7)]
                  and min(moved) > 0.9 and adam_ok and launched
                  and os.path.exists(os.path.join(base, exp, "args.txt"))
                  and os.path.exists(os.path.join(
                      base, "summaries", exp, "scalars.jsonl")))
            losses = [round(lg["loss"], 5) for run in runs for lg in run.logs]
            log(f"[9] item losses {losses}, psnr "
                f"{[round(lg['psnr'], 2) for run in runs for lg in run.logs]}"
                f"; n_dropped {dropped:g} (items {item_dropped:g}); finite "
                f"{finite}; {n_smooth} of {len(records)} steps smooth; "
                f"parameter tensors changed between checkpoints (from the "
                f"seeded init) {[round(100 * m) for m in moved]} %; "
                f"checkpoints {sorted(saved)}; resumed at step "
                f"{[r['step'] for r in restores]}, with Adam equal to the "
                f"saved and then fresh {adam_ok}; launches "
                f"{json.dumps(cli_launches)}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(1)

            # the host loader alone: a train item at the config's shapes
            ds = return_dataset(args)
            t1 = time.perf_counter()
            for i in range(2):
                item = ds[i]
            loader_ms = (time.perf_counter() - t1) / 2 * 1e3
            log(f"[9] host loader: {loader_ms:.0f} ms per THuman train "
                f"item ({size}^2 x 24 views, {args.N_rand} rays a view, "
                f"undistort and rays in numpy), one thread")

            # the eval protocol on the saved weights, cut to 1 held-out
            # human (the list's name 25), 1 pose a pass, eval_size^2
            smpl_models = load_smpl_models(device=dev)
            savedir = os.path.join(base, exp, "testset_000144")
            reset_counts()
            t1 = time.perf_counter()
            metric = runner.run_thuman_eval(
                args, runs[-1].trainer.model, lambda g: smpl_models[g],
                savedir, verbose=False, poses_num=1, image_hw=eval_size,
                device=dev)
            if on_card:
                torch.cuda.synchronize()
            eval_s = time.perf_counter() - t1
            eval_launches = read_counts()
            files = sorted(os.path.relpath(os.path.join(d, f), savedir)
                           for d, _, fs in os.walk(savedir) for f in fs)
            n_img = 2 * len(runner.THUMAN_NOVEL_VIEWS)
            finite = all(np.isfinite(np.asarray(metric[k])).all() for k in (
                "novel_view_psnr", "novel_view_ssim", "novel_pose_psnr",
                "novel_pose_ssim"))
            want = {"metrics.json", "metrics.npy",
                    "novel_pose/fixture_eval_F/frame0021_view0001.png",
                    "novel_view/fixture_eval_F/frame0000_view0023_gt.png"}
            ok = (finite and want <= set(files) and len(files) == 2 * n_img
                  + 2 and all(eval_launches[k] > 0 for k in (
                      "nearest_vertex", "vertex_buckets",
                      "grid_sample_patch_fwd")))
            log(f"[9] run_thuman_eval (1 human, 1 pose a pass, "
                f"{eval_size}^2, {n_img} images): {eval_s:.1f} s, "
                f"{eval_s / n_img * 1e3:.0f} ms per image (items, render, "
                f"metrics, PNGs); psnr novel view "
                f"{np.round(metric['novel_view_psnr'], 3).tolist()}, novel "
                f"pose {np.round(metric['novel_pose_psnr'], 3).tolist()}; "
                f"{len(files)} files; launches {json.dumps(eval_launches)}: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(1)

            # K1 and K2 on a plain and a smooth step of this path
            host = ds[0]
            captured = capture_train_inputs(
                runs[-1].trainer, smpl_models[int(host["gender"])],
                to_device_input(host, dev, rays=True))
            errs = compare_captured(captured, tag="CLI ")
        finally:
            os.chdir(cwd)
    return {"cli": cli_launches, "cli_eval": eval_launches}, errs


# ---- phase 10: every option and variant; the shipped H36M config ---------

# (label, --model, flag overrides): the variants and flags of phase 10
VARIANTS = (
    ("coarse_batch", "coarse_batch", {}),
    ("direct_deform", "direct_deform", {}),
    ("correction_batch", "correction_batch", {}),
    ("correction_batch_blend", "correction_batch_blend", {}),
    ("correction_field", "skinning_batch", {"correction_field": 1}),
    ("skinning_field", "skinning_batch", {"skinning_field": 1}),
    ("with_viewdirs", "skinning_batch", {"with_viewdirs": 1}),
    ("human_sample 0", "skinning_batch", {"human_sample": 0}),
    ("mean_shape", "skinning_batch", {"mean_shape": 1}),
    ("use_trans 0", "skinning_batch", {"use_trans": 0}),
    ("append_rgb 0", "skinning_batch", {"append_rgb": 0}),
    ("bfloat16", "skinning_batch", {"compute_dtype": "bfloat16"}),
    ("pair correction_field", "skinning_batch",
     {"correction_field": 1, "data_set_type": "H36M_P"}),
)
FIELDS = ("forward_deform", "backward_correction", "backward_deform",
          "encoder_3d", "latent_codes")


def variant_model(model, over, device):
    """``factory.return_model`` on the flagship config with ``--model``
    and the flags ``over`` (name -> value), weights from seed 0, density
    bias +4 (so that a random model's rays are not all empty).  Returns
    (model, args)."""
    import pathlib

    import torch

    from mpsnerf_torch.config import parse_args
    from mpsnerf_torch.factory import return_model

    config = pathlib.Path(__file__).resolve().parent / "configs"
    argv = ["--config", str(config / "canonical_transformer.txt"),
            "--model", model]
    for k, v in over.items():
        argv += [f"--{k}", str(v)]
    args = parse_args(argv)
    torch.manual_seed(0)
    m = return_model(args)
    with torch.no_grad():
        m.alpha_linear.bias.fill_(4.0)
    return m.to(device), args


class kernel_spy:
    """Keeps the inputs of every K1 and K2 launch in the block (copies with
    their strides) as ``(stage, wrapper, args)``; ``stage`` is set by the
    caller.  The launches go on to the kernels."""

    NAMES = ("grid_sample_patch_fwd_cuda", "grid_sample_patch_bwd_cuda",
             "grid_sample_patch_bwd2_cuda")

    def __init__(self):
        self.calls, self.stage = [], None

    def __enter__(self):
        import torch

        from mpsnerf_torch.ops import grid_sample as gs
        from mpsnerf_torch.ops import knn

        self.saved = [(gs, n, getattr(gs, n)) for n in self.NAMES] + [
            (knn, "nearest_vertex_cuda", knn.nearest_vertex_cuda)]

        def keep(t):
            if not isinstance(t, torch.Tensor):
                return t
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device=t.device).copy_(t)

        for mod, name, fn in self.saved:
            def spy(*a, _fn=fn, _name=name, **k):
                if self.stage is not None:
                    self.calls.append((self.stage, _name,
                                       tuple(keep(x) for x in a)))
                return _fn(*a, **k)
            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def encoder_3d_against_cpu(model, step):
    """Runs ``step`` with hooks on the 3D encoder's first call: its inputs,
    its state before and its running statistics after; then the same call
    on a CPU copy of the encoder in train mode.  Returns the worst
    difference of the running statistics and of the features."""
    import torch

    from mpsnerf_torch.models.sparse_conv import SparseConvPlan

    enc, seen = model.encoder_3d, {}

    def pre(module, args):
        if "args" not in seen:
            seen["args"] = [a.detach().clone() if isinstance(
                a, torch.Tensor) else a for a in args]
            seen["before"] = copy.deepcopy(module.state_dict())

    def post(module, args, out):
        if "after" not in seen:
            seen["after"] = {k: v.detach().clone()
                             for k, v in module.state_dict().items()}
            seen["out"] = out.detach().clone()

    hooks = (enc.register_forward_pre_hook(pre),
             enc.register_forward_hook(post))
    try:
        step()
    finally:
        for h in hooks:
            h.remove()
    cpu = copy.deepcopy(enc).cpu().train()
    cpu.load_state_dict({k: v.cpu() for k, v in seen["before"].items()})
    feats, plan, coords = seen["args"]
    plan = SparseConvPlan(*(x.cpu() if isinstance(x, torch.Tensor) else x
                            for x in plan))
    with torch.no_grad():
        out = cpu(feats.cpu(), plan, coords.cpu())
    stats = max(float((cpu.state_dict()[k] - v.cpu()).abs().max())
                for k, v in seen["after"].items() if "running" in k)
    feat = float((out - seen["out"].cpu()).abs().max()) / max(
        float(out.abs().max()), 1e-30)
    return stats, feat


def train_variants(dev, size=512, n_verts=6890, n_rays=1000,
                   n_samples=128):
    """Phase 10 (a): one plain and one smooth ``Trainer.view_step`` of each
    variant at full width on phase 5's 512^2 scene (a second pose as the
    source of the pair variant); K1/K2 inputs captured on the aggregate
    correction field's and the pair variant's steps.  The sizes shrink it
    for a rehearsal on the CPU."""
    import math

    import torch

    from mpsnerf_torch.data import attach_spconv_plan, to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    ds = SyntheticHumanDataset(n_poses=2, n_cameras=4, image_size=size,
                               n_verts=n_verts, split="train", n_rays=n_rays)
    smpl = ds.smpl_for(0, device=dev)
    host = [attach_spconv_plan(ds.get_item(p, instance_idx=0))
            for p in range(2)]
    t1 = time.perf_counter()
    attach_spconv_plan(host[0])
    plan_ms = (time.perf_counter() - t1) * 1e3
    items = [to_device_input(h, dev, rays=True) for h in host]
    log(f"[10] variant scene: phase 5's, 2 poses, sparse-conv plans; built "
        f"in {time.perf_counter() - t0:.1f} s; build_plan {plan_ms:.1f} ms "
        f"per item on the host ({n_verts} vertices, "
        f"{int(host[0]['spconv_plan'].n_coarse)} coarse sites)")
    # an untimed step in fp32 and in bf16 first (the products' first
    # calls pick and load their kernels)
    for over in ({}, {"compute_dtype": "bfloat16"}):
        warm = Trainer(variant_model("skinning_batch", over, dev)[0],
                       TrainConfig(n_samples=n_samples), device=dev,
                       start_step=1)
        warm.view_step(smpl, items[1], items[1], 0)
    del warm
    torch.cuda.synchronize()
    reset_counts()
    spy, results, bn = kernel_spy(), {}, None
    with spy:
        for label, name, over in VARIANTS:
            model, args = variant_model(name, over, dev)
            pair = args.data_set_type in ("H36M_P", "THuman_P")
            # steps 3 (plain) and 4 (smooth): the zero-init output layers
            # of the correction fields move in the first, so the second
            # carries a gradient into the rest of the field and the 3D
            # encoder
            trainer = Trainer(model, TrainConfig(n_samples=n_samples,
                                                 pair_mode=pair),
                              device=dev, start_step=3, seed=0)
            sp, tp = (items[0], items[1]) if pair else (items[1], items[1])
            fields = {n: p.detach().clone()
                      for n, p in model.named_parameters()
                      if n.split(".")[0] in FIELDS}
            recs = []
            for _ in range(2):
                smooth = trainer.smooth_now()
                capture = label in ("correction_field",
                                    "pair correction_field")
                spy.stage = (f"{label} {'smooth' if smooth else 'plain'}"
                             if capture else None)
                counts0 = read_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)

                def step():
                    start.record()
                    out = trainer.view_step(smpl, sp, tp, trainer.step % 4)
                    end.record()
                    return out

                if label == "correction_field" and not smooth:
                    box = []
                    bn = encoder_3d_against_cpu(
                        model, lambda: box.append(step()))
                    terms, _ = box[0]
                else:
                    terms, _ = step()
                torch.cuda.synchronize()
                counts1 = read_counts()
                recs.append({"smooth": smooth, "ms": start.elapsed_time(end),
                             "terms": terms,
                             "launches": {k: counts1[k] - counts0[k]
                                          for k in KERNEL_NAMES}})
            spy.stage = None
            moved = {n: bool((p.detach() != fields[n]).any())
                     for n, p in model.named_parameters() if n in fields}
            owners = sorted({n.split(".")[0] for n in fields})
            moved_by = {o: any(v for n, v in moved.items()
                               if n.split(".")[0] == o) for o in owners}
            finite = all(math.isfinite(float(x)) for r in recs
                         for x in r["terms"])
            dropped = max(float(r["terms"].n_dropped) for r in recs)
            want_fields = (("forward_deform" in moved_by)
                           == bool(over.get("correction_field")
                                   or name == "correction_batch")
                           and ("backward_deform" in moved_by)
                           == bool(over.get("skinning_field")))
            # every field and the 3D encoder moved (the codes too)
            gate = True
            if pair:
                gate = all(float(r["terms"].img) == 0.0
                           < float(r["terms"].img_raw) for r in recs)
            ok = (finite and dropped == 0 and all(moved_by.values())
                  and want_fields and gate)
            results[label] = recs
            log(f"[10] {label}: plain {recs[0]['ms']:.1f} ms, smooth "
                f"{recs[1]['ms']:.1f} ms (CUDA events); loss "
                f"{float(recs[0]['terms'].total):.5f} / "
                f"{float(recs[1]['terms'].total):.5f}, img "
                f"{float(recs[0]['terms'].img):.5f} (raw "
                f"{float(recs[0]['terms'].img_raw):.5f}); moved "
                f"{moved_by}; launches plain "
                f"{json.dumps(recs[0]['launches'])}, smooth "
                f"{json.dumps(recs[1]['launches'])}: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(1)
            del trainer, model
            torch.cuda.empty_cache()
    launches = read_counts()
    stats_err, feat_err = bn
    ok = stats_err <= 1e-5 and feat_err <= 1e-4
    log(f"[10] the 3D encoder's first call of the correction field's plain "
        f"step, CUDA against a CPU copy on the same inputs (train mode): "
        f"running statistics max|diff| {stats_err:.3g}, features "
        f"{feat_err:.3g} of their max: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)
    return launches, results, spy.calls


def variant_views(dev, item, smpl, size=512, small=128, n_samples=128):
    """Phase 10 (b): one served 512^2 view with ``correction_batch`` and
    with bf16 (its pixels within 1/255 of fp32's, the same weights), one
    128^2 view with ``human_sample`` 0 (the chunked path over every ray):
    ms to the image on the device (CUDA events around
    ``render_view_async``) after a warm-up render."""
    import numpy as np
    import torch

    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.eval.runner import ViewRenderer

    def fresh(it):
        return {k: v for k, v in it.items() if not k.startswith("_")}

    sds = SyntheticHumanDataset(n_poses=1, n_cameras=6,
                                input_views=[0, 2, 4], image_size=small,
                                n_verts=item["vertices"].shape[0])
    s_item = sds.get_item(0, instance_idx=0)
    s_smpl = sds.smpl_for(0, device=dev)
    # the fp32 reference of the bf16 view: its pixels only
    model, _ = variant_model("skinning_batch", {}, dev)
    view = fresh(item)
    with uncounted():
        fp32 = ViewRenderer(model, lambda g: smpl, n_samples=n_samples,
                            tile=16384, device=dev).render_view(view, view, 1)
    del model
    reset_counts()
    out, images = {}, {}
    for label, name, over, it, rig, hw in (
            ("correction_batch", "correction_batch", {}, item, smpl, size),
            ("bfloat16", "skinning_batch", {"compute_dtype": "bfloat16"},
             item, smpl, size),
            ("human_sample 0", "skinning_batch", {"human_sample": 0},
             s_item, s_smpl, small)):
        model, _ = variant_model(name, over, dev)
        r = ViewRenderer(model, lambda g, rig=rig: rig, n_samples=n_samples,
                         tile=16384, device=dev)
        view = fresh(it)
        with uncounted():  # the warm-up: the latent, the plans
            r.render_view(view, view, 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pending = r.render_view_async(view, view, 1)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        rgb = r.finish_view(pending)
        stats = r.last_view
        images[label] = rgb
        ok = (np.isfinite(rgb).all() and rgb.shape == (hw * hw, 3)
              and stats.n_dropped == 0 and float((stats.acc > 0.5).mean())
              > 0.01 and r.global_compact == (label != "human_sample 0"))
        out[label] = {"ms": ms, "global_path": r.global_compact,
                      "hit_rays": stats.hit_rays}
        path = "global" if r.global_compact else "chunked"
        log(f"[10] {label} view 1 at {hw}^2: {ms:.1f} ms to the image "
            f"(CUDA events), {path} path, "
            f"{stats.hit_rays} rays run, overflow chunks "
            f"{stats.n_overflow_chunks}, acc>0.5 on "
            f"{100 * float((stats.acc > 0.5).mean()):.1f} %: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)
        del r, model
        torch.cuda.empty_cache()
    px = float(np.abs(images["bfloat16"] - fp32).max())
    ok = px < 1.0 / 255.0
    log(f"[10] bf16 against fp32 on the same weights, view 1 at {size}^2: "
        f"max|pixel diff| {px:.3g} (bound 1/255 = {1 / 255:.4f}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)
    return read_counts(), out


def write_h36m_subject(root, size, n_frames, n_entries, n_verts):
    """An H36M-layout subject from the synthetic scene: 4 ring cameras with
    distortion, the gender-2 (neutral) rig of ``load_smpl_models``, per
    frame the 4 images and masks as PNG (``Camera_B{v}/{f:06d}.png``,
    ``mask_cihp/``), ``new_vertices/``, ``new_params/`` (Rh axis-angle),
    ``45_big_pose_tvertices.npy``; ``annots.npy`` with translations in
    millimetres and ``n_entries`` pose entries, entry e showing frame
    ``(e // 10) % n_frames``."""
    import os

    import numpy as np

    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.eval.protocol import encode_png, to8b

    ds = SyntheticHumanDataset(n_poses=n_frames, n_cameras=4,
                               input_views=list(range(4)), image_size=size,
                               n_verts=n_verts, seed=2, split="train",
                               n_rays=8)
    for sub in ("new_vertices", "new_params"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for f in range(n_frames):
        item = ds.get_item(f, instance_idx=0)
        for v in range(4):
            rel = os.path.join(f"Camera_B{v + 1}", f"{f:06d}.png")
            for sub, img in (("", np.transpose(item["img_all"][v], (1, 2, 0))),
                             ("mask_cihp", item["msk_all"][v] > 0)):
                path = os.path.join(root, sub, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(encode_png(to8b(img.astype(np.float32))))
        np.save(os.path.join(root, "new_vertices", f"{f}.npy"),
                item["vertices"])
        p = item["params"]
        np.save(os.path.join(root, "new_params", f"{f}.npy"), {
            "Rh": np.zeros(3, np.float32),  # R = I in the synthetic scene
            "Th": np.asarray(p["Th"]), "poses": np.asarray(p["poses"]),
            "shapes": np.asarray(p["shapes"])})
        if f == 0:
            np.save(os.path.join(root, "45_big_pose_tvertices.npy"),
                    item["t_vertices"])
    cams = {"K": [c[0] for c in ds.cameras],
            "D": [np.array(THUMAN_D) for _ in ds.cameras],
            "R": [c[1] for c in ds.cameras],
            "T": [np.asarray(c[2]) * 1000.0 for c in ds.cameras]}
    ims = [{"ims": [f"Camera_B{v + 1}/{(e // 10) % n_frames:06d}.png"
                    for v in range(4)]} for e in range(n_entries)]
    np.save(os.path.join(root, "annots.npy"), {"cams": cams, "ims": ims})


def crossing_seed(ds, loader_seed):
    """The first generator seed whose first pair item pairs two poses: the
    draws of ``data.thuman.pose_pair`` (the subject, the coin, the partner
    pose) for the first index of a ``PrefetchLoader`` seeded with
    ``loader_seed``.  The run checks that it did."""
    import numpy as np

    from mpsnerf_torch.data.prefetch import PrefetchLoader

    loader = PrefetchLoader(range(len(ds)), seed=loader_seed, num_workers=0)
    sp = next(loader) % ds.ni
    loader.close()
    lo, hi = max(0, sp - ds.border), min(ds.ni - 1, sp + ds.border)
    for seed in range(1000):
        rng = np.random.default_rng(seed)
        if ds.multi_person:
            rng.integers(len(ds.root_list))
        if rng.uniform() >= 0.5 and int(rng.integers(lo, hi + 1)) != sp:
            return seed
    raise AssertionError("no seed pairs two poses")


def h36m_cli_on_the_card(dev, size=1000, eval_size=256, n_verts=6890,
                         n_items=2, overrides=()):
    """Phase 10 (c): ``run_nerf_batch_torch.main`` on the shipped
    ``configs/h36m.txt`` (``--batch_size 1``, the items loaded in the loop
    from a generator seeded so that the first pairs two poses) over a
    ``size``^2 H36M-layout fixture linked
    at the config's subject paths, then ``run_h36m_eval`` at
    ``eval_size``^2 (the tables cut to one pose a pass).  Returns the
    launches of both and the worst errors of K1 and K2 against their plain
    versions on a cross-pose item's plain and smooth step."""
    import math
    import os
    import pathlib
    import tempfile

    import numpy as np
    import torch

    import run_nerf_batch_torch
    from mpsnerf_torch import factory
    from mpsnerf_torch.data.h36m import H36MDatasetBatch
    from mpsnerf_torch.eval import runner
    from mpsnerf_torch.smpl.assets import load_smpl_models
    from mpsnerf_torch.train.trainer import Trainer

    on_card = torch.device(dev).type == "cuda"
    config = pathlib.Path(__file__).resolve().parent / "configs" / "h36m.txt"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="mpsnerf_h36m_") as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "fixture", "Posing")
        write_h36m_subject(root, size, 3, 1000, n_verts)
        for sub in ("H36M/S1", "h36m/S1", "h36m/S5", "h36m/S6", "h36m/S7",
                    "h36m/S9"):
            os.makedirs(os.path.join(tmp, "data", sub))
            os.symlink(root, os.path.join(tmp, "data", sub, "Posing"))
        log(f"[10] H36M-layout fixture: 4 cameras with distortion, {size}^2 "
            f"x 3 frames, 1000 pose entries, {n_verts}-vertex neutral rig, "
            f"PNG, linked at the config's 6 subject paths; written in "
            f"{time.perf_counter() - t0:.1f} s")
        make, orig_item = factory.return_dataset, Trainer.train_item
        pairs, crossing = [], []

        def seeded(args, *a, **k):
            ds = make(args, *a, **k)
            ds.rng = np.random.default_rng(crossing_seed(ds, args.seed))
            return ds

        def spy_item(trainer, smpl, sp, tp):
            pairs.append((int(sp["pose_index"]), int(tp["pose_index"])))
            if pairs[-1][0] != pairs[-1][1] and not crossing:
                crossing.extend((smpl, sp, tp))  # for K1/K2 below
            return orig_item(trainer, smpl, sp, tp)

        argv = ["--config", str(config), "--batch_size", "1", "--basedir",
                os.path.join(tmp, "logs"), "--i_print", "4", "--i_weights",
                "4", "--i_testset", "1000000", "--num_worker", "0",
                "--N_iteration", str(4 * n_items - 1), "--device", str(dev),
                *overrides]
        try:
            os.chdir(tmp)
            factory.return_dataset, Trainer.train_item = seeded, spy_item
            if on_card:
                torch.cuda.synchronize()
            reset_counts()
            t1 = time.perf_counter()
            with step_timer(on_card) as timer:
                run = run_nerf_batch_torch.main(argv)
            wall = time.perf_counter() - t1
            cli_launches = read_counts()
        finally:
            factory.return_dataset, Trainer.train_item = make, orig_item
            os.chdir(cwd)
        recs = timer.records
        finite = all(math.isfinite(float(x)) for r in recs
                     for x in r["terms"])
        gated = all(
            (float(r["terms"].img) == float(r["terms"].img_raw)) == (s == t)
            and float(r["terms"].img_raw) > 0
            for r, (s, t) in zip(recs, [p for p in pairs for _ in range(4)]))
        cross = sum(s != t for s, t in pairs)
        ms = {kind: [r["ms"] for r in recs[1:] if r["smooth"] == kind]
              for kind in (False, True)}
        ok = (finite and gated and pairs[0][0] != pairs[0][1]
              and len(recs) == 4 * n_items
              and run.trainer.cfg.pair_mode and all(
                  lg["n_dropped"] == 0 for lg in run.logs)
              and all(cli_launches[k] > 0 for k in (
                  "nearest_vertex", "vertex_buckets",
                  "grid_sample_patch_fwd", "grid_sample_patch_bwd",
                  "grid_sample_patch_bwd2")))
        log(f"[10] CLI configs/h36m.txt --batch_size 1: {len(recs)} view-"
            f"steps in {wall:.1f} s wall ({n_items} pair items, "
            f"(source, target) poses {pairs}, {cross} across poses); "
            f"view-steps ({'CUDA events' if on_card else 'wall'}) plain "
            f"{[round(x, 1) for x in ms[False]]}, smooth "
            f"{[round(x, 1) for x in ms[True]]} ms; item losses "
            f"{[round(lg['loss'], 5) for lg in run.logs]}; the image term "
            f"0 exactly across poses, img_raw > 0: {gated}; launches "
            f"{json.dumps(cli_launches)}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)

        # the eval protocol at eval_size^2 (the loader resizes every image
        # to 1000^2, then scales it), the tables cut to one pose a pass
        scale = eval_size / 1000.0

        class Scaled(H36MDatasetBatch):
            def __init__(self, *a, **k):
                super().__init__(*a, image_scaling=scale, **k)

        tables = {"H36M_POSES_NUM": [1], "H36M_NOVEL_VIEW_POSES_NUM": [1],
                  "H36M_INPUT_POSE": [0], "H36M_START_POSE": [20]}
        saved_tables = {k: getattr(runner, k) for k in tables}
        savedir = os.path.join(tmp, "logs", "eval")
        try:
            os.chdir(tmp)
            for k, v in tables.items():
                setattr(runner, k, v)
            smpl_models = load_smpl_models(device=dev)
            reset_counts()
            t1 = time.perf_counter()
            metric = runner.run_h36m_eval(
                run.args, run.trainer.model, lambda g: smpl_models[g],
                savedir, dataset_cls=Scaled, verbose=False,
                image_hw=eval_size, device=dev)
            if on_card:
                torch.cuda.synchronize()
            eval_s = time.perf_counter() - t1
            eval_launches = read_counts()
        finally:
            for k, v in saved_tables.items():
                setattr(runner, k, v)
            os.chdir(cwd)
        files = sorted(os.path.relpath(os.path.join(d, f), savedir)
                       for d, _, fs in os.walk(savedir) for f in fs)
        finite = all(np.isfinite(np.asarray(metric[k])).all() for k in (
            "novel_view_psnr", "novel_view_ssim", "novel_pose_psnr",
            "novel_pose_ssim"))
        ok = finite and "metrics.json" in files and eval_launches[
            "grid_sample_patch_fwd"] > 0
        log(f"[10] run_h36m_eval at {eval_size}^2 (1 pose a pass, masked "
            f"rays): {eval_s:.1f} s; psnr novel view "
            f"{np.round(metric['novel_view_psnr'], 3).tolist()}, novel pose "
            f"{np.round(metric['novel_pose_psnr'], 3).tolist()}, ssim "
            f"{np.round(metric['novel_view_ssim'], 4).tolist()} / "
            f"{np.round(metric['novel_pose_ssim'], 4).tolist()}; finite "
            f"{finite}; {len(files)} files; launches "
            f"{json.dumps(eval_launches)}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)

    # K1 and K2 on a plain and a smooth step of a cross-pose pair item at
    # this path's shapes (the 1000^2 RGB, the 250^2 latent)
    captured = capture_train_inputs(run.trainer, *crossing)
    errs = compare_captured(captured, tag="H36M CLI ")
    return {"h36m_cli": cli_launches, "h36m_eval": eval_launches}, errs


def compare_variant_inputs(calls):
    """Phase 2's comparisons on what the variant steps gave the kernels:
    K1 on each call of the aggregate field's and the pair variant's plain
    steps (the pair step's coarse-point 1-NN among them); K2's forward on
    each captured call; its backward with the flags the plain step asked
    for (a deform field puts the coordinate gradient on the latent and on
    the RGB) and with both outputs; the smooth step's first double backward
    on the latent with its flags and with every output.  Returns the worst
    errors (K2's keyed by latent or RGB) and the captured plain-step
    backward inputs."""
    import torch

    from mpsnerf_torch.ops import grid_sample as gs

    err, bwd_inputs = {"nearest_vertex": 0.0}, {}
    ok_all = True
    knn_stages = {}
    for stage, name, args in calls:
        plain = stage.endswith("plain")
        which = "latent" if args[1].shape[1] > 3 else "rgb"
        if name == "nearest_vertex_cuda" and plain:
            i = knn_stages[stage] = knn_stages.get(stage, 0) + 1
            label = f"{stage} step call {i}"
            if stage.startswith("pair") and i == 2:
                label = "pair mode's coarse-point 1-NN"
            e, _ = compare_knn(label, args[0], args[1], args[2])
            err["nearest_vertex"] = max(err["nearest_vertex"], e)
        elif name == "grid_sample_patch_fwd_cuda" and plain:
            which = "latent" if args[0].shape[1] > 3 else "rgb"
            ok, e = compare_fwd(f"{stage} step {which}", *args)
            key = ("grid_sample_patch_fwd", which)
            err[key] = max(err.get(key, 0.0), e)
            ok_all &= ok
        elif name == "grid_sample_patch_bwd_cuda" and plain:
            need = tuple(args[3:5])
            flags = (need,) if need == (True, True) else (need, (True, True))
            ok, worst, text = compare_k2_bwd(f"{stage} {which}", *args[:3],
                                             flags=flags)
            # the RGB wants no image gradient; the latent does
            ok &= need[0] == (which == "latent")
            if need[1]:
                bwd_inputs.setdefault((stage, which), (args[:3], need))
            key = ("grid_sample_patch_bwd", which)
            err[key] = max(err.get(key, 0.0), worst)
            ok_all &= ok
            log(f"[10] K2 backward of the {stage} step on the {which}, "
                f"need {tuple(map(int, need))}, {text}: "
                f"{'ok' if ok else 'FAIL'}")
        elif (name == "grid_sample_patch_bwd2_cuda" and not plain
              and which == "latent"
              and ("grid_sample_patch_bwd2", "latent") not in err):
            key = ("grid_sample_patch_bwd2", "latent")
            err[key] = 0.0
            for need in dict.fromkeys((tuple(args[-1]), (True, True, True))):
                run = (*args[:-1], need)
                with uncounted():
                    k = gs.grid_sample_patch_bwd2_cuda(*run)
                    torch.cuda.synchronize()
                ok, worst, text = rel_errors(
                    k, gs.grid_sample_patch_double_backward_plain(*run),
                    ("d_g", "d_image", "d_coords"))
                err[key] = max(err[key], worst)
                ok_all &= ok
                log(f"[10] K2 double backward of the {stage} step (a "
                    f"deform field) on the latent, need "
                    f"{tuple(map(int, need))}: {text}: "
                    f"{'ok' if ok else 'FAIL'}")
    # a coordinate gradient on both images (the deform field moves the
    # projected points); the pair step's three 1-NN calls (the mask, the
    # coarse points, the canonical points)
    pair_calls = max((n for s, n in knn_stages.items()
                      if s.startswith("pair")), default=0)
    ok_all &= {k[1] for k in bwd_inputs} == {"latent", "rgb"} \
        and pair_calls == 3
    log(f"[10] captured: K1 calls per plain step {knn_stages}, K2 backward "
        f"inputs {sorted(bwd_inputs)}: {'ok' if ok_all else 'FAIL'}")
    if not ok_all:
        raise SystemExit(1)
    return err, bwd_inputs


def time_variant_bwd(bwd_inputs):
    """K2's backward with the coordinate gradient at the aggregate field's
    plain-step inputs, latent and RGB, with the flags the step asked for:
    the kernel's call time, the plain version's, autograd of
    ``F.grid_sample`` (the yardstick) and the bound."""
    from mpsnerf_torch.ops import grid_sample as gs

    out = {}
    for (stage, which), ((g, image, coords), need) in bwd_inputs.items():
        if not stage.startswith("correction_field"):
            continue
        v, c, h, w = image.shape
        bound, by = bound_ms(*k2_bwd_work(
            v, c, coords.shape[1], touched_pixels(coords, h, w), need))
        with uncounted():
            ms = cuda_ms(lambda: gs.grid_sample_patch_bwd_cuda(
                g, image, coords, *need), 20)
        plain = cuda_ms(lambda: gs.grid_sample_patch_backward_plain(
            g, image, coords, *need), 3)
        lib = cuda_ms(_library_bwd(g, image, coords, need), 20)
        out[which] = {"shape": [v, c, h, w], "points": coords.shape[1],
                      "need": list(need), "ms": ms, "plain_ms": plain,
                      "library_ms": lib, "bound_ms": bound, "bound_by": by}
        log(f"[10] K2 backward at the correction field's plain-step "
            f"{which} inputs {(v, c, h, w)} x {coords.shape[1]}, need "
            f"{tuple(map(int, need))}: kernel {ms:.4f} ms, plain "
            f"{plain:.3f} ms, autograd of F.grid_sample {lib:.4f} ms "
            f"(yardstick), bound {bound:.4f} ms ({by})")
    return out


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
        touched = touched_pixels(coords, h, w)
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
            fwd["bound_ms"], fwd["bound_by"] = bound_ms(
                *k2_fwd_work(v, c, n, touched))
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
            bwd["bound_ms"], bwd["bound_by"] = bound_ms(
                *k2_bwd_work(v, c, n, touched, need))
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
            bwd2["bound_ms"], bwd2["bound_by"] = bound_ms(
                *k2_bwd2_work(v, c, n, touched, True, True, n3))
            bwd2["no_gg_image_bound_ms"] = bound_ms(
                *k2_bwd2_work(v, c, n, touched, False, True, n_smooth))[0]
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
        rec["bound_ms"], rec["bound_by"] = bound_ms(*k2_bwd_work(
            v, c, n, touched_pixels(coords, h, w), need))
        sets[label.replace(" ", "_")] = rec
        log(f"[7] grid_sample_patch_bwd on the {label}'s latent inputs "
            f"{tuple(image.shape)} x {n}, need {need}: kernel "
            f"{rec['ms']:.4f} ms (device {fmt(rec['device_ms'])}; both outputs "
            f"{rec['both_outputs_ms']:.4f}), "
            f"plain {rec['plain_ms']:.3f} ms, library "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms")
    out["grid_sample_patch_bwd"]["captured"] = sets
    # the RGB's backward at the plain step's points (both outputs), with
    # autograd of F.grid_sample on the same inputs beside it
    image, coords = captured["fwd"]["plain step rgb"]
    v, c, h, w = image.shape
    n = coords.shape[1]
    need = (True, True)
    g = torch.randn((v, c, n), generator=torch.Generator(
        device=image.device).manual_seed(3), device=image.device)
    with uncounted():
        rec = {
            "need": list(need),
            "ms": cuda_ms(lambda: gs.grid_sample_patch_bwd_cuda(
                g, image, coords, *need), 10),
            "library_ms": cuda_ms(_library_bwd(g, image, coords, need), 10),
            "shape": [list(image.shape), n],
        }
    rec["bound_ms"], rec["bound_by"] = bound_ms(*k2_bwd_work(
        v, c, n, touched_pixels(coords, h, w), need))
    out["grid_sample_patch_bwd"]["rgb"]["plain_step_points"] = rec
    log(f"[7] grid_sample_patch_bwd on the RGB {tuple(image.shape)} at the "
        f"plain step's {n} points, need {need}: kernel {rec['ms']:.4f} ms, "
        f"library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms")
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
    rec["bound_ms"], rec["bound_by"] = bound_ms(*k2_bwd2_work(
        v, c, n, touched_pixels(coords, h, w), gg_image is not None,
        gg_coords is not None, need))
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


def buckets_record(v, train_launches, serving_launches):
    """The bucket build's line of phase 7, on the posed rig: kernel, plain
    version and the card's bound, bytes only (each vertex read once, the
    table and boxes written once: what any build must move, whatever its
    design).  Beside it, not the bound: the device time of a one-element
    torch op (the card's launch floor), and ``torch.sort`` of the table's
    (code << 32 | id) keys as a yardstick in the library column (the sort
    alone, not the same function: no PyTorch call builds the table)."""
    import torch

    from mpsnerf_torch.ops import knn

    nv = v.shape[0]
    nb = -(-nv // knn.BUCKET)
    keys = (knn.morton_codes(v) << 32) | torch.arange(nv, device=v.device)
    one = torch.zeros(1, device=v.device)
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
            "library_ms": cuda_ms(lambda: torch.sort(keys), 20),
            "library_call": f"torch.sort of the {nv} int64 keys: a "
                            "yardstick, the sort alone, not the same function",
            "launch_floor_ms": device_ms(lambda: one.add_(1), 50),
        }
    rec["bound_ms"] = (nv * 12 + nb * knn.BUCKET * 16 + nb * 32) \
        / HBM_BYTES_S * 1e3
    rec["bound_by"] = "bytes"
    log(f"[7] bucket build {nv} vertices: kernel {rec['ms']:.4f} ms (device "
        f"{fmt(rec['device_ms'])}, host {rec['host_us']:.1f} us), plain "
        f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.6f} ms "
        f"(bytes); launch floor {fmt(rec['launch_floor_ms'], '.5f')} ms; "
        f"torch.sort of the keys {rec['library_ms']:.4f} ms (yardstick)")
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


# ---- phase 11: the legacy family and the legacy eval ----------------------

# (--model, flag overrides): the numpy-era models of phase 11
LEGACY = (("correction_by_f3d", {}),
          ("correction_by_f3d_fagg", {"use_f2d": 1}),
          ("correction_by_uvh_agg", {}),
          ("correction_by_uvh_agg_fagg", {}))
LEGACY_CAPTURE = "correction_by_f3d_fagg"


def train_legacy(dev, size=512, n_verts=6890, n_rays=1000, n_samples=128):
    """Phase 11 (a): one plain and one smooth ``Trainer.view_step`` of each
    numpy-era model through ``factory.return_model`` on the flagship
    config, on phase 5's 512^2 scene (the posed and the canonical
    sparse-conv plans attached); the trainer at step 3, so that the
    zero-init output layers move in the plain step and the smooth step's
    Jacobian norms are non-zero; an untimed plain and smooth step of the
    first model before.  K1/K2 inputs captured on
    ``correction_by_f3d_fagg``'s plain step.  The sizes shrink it for a
    rehearsal on the CPU."""
    import math

    import torch

    from mpsnerf_torch.data import attach_spconv_plan, to_device_input
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.train.trainer import TrainConfig, Trainer

    ds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=size,
                               n_verts=n_verts, split="train", n_rays=n_rays)
    smpl = ds.smpl_for(0, device=dev)
    item = to_device_input(attach_spconv_plan(
        ds.get_item(0, instance_idx=0), canonical=True), dev, rays=True)
    # an untimed plain and smooth step first (the products' and the
    # Jacobians' double backward's first calls pick and load their kernels)
    warm = Trainer(variant_model(LEGACY[0][0], LEGACY[0][1], dev)[0],
                   TrainConfig(n_samples=n_samples), device=dev,
                   start_step=3)
    for _ in range(2):
        warm.view_step(smpl, item, item, 0)
    del warm
    reset_counts()
    spy, results = kernel_spy(), {}
    with spy:
        for name, over in LEGACY:
            model, _ = variant_model(name, over, dev)
            trainer = Trainer(model, TrainConfig(n_samples=n_samples),
                              device=dev, start_step=3, seed=0)
            fields = {n: p.detach().clone()
                      for n, p in model.named_parameters()
                      if n.split(".")[0] in ("forward_deform",
                                             "backward_deform")}
            recs = []
            for _ in range(2):
                smooth = trainer.smooth_now()
                spy.stage = ("(a) plain" if name == LEGACY_CAPTURE
                             and not smooth else None)
                counts0 = read_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                terms, _ = trainer.view_step(smpl, item, item,
                                             trainer.step % 4)
                end.record()
                torch.cuda.synchronize()
                counts1 = read_counts()
                recs.append({"smooth": smooth, "ms": start.elapsed_time(end),
                             "terms": terms,
                             "launches": {k: counts1[k] - counts0[k]
                                          for k in KERNEL_NAMES}})
            spy.stage = None
            moved = {o: any(bool((p.detach() != fields[n]).any())
                            for n, p in model.named_parameters()
                            if n in fields and n.startswith(o))
                     for o in ("forward_deform", "backward_deform")}
            finite = all(math.isfinite(float(x)) for r in recs
                         for x in r["terms"])
            dropped = max(float(r["terms"].n_dropped) for r in recs)
            smooth_t = recs[1]["terms"]
            jac = (float(smooth_t.normal_smooth), float(smooth_t.smpl_normal))
            # CorrectionF3D's smooth loss compares Jacobian norms; the
            # CorrectionUvhAgg has none (zeros in its slots)
            jac_ok = (min(jac) > 0 if name.startswith("correction_by_f3d")
                      else max(jac) == 0)
            k2_ok = all(r["launches"]["grid_sample_patch_fwd"] > 0
                        and r["launches"]["nearest_vertex"] >= 2
                        for r in recs)
            ok = (finite and dropped == 0 and all(moved.values())
                  and [r["smooth"] for r in recs] == [False, True]
                  and jac_ok and k2_ok)
            results[name] = recs
            log(f"[11] {name} {json.dumps(over)}: plain {recs[0]['ms']:.1f} "
                f"ms, smooth {recs[1]['ms']:.1f} ms (CUDA events); loss "
                f"{float(recs[0]['terms'].total):.5f} / "
                f"{float(smooth_t.total):.5f}; smooth-step Jacobian terms "
                f"(normal_smooth, smpl_normal) {jac[0]:.3g}, {jac[1]:.3g}; "
                f"fields moved {moved}; n_dropped {dropped:g}; launches "
                f"plain {json.dumps(recs[0]['launches'])}, smooth "
                f"{json.dumps(recs[1]['launches'])}: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(1)
            del trainer, model
            if torch.device(dev).type == "cuda":
                torch.cuda.empty_cache()
    return read_counts(), results, spy.calls


class nth_call:
    """Sets ``spy.stage`` to ``stage`` for the ``n``-th call (from 0) of
    ``owner.name`` inside the block, and back to None after it."""

    def __init__(self, spy, stage, owner, name, n=0):
        self.spy, self.stage, self.owner, self.name, self.n = (
            spy, stage, owner, name, n)

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)
        count = [0]

        def call(*a, **k):
            hit = count[0] == self.n
            count[0] += 1
            if hit:
                self.spy.stage = self.stage
            try:
                return self.orig(*a, **k)
            finally:
                if hit:
                    self.spy.stage = None

        setattr(self.owner, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def legacy_view(dev, size=256, n_verts=6890, n_samples=128):
    """Phase 11 (b): one served view of ``correction_by_f3d_fagg`` at
    ``size``^2 through ``ViewRenderer``, which must take the chunked path
    (every sample runs the network): ms to the image on the device (CUDA
    events around ``render_view_async``, which completes the chunked
    path, fetch included).  Returns its launches, its time and the
    kernels' inputs in the first chunk of its warm-up render."""
    import numpy as np
    import torch

    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.eval.runner import ViewRenderer

    ds = SyntheticHumanDataset(n_poses=1, n_cameras=6, input_views=[0, 2, 4],
                               image_size=size, n_verts=n_verts)
    item = ds.get_item(0, instance_idx=0)
    smpl = ds.smpl_for(0, device=dev)
    model, _ = variant_model(LEGACY_CAPTURE, dict(LEGACY)[LEGACY_CAPTURE],
                             dev)
    r = ViewRenderer(model, lambda g: smpl, n_samples=n_samples, device=dev)
    # the warm-up render (the latent, the plans); the kernels' inputs in its
    # first chunk are kept for phase 11 (d)
    spy = kernel_spy()
    with uncounted(), spy, nth_call(spy, "(b) view 1, chunk 0,",
                                    ViewRenderer, "_chunk"):
        r.render_view(item, item, 1)
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    pending = r.render_view_async(item, item, 1)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    launches = read_counts()
    rgb = r.finish_view(pending)
    stats = r.last_view
    opaque = float((stats.acc > 0.5).mean())
    ok = (not r.global_compact and not r.box_cull
          and stats.hit_rays == size * size and np.isfinite(rgb).all()
          and rgb.shape == (size * size, 3) and stats.n_dropped == 0
          and opaque > 0.01 and launches["nearest_vertex"] > 0
          and launches["grid_sample_patch_fwd"] > 0)
    log(f"[11] {LEGACY_CAPTURE} view 1 at {size}^2: {ms:.1f} ms to the "
        f"image (CUDA events), chunked path {not r.global_compact} (box "
        f"cull {r.box_cull}), {stats.hit_rays} rays x {n_samples} "
        f"samples run, acc>0.5 on {100 * opaque:.1f} %, finite "
        f"{bool(np.isfinite(rgb).all())}; launches {json.dumps(launches)}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)
    del r, model
    torch.cuda.empty_cache()
    return launches, {"ms": ms}, spy.calls


def avi_check(path, want_frames, want_w, want_h):
    """The RIFF header and ``idx1`` index of a written AVI: codec, frame
    count, frame size; the first MJPG frame decoded by PIL."""
    import io

    from mpsnerf_torch.eval.video import MJPG, read_avi_index

    codec, w, h, n, sizes = read_avi_index(path)
    ok = (w, h, n, len(sizes)) == (want_w, want_h, want_frames, want_frames)
    decoded = None
    if codec == MJPG:
        with open(path, "rb") as f:
            data = f.read()
        at = data.index(b"00dc") + 8
        from PIL import Image

        decoded = Image.open(io.BytesIO(data[at:at + sizes[0]])).size
        ok &= decoded == (want_w, want_h)
    return ok, (f"{codec!r} {w}x{h}, {n} frames in the header, {len(sizes)} "
                f"in the index, first frame decoded {decoded}")


def legacy_cli_on_the_card(dev, size=512, scaling=0.5, n_verts=6890,
                           overrides=()):
    """Phase 11 (c): ``run_nerf_batch_torch.main`` with ``--model
    correction_by_f3d_fagg --use_f2d 1 --data_set_type THuman_B_R`` on
    phase 9's THuman-layout fixture (written again, with the legacy
    window's poses 13 and 14).  First one item trained, loaded in the loop
    (24 view-steps; the CLI attaches the posed and the canonical
    sparse-conv plans; a checkpoint at step 24); then ``--save_weights 0
    --image_scaling`` ``scaling``, which reloads that checkpoint and runs
    the legacy test of its 2 items at ``size * scaling``^2, views 0 and 12:
    the PSNR file, the side-by-side and per-frame PNGs and both AVIs, each
    AVI's header and index parsed for its frame count and size.  Returns
    the launches of both runs (``legacy_cli``, ``legacy_eval``), the
    eval's seconds per image, and the kernels' inputs in the training's
    first plain view-step and in the first chunk of the eval's first
    view.  ``size``, ``scaling`` and ``overrides`` (more CLI flags) shrink
    it for a rehearsal on the CPU."""
    import math
    import os
    import pathlib
    import tempfile

    import numpy as np
    import torch

    import run_nerf_batch_torch
    from mpsnerf_torch.eval.runner import ViewRenderer
    from mpsnerf_torch.train.trainer import Trainer

    on_card = torch.device(dev).type == "cuda"
    config = pathlib.Path(__file__).resolve().parent / "configs"
    cwd = os.getcwd()
    hw = int(size * scaling)
    spy, launches = kernel_spy(), {}
    with tempfile.TemporaryDirectory(prefix="mpsnerf_legacy_") as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "thuman", "fixture_legacy_F")
        # 15 pose entries: the legacy window reads poses 13 and 14
        write_thuman_subject(root, size, 2, {p: int(p == 14)
                                             for p in range(15)}, n_verts)
        log(f"[11] THuman-layout fixture for the legacy CLI: {size}^2 x 2 "
            f"frames, 15 pose entries; written in "
            f"{time.perf_counter() - t0:.1f} s")
        base = os.path.join(tmp, "logs")
        argv = ["--config", str(config / "canonical_transformer.txt"),
                "--model", LEGACY_CAPTURE, "--use_f2d", "1",
                "--data_root", root, "--data_set_type", "THuman_B_R",
                "--multi_person", "0", "--batch_size", "1", "--basedir",
                base, "--device", str(dev), *overrides]
        orig_step = Trainer.view_step

        def spy_step(trainer, *a, **k):
            # the kernels' inputs in the first plain view-step
            if not spy.calls and not trainer.smooth_now():
                spy.stage = "(c) CLI plain"
            try:
                return orig_step(trainer, *a, **k)
            finally:
                spy.stage = None

        try:
            os.chdir(tmp)
            Trainer.view_step = spy_step
            with spy:
                reset_counts()
                t0 = time.perf_counter()
                with step_timer(on_card) as timer:
                    trained = run_nerf_batch_torch.main(argv + [
                        "--N_iteration", "23", "--i_weights", "24",
                        "--i_print", "24", "--i_testset", "1000000",
                        "--num_worker", "0"])
                train_s = time.perf_counter() - t0
                launches["legacy_cli"] = read_counts()
                Trainer.view_step = orig_step
                n_train_calls = len(spy.calls)
                reset_counts()
                t0 = time.perf_counter()
                with nth_call(spy, "(c) eval view 0, chunk 0,",
                              ViewRenderer, "_chunk"):
                    run = run_nerf_batch_torch.main(argv + [
                        "--save_weights", "0", "--image_scaling",
                        str(scaling)])
                if on_card:
                    torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches["legacy_eval"] = read_counts()
        finally:
            Trainer.view_step = orig_step
            os.chdir(cwd)
        model = trained.trainer.model
        moved = {f: float(getattr(model, f).output_linear.weight.detach()
                          .abs().max()) > 0
                 for f in ("forward_deform", "backward_deform")}
        recs = timer.records
        finite = all(math.isfinite(float(x)) for r in recs
                     for x in r["terms"])
        dropped = max(float(r["terms"].n_dropped) for r in recs)
        means = []
        for kind in (False, True):
            ms = [r["ms"] for r in recs if r["smooth"] == kind][1:]
            means.append(sum(ms) / max(1, len(ms)))
        ok = (trained.trainer.global_step == 24 and len(recs) == 24
              and finite and dropped == 0 and all(moved.values())
              and type(model).__name__ == "CorrectionF3D"
              and launches["legacy_cli"]["nearest_vertex"] > 0
              and launches["legacy_cli"]["grid_sample_patch_bwd"] > 0)
        log(f"[11] legacy CLI training ({LEGACY_CAPTURE}, THuman_B_R, "
            f"{size}^2): 1 item, {len(recs)} view-steps in {train_s:.1f} s "
            f"(the load, the plans and the checkpoint included); plain "
            f"{means[0]:.1f} ms, smooth {means[1]:.1f} ms mean by "
            f"{'CUDA events' if on_card else 'wall'} (each kind's first "
            f"left out); finite {finite}, n_dropped {dropped:g}, output "
            f"layers moved {moved}; launches "
            f"{json.dumps(launches['legacy_cli'])}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)
        out = os.path.join(base, run.args.expname)
        [testset] = [d for d in os.listdir(out)
                     if d.startswith("testset_") and "more_real" in d]
        d = os.path.join(out, testset)
        names = sorted(os.listdir(d))
        n_img = 4  # 2 items x views 0 and 12
        psnr = [f for f in names if f.startswith("psnr_")]
        want = {f"00_0{t}_{k:02d}.png" for t in (0, 1) for k in (0, 12)} | {
            f"frame00{13 + t}_view00{k:02d}{gt}.png" for t in (0, 1)
            for k in (0, 12) for gt in ("", "_gt")}
        strip_h = int(hw * 2 * hw / (3 * hw))
        checks = [avi_check(os.path.join(d, f"{v}.avi"), 2, 2 * hw,
                            strip_h + hw) for v in ("novel_pose",
                                                    "novel_view")]
        value = float(np.load(os.path.join(d, psnr[0]))) if psnr else None
        ev = launches["legacy_eval"]
        ok = (len(psnr) == 1 and np.isfinite(value) and want <= set(names)
              and all(c[0] for c in checks) and run.start_step == 24
              and type(run.trainer.model).__name__ == "CorrectionF3D"
              and ev["nearest_vertex"] > 0 and ev["grid_sample_patch_fwd"] > 0
              and (len(spy.calls) > n_train_calls or not on_card))
        log(f"[11] legacy eval (THuman_B_R, run_legacy_test, {run.args.model}"
            f" reloaded at step {run.start_step}) at {hw}^2: {secs:.1f} s "
            f"for {n_img} images ({secs / n_img:.2f} s per image: 2 items "
            f"loaded at {size}^2 x 24 views, renders, PNGs, videos); PSNR "
            f"{value}; {len(names)} files; novel_pose.avi {checks[0][1]}; "
            f"novel_view.avi {checks[1][1]}; launches {json.dumps(ev)}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)
    return launches, secs / n_img, spy.calls


def compare_legacy_inputs(calls):
    """Phase 11 (d), phase 2's comparisons on what ``correction_by_f3d_fagg``
    gave the kernels, one query's calls for each stage of ``calls``: a
    plain train step (phase 11 (a), the CLI's) or the first chunk of a
    served view (no backward).  K1's ids and d2 on the query's three calls
    (the posed mask, the coarse canonical points, the canonical points);
    K2's forward on the 25 shifted window coordinates (some beyond the
    border on a step) and on the refined source points; on a step, K2's
    backward with the coordinate gradient at the refined source points
    (and each window sample's image-only backward at its flags).  Returns
    the worst errors, K2's keyed by (kernel, "latent")."""
    err, ok_all = {"nearest_vertex": 0.0}, True
    stages = list(dict.fromkeys(stage for stage, _, _ in calls))
    for stage in stages:
        step = "plain" in stage
        tag = f"{stage} step," if step else stage
        n_knn = n_fwd = n_bwd = coord_bwd = 0
        outside, shapes = [], set()
        for _, name, args in (c for c in calls if c[0] == stage):
            if name == "nearest_vertex_cuda":
                n_knn += 1
                label = ("the posed 5 cm mask", "the coarse canonical points",
                         "the canonical points")[min(n_knn, 3) - 1]
                e, _ = compare_knn(f"{tag} {label}", args[0], args[1],
                                   args[2])
                err["nearest_vertex"] = max(err["nearest_vertex"], e)
            elif name == "grid_sample_patch_fwd_cuda":
                n_fwd += 1
                image, coords = args
                shapes.add((tuple(image.shape), coords.shape[1]))
                beyond = float((coords.abs() > 1).any(-1).float().mean())
                if n_fwd <= 25:
                    outside.append(beyond)
                ok, e = compare_fwd(
                    f"{tag} "
                    + (f"window sample {n_fwd}" if n_fwd <= 25
                       else "refined source points")
                    + f" ({100 * beyond:.2f} % beyond the border)", image,
                    coords)
                key = ("grid_sample_patch_fwd", "latent")
                err[key] = max(err.get(key, 0.0), e)
                ok_all &= ok
            elif name == "grid_sample_patch_bwd_cuda":
                need = tuple(args[3:5])
                coord_bwd += need[1]
                flags = (need,) if need[1] else (need, (True, True))
                ok, worst, text = compare_k2_bwd(f"{stage}", *args[:3],
                                                 flags=flags)
                key = ("grid_sample_patch_bwd", "latent")
                err[key] = max(err.get(key, 0.0), worst)
                ok_all &= ok
                n_bwd += 1
                if need[1] or n_bwd == 2 or not ok:
                    log(f"[11] K2 backward {n_bwd} of the {stage} step (the "
                        f"{'refined source points' if need[1] else 'window'})"
                        f", need {tuple(map(int, need))}, {text}: "
                        f"{'ok' if ok else 'FAIL'}")
        ok = (n_knn == 3 and n_fwd == 26 and n_bwd == (26 if step else 0)
              and coord_bwd == int(step)
              and (max(outside, default=0) > 0 if step else True))
        ok_all &= ok
        log(f"[11] captured on {LEGACY_CAPTURE}, {tag} {n_knn} K1 calls, "
            f"{n_fwd} K2 forward calls at {sorted(shapes)} (window samples "
            f"beyond the border: {100 * min(outside, default=0):.2f}-"
            f"{100 * max(outside, default=0):.2f} % of points), {n_bwd} K2 "
            f"backward calls, {coord_bwd} with the coordinate gradient; "
            f"every one against its plain version: "
            f"{'ok' if ok else 'FAIL'}")
    if not ok_all or len(stages) != 4:
        log(f"[11] kernel comparisons on {len(stages)} captured stages "
            f"({stages}), 4 expected: FAIL")
        raise SystemExit(1)
    return err


# ---- phase 12: geometry and serving at full width ---------------------------

MESH_N = 256       # the extraction grid's points per axis (the CLI default)
SERVE_MESH_N = 128
SHARD_RANKS = 2  # the served bundle's sharded render: ranks share the card
MESH_CHUNK = 262144  # the CLI's points per density query


def compare_geometry_inputs(calls):
    """Phase 12 (e), phase 2's comparisons on what the geometry paths gave
    the kernels, per captured stage (an extraction chunk in each frame, a
    bake chunk, an animation sample chunk, the first served /spiral frame's
    fine pre-pass and first tail tile, a served /mesh chunk): K1's ids and
    d2 on every call, K2's forward on the latent and the RGB.  Returns the
    worst errors, K2's keyed by (kernel, "latent" or "rgb")."""
    err, ok_all = {"nearest_vertex": 0.0}, True
    stages = list(dict.fromkeys(stage for stage, _, _ in calls))
    for stage in stages:
        n_knn = n_fwd = 0
        for _, name, args in (c for c in calls if c[0] == stage):
            if name == "nearest_vertex_cuda":
                n_knn += 1
                e, _ = compare_knn(f"{stage}, call {n_knn}", args[0], args[1],
                                   args[2])
                err["nearest_vertex"] = max(err["nearest_vertex"], e)
            elif name == "grid_sample_patch_fwd_cuda":
                n_fwd += 1
                image, coords = args
                which = "rgb" if image.shape[1] == 3 else "latent"
                ok, e = compare_fwd(f"{stage} {which}", image, coords)
                key = ("grid_sample_patch_fwd", which)
                err[key] = max(err.get(key, 0.0), e)
                ok_all &= ok
        ok = n_knn >= 1 and n_fwd >= 2
        ok_all &= ok
        log(f"[12] captured {stage}: {n_knn} K1 and {n_fwd} K2 forward "
            f"calls, each against its plain version: "
            f"{'ok' if ok else 'FAIL'}")
    if not ok_all or len(stages) != 6:
        log(f"[12] kernel comparisons on {len(stages)} captured stages "
            f"({stages}), 6 expected: FAIL")
        raise SystemExit(1)
    return err


def knn_grid_record(q, v, clock_mhz, per_pair):
    """K1 on the whole extraction grid (the carve's 5 cm mask call): ms,
    the pairs it evaluated, its bound, the instruction rate on those
    pairs and on every pair (phase 7's terms; the plain version is held
    on a slice and not timed at this size), and the library yardstick,
    ``cdist`` + ``min`` in blocks of 65,536 queries over the whole grid."""
    from mpsnerf_torch.ops import knn

    n, nv = q.shape[0], v.shape[0]
    b = knn.build_vertex_buckets(v)
    rate = FP32_LANES * clock_mhz * 1e6
    with uncounted():
        ms = cuda_ms(lambda: knn.nearest_vertex_cuda(q, v, b), 3)
        library_ms = cuda_ms(lambda: knn_library(q, v), 1)
    pairs = knn_pairs(q, v, b)
    bytes_ms = (n * 12 + nv * 12 + n * 8 + n * 4) / HBM_BYTES_S * 1e3
    ops_ms = n * per_pair / rate * 1e3
    rec = {"shape": [n, nv], "ms": ms, "pairs": pairs,
           "pairs_share": pairs / (n * nv),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "pairs_bound_ms": max(bytes_ms, pairs * per_pair / rate * 1e3),
           "brute_force_bound_ms": max(bytes_ms,
                                       n * nv * per_pair / rate * 1e3),
           "plain_ms": None, "library_ms": library_ms}
    log(f"[12] K1 on the extraction grid {n} x {nv}: {ms:.3f} ms (cdist+min "
        f"in blocks {library_ms:.1f} ms), bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); pairs {pairs} "
        f"({100 * rec['pairs_share']:.2f} % of brute force) at "
        f"{rec['pairs_bound_ms']:.3f} ms, brute force at "
        f"{rec['brute_force_bound_ms']:.3f} ms")
    return rec


def extraction_on_the_card(dev, tmp, spy, size=512, mesh_n=MESH_N,
                           n_verts=6890):
    """Phase 12 (a) and (b): ``extract_thuman_mesh_torch.main`` on the
    flagship config over a THuman-layout fixture (the seeded weights saved
    as its checkpoint), in the target frame and with ``--can_flag 1``; each
    extraction's stage times, counts, ``n_dropped`` and its vertices inside
    the grid box; then ``render_thuman_mesh_torch.main`` on the two OBJ
    files (camera 4 of its 3, 512^2: the phase's depth cut).  The middle
    query chunk of each extraction is captured by ``spy``.  Returns (the
    runs, the posed vertices, launches)."""
    import os
    import pathlib

    import numpy as np
    import torch

    import extract_thuman_mesh_torch
    import render_thuman_mesh_torch
    from mpsnerf_torch.data.imageio import decode_png
    from mpsnerf_torch.models.mps_nerf import MPSNeRF
    from mpsnerf_torch.train.checkpoint import save_checkpoint

    config = pathlib.Path(__file__).resolve().parent / "configs"
    t0 = time.perf_counter()
    root = os.path.join(tmp, "thuman", "fixture_F")
    write_thuman_subject(root, size, 1, {p: 0 for p in range(20)}, n_verts)
    os.makedirs(os.path.join(tmp, "data"), exist_ok=True)
    with open(os.path.join(tmp, "data", "THuman_1_human_list.txt"), "w") as f:
        f.write("fixture_F\n" * 25)
    base = os.path.join(tmp, "logs")
    save_checkpoint(base, "THuman_3_view", 1, {
        "step": 1, "model": seeded_model("cpu").state_dict(),
        "optimizer": {}})
    log(f"[12] THuman-layout fixture {size}^2 x 24 cameras, seeded "
        f"checkpoint: {time.perf_counter() - t0:.1f} s")
    argv = ["--config", str(config / "canonical_transformer.txt"),
            "--data_root", root, "--basedir", base, "--mesh_N",
            str(mesh_n), "--device", str(dev)]
    cwd = os.getcwd()
    runs = {}
    # the middle query chunk (through the body) is kept for (e)
    middle = -(-mesh_n ** 3 // MESH_CHUNK) // 2
    try:
        os.chdir(tmp)  # the loader reads data/ and the CLI writes objs/
        reset_counts()
        for can in (0, 1):
            label = "canonical" if can else "target"
            t0 = time.perf_counter()
            with nth_call(spy, f"extraction chunk {middle} ({label})",
                          MPSNeRF, "query", middle):
                run = extract_thuman_mesh_torch.main(
                    argv + ["--can_flag", str(can)])
            wall = time.perf_counter() - t0
            lo, hi = run.grid.start, run.grid.start + run.grid.size
            inside = bool(np.isfinite(run.verts).all()
                          and (run.verts >= lo - 1e-5).all()
                          and (run.verts <= hi + 1e-5).all())
            ok = (run.step == 1 and inside and len(run.tris) > 1000
                  and os.path.exists(run.obj_path))
            st = run.stats
            log(f"[12] (a) extraction {label} {mesh_n}^3 "
                f"({st['n_points']} points): density queries "
                f"{st['density_ms']:.1f} ms, K1 mask {st['mask_ms']:.1f} ms, "
                f"K=5 carve {st['carve_ms']:.1f} ms, marching cubes "
                f"{st['mc_ms']:.1f} ms; {len(run.verts)} vertices, "
                f"{len(run.tris)} triangles, n_dropped {run.n_dropped}; "
                f"CLI {wall:.1f} s in all; checkpoint step {run.step}, "
                f"vertices finite and inside the grid box {inside}: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(1)
            runs[label] = run
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        launches = read_counts()
        t0 = time.perf_counter()
        pngs = render_thuman_mesh_torch.main(
            ["--config", str(config / "canonical_transformer.txt"),
             "--data_root", root, "--cameras", "4"])
        wall = time.perf_counter() - t0
        cover = []
        for path in pngs:
            with open(path, "rb") as f:
                img = decode_png(f.read())
            cover.append(float((img[..., 3] > 0).mean())
                         if img.shape == (512, 256, 4) else 0.0)
        ok = len(pngs) == 2 and min(cover) > 0
        log(f"[12] (b) normal maps: {len(pngs)} RGBA PNGs (2 meshes x "
            f"camera 4, 512^2 cropped to 512x256) in {wall:.1f} s, coverage "
            f"{min(cover):.3f}-{max(cover):.3f}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)
    finally:
        os.chdir(cwd)
    verts = np.load(os.path.join(root, "new_vertices", "0.npy"))
    return runs, verts.astype(np.float32), launches


def animation_on_the_card(dev, item, smpl, can, spy):
    """Phase 12 (c): ``MeshAnimationRenderer`` on the seeded flagship
    model, baked at (a)'s canonical mesh with phase 4's serving item as the
    source; ``render_pose`` at the item's image size (512^2) from its 3
    cameras, fast and full: ms, hit pixels, sample points, finite pixels.
    The first bake chunk and the first sample chunk go to ``spy``.
    Returns the launches."""
    import numpy as np
    import torch

    from mpsnerf_torch.geometry import MeshAnimationRenderer

    size = item["img_all"].shape[-1]
    model = seeded_model(dev)
    sync = torch.device(dev).type == "cuda"
    r = MeshAnimationRenderer(model, smpl, can.verts, can.tris, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    with nth_call(spy, "bake chunk 0", r, "_query"):
        r.bake(item)
    log(f"[12] (c) bake at {len(can.verts)} canonical vertices: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    for k in range(len(item["K_all"])):  # the item's 3 input cameras
        for fast in (True, False):
            t0 = time.perf_counter()
            if not fast and k == 0:
                with nth_call(spy, "animation samples chunk 0", r, "_query"):
                    img = r.render_pose(item, k, size, size, fast=fast)
            else:
                img = r.render_pose(item, k, size, size, fast=fast)
            if sync:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            st = r.last_pose
            ok = (bool(np.isfinite(img).all()) and st["n_hit"] > size
                  and img.shape == (size, size, 3)
                  and st["n_samples"] == (0 if fast else 11 * st["n_hit"]))
            log(f"[12] (c) render_pose view {k} {'fast' if fast else 'full'}"
                f" {size}^2: {ms:.1f} ms, {st['n_hit']} hit pixels, "
                f"{st['n_samples']} sample points, finite: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(1)
    launches = read_counts()
    del r, model
    return launches


def serving_on_the_card(dev, tmp, item, smpl, camera, spy, spiral_hw=256,
                        spiral_frames=4, mesh_n=SERVE_MESH_N):
    """Phase 12 (d): a port bundle of the seeded flagship model served by
    ``BundleServer`` on 127.0.0.1, port 0, in this process; every route
    over HTTP, each request's wall ms; /render equal to
    ``ViewRenderer.render_view`` on the same items, /camera at view 1's
    camera ``(K, R, T)`` equal to /render, /mesh's triangle count equal to
    a direct ``extract_density_mesh`` on the bundle's model.  The first
    /spiral frame's fine pre-pass and first tail tile, and the middle
    query chunk of /mesh, go to ``spy`` (its hooks are module-level, so
    they see the server's thread).  Returns the launches."""
    import io
    import json as json_
    import os
    import pathlib
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from mpsnerf_torch.config import parse_args
    from mpsnerf_torch.eval import runner
    from mpsnerf_torch.eval.runner import ViewRenderer
    from mpsnerf_torch.eval.video import read_avi_index
    from mpsnerf_torch.geometry import GridSpec, extract_density_mesh
    from mpsnerf_torch.models.mps_nerf import MPSNeRF
    from mpsnerf_torch.renderer import tile_graphs
    from mpsnerf_torch.serve import export_serving_bundle
    from mpsnerf_torch.serve.server import BundleServer, items_to_npz_bytes

    config = pathlib.Path(__file__).resolve().parent / "configs"
    args = parse_args(["--config", str(config / "canonical_transformer.txt")])
    model = seeded_model(dev)
    clean = {k: v for k, v in item.items()
             if not k.startswith("_") and k != "body_grid"}
    out = os.path.join(tmp, "bundle")
    t0 = time.perf_counter()
    export_serving_bundle(out, args, model, {int(item["gender"]): smpl},
                          clean, clean, shard_devices=SHARD_RANKS)
    log(f"[12] (d) bundle exported in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{f} {os.path.getsize(os.path.join(out, f)) / 1e6:.1f}"
                    f" MB" for f in sorted(os.listdir(out))))
    srv = BundleServer(out, port=0, device=dev).start()
    url = "http://%s:%d" % srv.address
    body = items_to_npz_bytes(clean, clean)
    cam = items_to_npz_bytes(clean, clean, camera=dict(zip("KRT", camera)))
    walls = {}

    def request(route, data=None):
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    url + route, data=data), timeout=600) as r:
                out = r.read()
        except urllib.error.HTTPError as e:
            log(f"[12] (d) {route}: HTTP {e.code}: "
                f"{e.read().decode(errors='replace')}")
            raise
        walls[route] = (time.perf_counter() - t0) * 1e3
        return out

    try:
        reset_counts()
        health = json_.loads(request("/healthz"))
        manifest = json_.loads(request("/manifest"))
        rendered = np.load(io.BytesIO(request("/render?view=1", body)))
        camera = np.load(io.BytesIO(request(
            f"/camera?h={clean['img_all'].shape[-2]}"
            f"&w={clean['img_all'].shape[-1]}", cam)))
        # frame 0 of the spiral: its fine pre-pass and its first tail tile
        # (an eager query, or the replay of its CUDA graphs)
        with nth_call(spy, "spiral frame 0", runner, "fine_rays_compact"), \
                nth_call(spy, "spiral frame 0", MPSNeRF, "query"), \
                nth_call(spy, "spiral frame 0", tile_graphs._Captured,
                         "run"):
            spiral = np.load(io.BytesIO(request(
                f"/spiral?frames={spiral_frames}&h={spiral_hw}"
                f"&w={spiral_hw}", body)))
        video = request(f"/spiral?frames={spiral_frames}&h={spiral_hw}"
                        f"&w={spiral_hw}&format=video", body)
        middle = -(-mesh_n ** 3 // MESH_CHUNK) // 2
        with nth_call(spy, f"served /mesh chunk {middle}", MPSNeRF, "query",
                      middle):
            with np.load(io.BytesIO(request(f"/mesh?n={mesh_n}",
                                            body))) as z:
                m_verts, m_tris = z["verts"], z["tris"]
        anim = np.load(io.BytesIO(request(f"/animate?view=1&n={mesh_n}",
                                          body)))
        anim_fast = np.load(io.BytesIO(request(
            f"/animate?view=1&fast=1&n={mesh_n}", body)))
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        launches = read_counts()
        served_model = srv.renderer.model
        sharded = sharded_requests(srv, request, body, cam, rendered,
                                   clean["img_all"].shape[-2:], walls)
    finally:
        srv.stop()
    sharded["alive_after_stop"] = [p for p in sharded["pids"]
                                   if not _process_gone(p)]
    with uncounted():
        live = ViewRenderer(model, lambda g: smpl, n_samples=128,
                            tile=16384, device=dev)
        direct = live.render_view(dict(clean), dict(clean), 1)
        smpl_d, sp, tp, latent = live.device_items(dict(clean), dict(clean))
        uncompacted = served_model.with_compact_fraction(None)
        verts = np.asarray(clean["vertices"], np.float32)
        with torch.no_grad():
            d_verts, d_tris = extract_density_mesh(
                lambda p: uncompacted.query(
                    smpl_d, sp, tp, latent, p, torch.zeros_like(p)).sigma,
                GridSpec.from_vertices(verts, n=mesh_n), verts, smpl_d.faces,
                chunk=262144, device=dev)
    avi = os.path.join(tmp, "spiral.avi")
    with open(avi, "wb") as f:
        f.write(video)
    codec, w, h, n_frames, sizes = read_avi_index(avi)
    render_err = float(np.abs(rendered - direct).max())
    camera_err = float(np.abs(camera - rendered).max())
    hw = clean["img_all"].shape[-1]
    checks = {
        "healthz": health["status"] == "ok" and health["has_global"],
        "manifest": manifest["format"] == "mpsnerf_torch",
        "render == ViewRenderer (1e-5)": render_err <= 1e-5,
        "camera == render (1e-5)": camera_err <= 1e-5,
        "spiral": spiral.shape == (spiral_frames, spiral_hw, spiral_hw, 3)
        and bool(np.isfinite(spiral).all()),
        "video": (w, h, n_frames, len(sizes)) == (
            spiral_hw, spiral_hw, spiral_frames, spiral_frames),
        "mesh == direct": len(m_tris) == len(d_tris) > 1000
        and bool(np.isfinite(m_verts).all()),
        "animate": anim.shape == anim_fast.shape == (hw, hw, 3)
        and bool(np.isfinite(anim).all() and np.isfinite(anim_fast).all())
        and (anim.sum(-1) > 0).mean() > 0.01,
    }
    log(f"[12] (d) requests, wall ms with HTTP: "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    checks["sharded"] = sharded_report(sharded)
    log(f"[12] (d) /render vs ViewRenderer max|diff| {render_err:.3g}, "
        f"/camera vs /render {camera_err:.3g}, spiral {spiral.shape}, video "
        f"{codec} {w}x{h} {n_frames} frames, /mesh {len(m_verts)} vertices "
        f"{len(m_tris)} triangles (direct {len(d_tris)}), /animate hit "
        f"share {(anim.sum(-1) > 0).mean():.3f}; launches "
        f"{json.dumps(launches)}; "
        + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit(1)
    return launches, sharded["launches"], sharded["errs"]


def _process_gone(pid):
    import os

    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


# the sharded request's rank 0 spy (in the rank's process)
_RANK_SPY = {}


def serve_rank_arm():
    """On every rank of the served bundle's sharded render, before the
    request that counts: the launches counted from 0; rank 0 (on the card)
    keeps the K1 and K2 forward inputs of its next ``MPSNeRF.query``,
    its first query of the request.  Returns the rank."""
    import torch

    from mpsnerf_torch.models.mps_nerf import MPSNeRF
    from mpsnerf_torch.parallel.mesh import DIST

    _RANK_SPY["launches"] = launch_spy().__enter__()
    reset_counts()
    if DIST["rank"] == 0 and torch.device(DIST["device"]).type == "cuda":
        spy = kernel_spy().__enter__()
        first = nth_call(spy, "sharded request first query", MPSNeRF,
                         "query").__enter__()
        _RANK_SPY.update(spy=spy, first=first)
    return DIST["rank"]


def serve_rank_read():
    """After it: every rank's launch counts; rank 0 closes its spy and
    holds K1 and K2's forward against their plain versions on what it
    kept (phase 13 (e)'s comparisons).  Returns ``(counts, errs)``."""
    counts = read_counts()
    _RANK_SPY.pop("launches").__exit__()
    errs = {}
    if _RANK_SPY:
        _RANK_SPY.pop("first").__exit__()
        spy = _RANK_SPY.pop("spy")
        spy.__exit__()
        errs = compare_render_inputs(spy.calls, tag="[12] (d)",
                                     what="rank 0's first query of the "
                                          "sharded request")
    return counts, errs


def sharded_requests(srv, request, body, cam, rendered, hw, walls):
    """Phase 12 (d), the sharded requests on the same server: /render of
    view 1 with ``sharded=1`` (it starts the ranks: 2 sharing the card
    over gloo), then, the ranks' counts set to 0 and rank 0's spy armed,
    the same request again and /camera at view 1's camera with
    ``sharded=1``; each against /render's unsharded image (the global
    path) and the unsharded chunked path's (``global=0``)."""
    import io

    import numpy as np
    import torch

    served = srv.renderer
    out = {"err": {}, "chunked_err": {}, "n_dropped": [],
           "overflow_blocks": 0, "block": served.manifest["shard_rays"]}
    before = served.n_overflow_chunks

    def sharded(route, data, name):
        img = np.load(io.BytesIO(request(route, data)))
        walls[name] = walls.pop(route)
        out["err"][name] = float(np.abs(img - rendered).max())
        out["chunked_err"][name] = float(np.abs(img - chunked).max())
        last = served.shard_ranks.last
        out["n_dropped"].append(sum(last["n_dropped"]))
        out["blocks"] = last["blocks"]

    # the unsharded chunked path: the ranks' path, one process
    chunked = np.load(io.BytesIO(request("/render?view=1&global=0", body)))
    on_card = served.device.type == "cuda"
    out["reserved_gib"] = (torch.cuda.memory_reserved() / 2 ** 30
                           if on_card else 0.0)
    # the card's free and total memory before the first sharded request
    out["free_gib"], out["total_gib"] = (
        [x / 2 ** 30 for x in torch.cuda.mem_get_info()] if on_card
        else (0.0, 0.0))
    sharded("/render?view=1&sharded=1", body, "sharded /render (start)")
    out["backend"] = served.on_ranks(_rank_backend)
    served.on_ranks(serve_rank_arm)
    sharded("/render?view=1&sharded=1", body, "sharded /render")
    sharded(f"/camera?h={hw[0]}&w={hw[1]}&sharded=1", cam,
            "sharded /camera")
    reads = served.on_ranks(serve_rank_read)
    out["launches"] = {k: sum(c[k] for c, _ in reads) for k in reads[0][0]}
    out["errs"] = reads[0][1]
    out["overflow_blocks"] = served.n_overflow_chunks - before
    out["rank_peak_gib"] = served.on_ranks(_rank_peak_gib)
    out["pids"] = served.shard_ranks.pids
    return out


def _rank_backend():
    from mpsnerf_torch.parallel.mesh import DIST

    return f"{DIST['device']} {DIST['backend']}"


def _rank_peak_gib():
    """This rank's peak reserved device memory (GiB; 0 on the CPU)."""
    import torch

    from mpsnerf_torch.parallel.mesh import DIST

    if torch.device(DIST["device"]).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_reserved() / 2 ** 30


def sharded_report(sh):
    """Logs the sharded requests; True when every check holds."""
    ok = (all(e <= 1e-5 for e in sh["err"].values())
          and all(e <= 1e-5 for e in sh["chunked_err"].values())
          and sh["launches"]["nearest_vertex"] > 0
          and sh["launches"]["grid_sample_patch_fwd"] > 0
          and not sh["alive_after_stop"])
    log(f"[12] (d) sharded requests on {SHARD_RANKS} ranks "
        f"({', '.join(sh['backend'])}), blocks of {sh['block']} rays "
        f"({sh['blocks']} for /camera): max|diff| "
        f"to the unsharded /render "
        + ", ".join(f"{k} {v:.3g}" for k, v in sh["err"].items())
        + "; to the unsharded chunked path (/render&global=0, the ranks' "
        "path in one process) "
        + ", ".join(f"{k} {v:.3g}" for k, v in sh["chunked_err"].items())
        + f"; n_dropped summed over the ranks {sh['n_dropped']}, overflow "
        f"blocks {sh['overflow_blocks']}; the ranks' launches "
        f"{json.dumps(sh['launches'])}; ranks alive after stop "
        f"{sh['alive_after_stop']}; before the first, this process's "
        f"reserved device memory {sh['reserved_gib']:.2f} GiB (released "
        f"before each sharded request) and the card's free memory "
        f"{sh['free_gib']:.2f} of {sh['total_gib']:.2f} GiB; the ranks' peak "
        f"reserved {[round(x, 2) for x in sh['rank_peak_gib']]} GiB: "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def geometry_and_serving(dev, item, smpl, camera, clock_mhz, per_pair,
                         size=512, mesh_n=MESH_N, serve_mesh_n=SERVE_MESH_N,
                         spiral_hw=256):
    """Phase 12: (a)-(e) above (``camera``: the ``(K, R, T)`` of the
    item's output view 1).  Returns the launches of each path (``mesh``,
    ``animate``, ``serve``), the kernels' worst errors and K1's record on
    the grid.  ``size`` (the fixture's), ``mesh_n``, ``serve_mesh_n`` and
    ``spiral_hw`` shrink it for a rehearsal on the CPU."""
    import tempfile

    import torch

    from mpsnerf_torch.geometry import GridSpec

    with tempfile.TemporaryDirectory(prefix="mpsnerf_geometry_") as tmp:
        with kernel_spy() as spy:
            runs, verts, mesh_launches = extraction_on_the_card(
                dev, tmp, spy, size=size, mesh_n=mesh_n)
            anim_launches = animation_on_the_card(
                dev, item, smpl, runs["canonical"], spy)
            serve_launches, shard_launches, shard_errs = serving_on_the_card(
                dev, tmp, item, smpl, camera, spy, spiral_hw=spiral_hw,
                mesh_n=serve_mesh_n)
    paths = {"mesh": mesh_launches, "animate": anim_launches,
             "serve": serve_launches, "sharded_serve": shard_launches}
    ok = all(counts["nearest_vertex"] > 0
             and counts["grid_sample_patch_fwd"] > 0
             for counts in paths.values())
    log(f"[12] K1 and K2 launched on every path: {json.dumps(paths)}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)
    errs = compare_geometry_inputs(spy.calls)
    for key, e in shard_errs.items():
        errs[key] = max(errs.get(key, 0.0), e)
    del spy
    # the carve's 5 cm mask call on the target grid: a 2M-point slice
    # against the plain version, the whole grid timed
    q = GridSpec.from_vertices(verts, n=mesh_n).points_on(dev)
    v = torch.from_numpy(verts).to(dev)
    mid = q.shape[0] // 2
    half = min(1 << 20, mid)
    e, _ = compare_knn(f"{mesh_n}^3 grid mask call, slice",
                       q[mid - half:mid + half].contiguous(), v)
    errs["nearest_vertex"] = max(errs["nearest_vertex"], e)
    grid = knn_grid_record(q, v, clock_mhz, per_pair)
    del q
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return paths, errs, grid


# ---- phase 13: multi-device training and the sharded render ---------------

MESH_RANKS = 4  # (data 2, ray 2) for training, (1, 4) for the render


def _params_digest(model):
    import hashlib

    h = hashlib.sha1()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _tf32_off():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


class _clock:
    """CUDA events on the card (the host clock on the CPU), in ms."""

    def __init__(self, dev):
        import torch

        self.cuda = torch.device(dev).type == "cuda"

    def __enter__(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(2)]
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            self.events[1].record()
            torch.cuda.synchronize()
            self.ms = self.events[0].elapsed_time(self.events[1])
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


def spied(fn, *args):
    """``fn(*args)`` with its launches counted (a spawned rank's entry)."""
    with launch_spy():
        return fn(*args)


def mesh_rank(items, u, delta, serve_item, render_rays, capacity, tile,
              n_verts):
    """One rank of phase 13 (a), (d) and (e), spawned on the card (gloo:
    the ranks share it).  (a) after a plain and a smooth warm-up step, a
    plain and a smooth ``MeshTrainer`` step on a (data 2, ray 2) mesh, the
    row's item, this rank's injected ``u`` and ``delta``; (d) ``make_sharded_render`` (compact, ``capacity`` per rank)
    of a served view on a (1, 4) mesh; both from the seeded weights; launch
    counts around each; rank 0 keeps the kernels' inputs of both steps and
    of the render's first tail tile and compares them with the plain
    versions (e)."""
    import contextlib

    import torch

    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.models.mps_nerf import MPSNeRF
    from mpsnerf_torch.parallel.mesh import (
        DIST, RAY_AXIS, MeshTrainer, make_2d_mesh, make_mesh,
        make_sharded_render,
    )
    from mpsnerf_torch.smpl.model import synthetic_smpl
    from mpsnerf_torch.train import trainer as trainer_mod
    from mpsnerf_torch.train.trainer import TrainConfig, train_rays

    dev = torch.device(DIST["device"])
    on_card = dev.type == "cuda"
    out = {"rank": DIST["rank"], "backend": DIST["backend"],
           "tf32_off": _tf32_off()}
    mesh = make_2d_mesh(2, MESH_RANKS // 2, dev)
    primary = mesh.rank == 0
    smpl = synthetic_smpl(n_verts=n_verts, seed=0, device=dev)
    inp = to_device_input(items[mesh.data_index], dev, rays=True)
    rays = train_rays(inp, 0, dev)
    trainer = MeshTrainer(seeded_model(dev), TrainConfig(
        n_samples=u[0].shape[1]), mesh)
    # both steps from the seeded weights (the references' weights)
    init = copy.deepcopy(trainer.model.state_dict())

    # the collectives' share: the step's reduce, synchronised around
    reduce_ms = []
    pmean_ = trainer_mod.pmean_

    def timed_pmean_(*a, **k):
        with _clock(dev) as c:
            pmean_(*a, **k)
        reduce_ms.append(c.ms)

    capture = (train_capture() if on_card and primary
               else contextlib.nullcontext())
    out["step_ms"], out["reduce_ms"], out["terms"] = [], [], []
    out["digests"], out["grads"] = [], []
    trainer_mod.pmean_ = timed_pmean_
    try:
        reset_counts()
        # a plain and a smooth step first (the products' first calls pick
        # and load their kernels), then the two that are held and timed
        for smooth in (False, True):
            trainer.rays_step(
                smpl, inp, inp, rays, smooth,
                u=torch.from_numpy(u[mesh.rank]).to(dev),
                delta=(torch.from_numpy(delta[mesh.rank]).to(dev)
                       if smooth else None))
        with capture as cap:
            for smooth in (False, True):
                if cap is not None:
                    cap.smooth = smooth
                trainer.model.load_state_dict(init)
                with _clock(dev) as c:
                    terms, _ = trainer.rays_step(
                        smpl, inp, inp, rays, smooth,
                        u=torch.from_numpy(u[mesh.rank]).to(dev),
                        delta=(torch.from_numpy(delta[mesh.rank]).to(dev)
                               if smooth else None))
                out["step_ms"].append(c.ms)
                out["reduce_ms"].append(reduce_ms[-1])
                out["terms"].append([float(t) for t in terms])
                out["digests"].append(_params_digest(trainer.model))
                if primary:
                    out["grads"].append(
                        {n: p.grad.detach().cpu() for n, p in
                         trainer.model.named_parameters()})
        out["launches"] = read_counts()
    finally:
        trainer_mod.pmean_ = pmean_
    errs = {}
    if cap is not None:
        errs = compare_captured(cap.result(), tag="[13] mesh rank 0 ")
    del trainer, cap

    # (d) the sharded render of a served view, from the seeded weights
    model = seeded_model(dev)
    flat = make_mesh(RAY_AXIS, dev)
    tp = to_device_input(serve_item, dev)
    with torch.no_grad():
        latent = model.encode(tp["img_all"])
    ro, rd, nr, fr = (torch.from_numpy(a).to(dev) for a in render_rays)
    render = make_sharded_render(model, flat, u[0].shape[1],
                                 capacity=capacity, tile=tile)
    spy = kernel_spy() if on_card and primary else contextlib.nullcontext()
    reset_counts()
    with spy as sp:
        first = (nth_call(sp, "sharded render first tail tile", MPSNeRF,
                          "query") if sp is not None
                 else contextlib.nullcontext())
        with first, _clock(dev) as c:
            rgb, disp, acc, dropped = render(smpl, tp, tp, latent, ro, rd,
                                             nr, fr)
    out["render_launches"] = read_counts()
    out["render_ms"] = c.ms
    out["n_dropped"] = dropped.cpu().tolist()
    if primary:
        out["render"] = [t.cpu() for t in (rgb, disp, acc)]
    if sp is not None:
        for key, e in compare_render_inputs(sp.calls).items():
            errs[key] = max(errs.get(key, 0.0), e)
    out["errs"] = errs
    return out


def compare_render_inputs(calls, tag="[13]",
                          what="the sharded render's first tail tile"):
    """Phase 13 (e) on the sharded render's first tail tile (12 (d): on
    the sharded request's first query): K1's ids and d2 on each call, K2's
    forward on the latent and the RGB."""
    err, n_knn, n_fwd, ok_all = {"nearest_vertex": 0.0}, 0, 0, True
    for stage, name, args in calls:
        if name == "nearest_vertex_cuda":
            n_knn += 1
            e, _ = compare_knn(f"{tag} {stage}, call {n_knn}", *args[:3])
            err["nearest_vertex"] = max(err["nearest_vertex"], e)
        elif name == "grid_sample_patch_fwd_cuda":
            n_fwd += 1
            which = "rgb" if args[0].shape[1] == 3 else "latent"
            ok, e = compare_fwd(f"{tag} {stage} {which}", *args)
            key = ("grid_sample_patch_fwd", which)
            err[key] = max(err.get(key, 0.0), e)
            ok_all &= ok
    ok_all &= n_knn >= 1 and n_fwd >= 2
    log(f"{tag} captured {what} on rank 0: {n_knn} K1 and {n_fwd} K2 "
        f"forward calls, each against its plain version: "
        f"{'ok' if ok_all else 'FAIL'}")
    if not ok_all:
        raise SystemExit(1)
    return err


def _single_step(model, init, cfg, smpl, inp, rays, u, delta):
    """The single-process step's loss terms and gradients (no mesh) from
    the weights ``init``: ``make_loss_fn`` (smooth where ``delta`` is
    given) and the backward for the parameters."""
    import torch

    from mpsnerf_torch.train.trainer import make_loss_fn

    dev = rays[0].device
    model.load_state_dict(init)
    model.zero_grad(set_to_none=True)
    total, (terms, _) = make_loss_fn(model, cfg, delta is not None)(
        smpl, inp, inp, *rays, u=torch.from_numpy(u).to(dev),
        delta=None if delta is None else torch.from_numpy(delta).to(dev))
    total.backward(inputs=list(model.parameters()))
    return ([float(t.detach()) for t in terms],
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def _item_u(u, d):
    """Item ``d``'s jitter on its whole rays: ray index s of its row takes
    rays s, s + 2, ... with rank ``2 d + s``'s ``u``."""
    import numpy as np

    full = np.empty((2 * u[0].shape[0], u[0].shape[1]), np.float32)
    for s in range(2):
        full[s::2] = u[2 * d + s]
    return full


def _mesh_references(dev, items, u, delta, n_verts, n_samples):
    """Phase 13 (a)'s single-process references in this process, the ray
    shards sliced here (ray index s of 2 takes rays s, s + 2, ...): each
    item's plain loss and gradients on its whole rays; each shard's plain
    and smooth loss and gradients with its rank's ``u`` and ``delta``;
    and this process's repeat of item 0's first shard's two steps, their
    gradients against the first run's (``_grad_err``)."""
    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.smpl.model import synthetic_smpl
    from mpsnerf_torch.train.trainer import TrainConfig, train_rays

    cfg = TrainConfig(n_samples=n_samples)
    smpl = synthetic_smpl(n_verts=n_verts, seed=0, device=dev)
    base = seeded_model(dev)
    init = copy.deepcopy(base.state_dict())
    item_plain, plain, smooth = [], [], []

    def run(inp, rays, uu, dd):
        return _single_step(base, init, cfg, smpl, inp, rays, uu, dd)

    with uncounted():
        for d, item in enumerate(items):
            inp = to_device_input(item, dev, rays=True)
            rays = train_rays(inp, 0, dev)
            item_plain.append(run(inp, rays, _item_u(u, d), None))
            for s in range(2):
                shard = [r[s::2] for r in rays]
                plain.append(run(inp, shard, u[2 * d + s], None))
                smooth.append(run(inp, shard, u[2 * d + s],
                                  delta[2 * d + s]))
                if d == 0 and s == 0:
                    # the card's own spread: the same two steps again
                    again = (run(inp, shard, u[0], None),
                             run(inp, shard, u[0], delta[0]))
    noise = ["%.3g" % _grad_err(a[1], b[1])[0]
             for a, b in zip(again, (plain[0], smooth[0]))]
    del base
    return item_plain, plain, smooth, noise


def _mean_ref(refs):
    import numpy as np

    terms = np.mean([t for t, _ in refs], axis=0)
    grads = {n: sum(g[n] for _, g in refs) / len(refs) for n in refs[0][1]}
    return terms, grads


def _grad_err(got, want):
    """``(max|got - want| / max|want|, both over every parameter; the worst
    tensor's own ratio to its max |want|, and its name)``.  The first is
    the gate: a tensor whose gradient is near 0 everywhere (the first MLP
    layers behind the density bias) moves by the card's fp32 rounding far
    more than its own max."""
    diff = {n: float((got[n].to(want[n].device) - want[n]).abs().max())
            for n in want}
    top = {n: max(float(want[n].abs().max()), 1e-30) for n in want}
    worst = max(want, key=lambda n: diff[n] / top[n])
    return (max(diff.values()) / max(top.values()),
            diff[worst] / top[worst], worst)


def nccl_one_rank(dev, item, u_full, want_terms, want_grads, n_verts):
    """Phase 13 (b): a one-rank NCCL group on this process's card runs the
    same plain step (``make_batched_train_step`` on a (1, 1) mesh) on item
    0, and an ``all_reduce``; the step equals the single-process one."""
    import datetime

    import torch
    import torch.distributed as dist

    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.parallel.mesh import (
        DIST, initialize_distributed, make_2d_mesh, make_batched_train_step,
    )
    from mpsnerf_torch.smpl.model import synthetic_smpl
    from mpsnerf_torch.train.trainer import TrainConfig, train_rays

    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          datetime.timedelta(seconds=120),
                          wait_for_workers=False)
    initialize_distributed(num_processes=1, process_id=0,
                           device=str(torch.device(dev).type), store=store,
                           timeout_s=120)
    try:
        backend = DIST["backend"]
        mesh = make_2d_mesh(1, 1, dev)
        step = make_batched_train_step(seeded_model(dev), TrainConfig(
            n_samples=u_full.shape[1]), mesh)
        inp = to_device_input(item, dev, rays=True)
        smpl = synthetic_smpl(n_verts=n_verts, seed=0, device=dev)
        with uncounted():
            terms, _ = step(smpl, inp, inp, *train_rays(inp, 0, dev),
                            u=torch.from_numpy(u_full).to(dev))
        grads = {n: p.grad for n, p in
                 step.trainer.model.named_parameters()}
        x = torch.arange(8.0, device=dev)
        dist.all_reduce(x)
        reduced = bool(torch.equal(x.cpu(), torch.arange(8.0)))
    finally:
        dist.destroy_process_group()
    terr = max(abs(a - float(b)) for a, b in zip(want_terms, terms))
    gerr, _, _ = _grad_err(grads, want_grads)
    ok = (backend == ("nccl" if torch.device(dev).type == "cuda" else "gloo")
          and terr <= 1e-5 and gerr <= 1e-5 and reduced)
    log(f"[13] (b) one-rank {backend} group on {dev}: the plain step on item "
        f"0, loss {float(terms.total):.6f}, max|term diff| {terr:.3g}, "
        f"max|grad diff| / max|grad| {gerr:.3g} against the single-process "
        f"step; all_reduce {reduced}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)


def mesh_cli(dev, size=512, n_verts=6890, overrides=()):
    """Phase 13 (c): ``run_nerf_batch_torch.main`` on the flagship config
    as shipped (``batch_size 2``) with ``--mesh_devices 2`` over phase 9's
    THuman-layout fixture, 2 batch steps (an item's 24 views each): the
    CLI starts the 2 ranks (gloo, sharing the card); both take the 48
    view-steps with the mesh's averaged logs, finite, nothing dropped; rank
    0 alone writes the 2 checkpoints and the scalars (one row a batch
    step: another writer would add rows); the second batch step's seconds
    between the scalars' rows."""
    import json as json_mod
    import math
    import os
    import pathlib
    import tempfile

    import torch

    import run_nerf_batch_torch
    from mpsnerf_torch.parallel.mesh import pick_backend

    config = pathlib.Path(__file__).resolve().parent / "configs"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="mpsnerf_mesh_cli_") as tmp:
        t0 = time.perf_counter()
        train_root = write_thuman_fixture(tmp, size, n_verts)
        fixture_s = time.perf_counter() - t0
        base = os.path.join(tmp, "logs")
        try:
            os.chdir(tmp)  # the loaders read data/ from the working dir
            t0 = time.perf_counter()
            run = run_nerf_batch_torch.main([
                "--config", str(config / "canonical_transformer.txt"),
                "--data_root", train_root, "--mesh_devices", "2",
                "--basedir", base, "--N_iteration", "47", "--i_print",
                "24", "--i_weights", "24", "--i_testset", "1000000",
                "--device", str(torch_type(dev)), *overrides])
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        ranks = run.ranks
        exp = run.args.expname
        ckpts = sorted(os.listdir(os.path.join(base, exp, "checkpoints")))
        with open(os.path.join(base, "summaries", exp,
                               "scalars.jsonl")) as f:
            rows = [json_mod.loads(x) for x in f]
        finite = all(math.isfinite(v) for r in ranks for lg in r["logs"]
                     for v in lg.values())
        backend = pick_backend(torch.device(dev), 2)[0]
        ok = (len(ranks) == 2 and run.args.batch_size == 2
              and [(r["rank"], r["data_index"], r["ray_index"])
                   for r in ranks] == [(0, 0, 0), (1, 1, 0)]
              and all(r["backend"] == backend for r in ranks)
              and all(r["global_step"] == 48 for r in ranks)
              and ranks[0]["logs"] == ranks[1]["logs"]
              and ckpts == ["000024", "000048"]
              and [r["step"] for r in rows] == [24, 48]
              and finite
              and max(lg["n_dropped"] for lg in ranks[0]["logs"]) == 0)
        step_s = rows[-1]["time"] - rows[0]["time"]
        log(f"[13] (c) CLI, flagship config as shipped (batch_size 2), "
            f"--mesh_devices 2 (data 2, ray 1) over {ranks[0]['backend']}: "
            f"fixture {size}^2 written in {fixture_s:.1f} s; {wall:.1f} s "
            f"wall (the ranks' start, set-up and 2 batch steps); the second "
            f"batch step {step_s:.2f} s (between rank 0's scalar rows); "
            f"item losses {[round(lg['loss'], 5) for lg in ranks[0]['logs']]}"
            f"; checkpoints {ckpts}, scalar rows at steps "
            f"{[r['step'] for r in rows]}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)


def torch_type(dev):
    import torch

    return torch.device(dev).type


def multi_device(dev, serve_item, size=512, n_verts=6890, n_rays=1000,
                 n_samples=128, tile=16384, cli_size=512, cli_overrides=()):
    """Phase 13: (a) 4 ranks on the card over gloo as a (data 2, ray 2)
    mesh, two items of phase 5's scene (one a row, in the loader's
    body-first ray order; the ranks shard them by stride), ``n_rays`` a
    view, one plain and one smooth step with injected ``u`` and smooth
    deltas, against references computed in this process on shards sliced
    here: the losses against the item mean (plain) and the shard mean
    (smooth) to 1e-5, the reduced gradients within 1e-5 of max |g| of the
    shard mean, parameters bit-equal across the ranks, TF32 off, step ms
    and the collectives' share by CUDA events in every rank; (d) the same
    ranks render a served view of ``serve_item`` (its mask-at-box rays in
    scan order) sharded 4 ways on the compact path, equal
    to the single-process ``render_rays_compact`` within 1e-5, every
    rank's ``n_dropped`` 0; (e) rank 0's kernel comparisons on the steps'
    and the render's first tail tile's inputs; (c) the CLI with
    ``--mesh_devices 2``; (b) a one-rank NCCL group.  Returns the launches
    (summed over the ranks) and the kernels' worst errors."""
    import numpy as np
    import torch

    from mpsnerf_torch.data import (
        HOST_ONLY_KEYS, RAY_KEYS, attach_body_grid, to_device_input,
    )
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset
    from mpsnerf_torch.eval.runner import view_rays
    from mpsnerf_torch.parallel.launch import Ranks
    from mpsnerf_torch.renderer.render import (
        plan_rays_compact, render_rays_compact,
    )
    from mpsnerf_torch.smpl.model import synthetic_smpl

    on_card = torch_type(dev) == "cuda"
    t0 = time.perf_counter()
    ds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=size,
                               n_verts=n_verts, split="train", n_rays=n_rays)
    items = [ds.get_item(0, instance_idx=0) for _ in range(2)]
    rng = np.random.default_rng(13)
    shard = n_rays // 2
    u = [rng.uniform(size=(shard, n_samples)).astype(np.float32)
         for _ in range(MESH_RANKS)]
    delta = [(0.01 * rng.normal(size=(shard * n_samples, 3)))
             .astype(np.float32) for _ in range(MESH_RANKS)]
    # what the ranks need of the items (their device inputs)
    items = [{k: v for k, v in it.items()
              if k not in HOST_ONLY_KEYS or k in RAY_KEYS} for it in items]
    # the served view: view 1's mask-at-box rays in scan order, cut to a
    # multiple of 4
    serve = attach_body_grid(copy.copy(serve_item))
    sel = [np.asarray(x) for x in view_rays(
        serve, 1, "cpu", serve["mask_at_box_all"][1])[0]]
    keep = sel[0].shape[0] // MESH_RANKS * MESH_RANKS
    render_rays = [np.ascontiguousarray(x[:keep]) for x in sel]
    smpl = synthetic_smpl(n_verts=n_verts, seed=0, device=dev)
    tp = to_device_input(serve, dev)
    r_rays = [torch.from_numpy(x).to(dev) for x in render_rays]
    with uncounted():
        n_cand = [int(plan_rays_compact(smpl, tp, *(x[i::MESH_RANKS]
                                                    for x in r_rays),
                                        n_samples).n_valid)
                  for i in range(MESH_RANKS)]
    capacity = -(-max(n_cand) // tile) * tile
    log(f"[13] scene: 2 items of phase 5's scene ({size}^2, {n_verts} "
        f"verts, {n_rays} rays a view), served view 1: "
        f"{r_rays[0].shape[0]} mask-at-box rays, candidates per shard "
        f"{n_cand}, capacity {capacity} a rank; built in "
        f"{time.perf_counter() - t0:.1f} s")
    if on_card:
        torch.cuda.empty_cache()

    # (a), (d), (e) on 4 ranks; the references here meanwhile
    t0 = time.perf_counter()
    ranks = Ranks(spied, MESH_RANKS, (
        mesh_rank, items, u, delta, {k: v for k, v in serve.items()
                          if k not in HOST_ONLY_KEYS},
        render_rays, capacity, tile, n_verts),
        device=torch_type(dev), timeout_s=600)
    item_refs, plain_refs, smooth_refs, noise = _mesh_references(
        dev, items, u, delta, n_verts, n_samples)
    ref_s = time.perf_counter() - t0
    results = ranks.wait(600)
    log(f"[13] 4 ranks done {time.perf_counter() - t0:.1f} s after their "
        f"start (the single-process references took {ref_s:.1f} s of it)")
    # the single-process render, the card to itself
    with uncounted(), torch.no_grad():
        model = seeded_model(dev)
        latent = model.encode(tp["img_all"])
        with _clock(dev) as c:
            want = render_rays_compact(
                model, smpl, tp, tp, latent, *r_rays, n_samples,
                capacity=-(-sum(n_cand) // tile) * tile, tile=tile)
        single_render_ms = c.ms
        want = [t.cpu() for t in want]
    del model, latent

    # (a) the steps, against the single-process references of this
    # process on shards sliced here: the loss against the item mean (plain,
    # the items' whole rays) or the shard mean (smooth); the gradients
    # against the mean over the same ray shards, with the plain step's item
    # mean beside it (a 1000-row sum against two 500-row ones: the
    # products' fp32 order moves it by ~1e-5 of max|g|)
    ok_all = True
    item_terms, item_grads = _mean_ref(item_refs)
    for i, (name, refs) in enumerate((("plain", plain_refs),
                                      ("smooth", smooth_refs))):
        shard_terms, grads = _mean_ref(refs)
        terms = item_terms if i == 0 else shard_terms
        got = [r["terms"][i] for r in results]
        same = all(g == got[0] for g in got)
        terr = float(np.max(np.abs(np.asarray(got[0]) - terms)))
        gerr, tensor_err, worst = _grad_err(results[0]["grads"][i], grads)
        item_gerr = _grad_err(results[0]["grads"][i], item_grads)[0]
        ms = [round(r["step_ms"][i], 1) for r in results]
        share = [round(100 * r["reduce_ms"][i] / r["step_ms"][i], 1)
                 for r in results]
        ok = same and terr <= 1e-5 and gerr <= 1e-5 and got[0][-1] == 0
        ok_all &= ok
        log(f"[13] (a) {name} mesh step: loss {got[0][0]:.6f} (the "
            f"single-process {'item' if i == 0 else 'shard'} mean "
            f"{terms[0]:.6f}), max|term diff| {terr:.3g}, max|grad diff| / "
            f"max|grad| to the shard mean {gerr:.3g} (the worst tensor to "
            f"its own max {tensor_err:.3g}, {worst})"
            + (f", to the item mean {item_gerr:.3g}" if i == 0 else "")
            + f"; this process's repeat {noise[i]}; n_dropped "
            f"{got[0][-1]:g}, terms equal on every rank {same}; ms per step "
            f"by each rank's CUDA events {ms}, of which the reduce {share} "
            f"%: {'ok' if ok else 'FAIL'}")
    digests = [r["digests"] for r in results]
    ok = (all(d == digests[0] for d in digests)
          and digests[0][0] != digests[0][1]
          and all(r["tf32_off"] for r in results)
          and {r["backend"] for r in results} == {"gloo"})
    ok_all &= ok
    log(f"[13] (a) parameters bit-equal on the 4 ranks after each step "
        f"{all(d == digests[0] for d in digests)}; TF32 off on every rank "
        f"{all(r['tf32_off'] for r in results)}; backend "
        f"{sorted({r['backend'] for r in results})}: "
        f"{'ok' if ok else 'FAIL'}")
    need = [k for k in KERNEL_NAMES if k != "nearest_vertex_packed"]
    steps_launched = {k: sum(r["launches"][k] for r in results)
                      for k in results[0]["launches"]}
    render_launched = {k: sum(r["render_launches"][k] for r in results)
                       for k in results[0]["render_launches"]}
    ok = not on_card or (
        all(r["launches"][k] > 0 for r in results for k in need)
        and all(r["render_launches"][k] > 0 for r in results for k in (
            "nearest_vertex", "grid_sample_patch_fwd")))
    ok_all &= ok
    log(f"[13] launches on the steps (4 ranks) {json.dumps(steps_launched)}; "
        f"on the render {json.dumps(render_launched)}; every kernel of each "
        f"path on every rank: {'ok' if ok else 'FAIL'}")

    # (d) the render
    got = results[0]["render"]
    err = max(float((a - b).abs().max()) for a, b in zip(got, want[:3]))
    nd = [r["n_dropped"] for r in results]
    ok = (err <= 1e-5 and all(x == [0.0] * MESH_RANKS for x in nd)
          and int(want[3]) == 0 and bool(np.isfinite(got[0]).all())
          and float((got[2] > 0.5).float().mean()) > 0.01)
    ok_all &= ok
    r_ms = [round(r["render_ms"], 1) for r in results]
    log(f"[13] (d) sharded render, compact path, {r_rays[0].shape[0]} rays "
        f"of a {size}^2 view on 4 ranks: max|diff| to the single-process "
        f"render_rays_compact {err:.3g}, n_dropped per rank {nd[0]}, acc > "
        f"0.5 on {100 * float((got[2] > 0.5).float().mean()):.1f} % of the "
        f"rays; ms by each rank's CUDA events {r_ms} (single process "
        f"{single_render_ms:.1f}): {'ok' if ok else 'FAIL'}")
    if not ok_all:
        raise SystemExit(1)
    errs = results[0]["errs"]

    # (c) the CLI, then (b) the one-rank NCCL group
    mesh_cli(dev, cli_size, overrides=cli_overrides)
    nccl_one_rank(dev, items[0], _item_u(u, 0), item_refs[0][0],
                  item_refs[0][1], n_verts)
    return ({"multi_device": steps_launched,
             "sharded_render": render_launched}, errs)


# ---- phase 14: the jax-free tools ------------------------------------------

# the JAX proofs' JSON keys (``tools/*_proof.py``; the pair proof's and
# every port proof's ``setup`` names the card)
PROOF_KEYS = {
    "train_proof": {"setup", "train_minutes", "history",
                    "heldout_view_metrics", "mean_heldout_psnr",
                    "mean_heldout_ssim"},
    "generalization_proof": {"setup", "history", "results"},
    "pair_train_proof": {
        "mode", "setup", "items", "view_steps", "wall_s",
        "same_pose_psnr_first_quarter", "same_pose_psnr_last_quarter",
        "cross_pose_items", "cross_pose_psnr_first_quarter",
        "cross_pose_psnr_last_quarter", "cross_pose_loss_last", "history"},
}
PROOF_FILES = {"train_proof": "torch_synthetic_training_proof.json",
               "generalization_proof": "torch_generalization_proof.json",
               "pair_train_proof": "torch_pair_train_proof.json"}


def _validate(root):
    """``mpsnerf_torch.tools.validate_dataset`` on a THuman root: (exit
    code, its PASS/FAIL lines, its output)."""
    import contextlib
    import io

    from mpsnerf_torch.tools import validate_dataset

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = validate_dataset.main(["--type", "thuman", root])
    text = buf.getvalue()
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("  PASS ", "  FAIL "))]
    return code, lines, text


def tools_on_the_card(dev, size=512, n_verts=6890, proof_size=64,
                      proof_verts=6890, proof_items=2):
    """Phase 14: (a) the dataset validator on phase 9's THuman fixture
    (exit 0, its 10 checks PASS) and on a copy with one mask removed (exit
    1, naming that file); (b) the three learning proofs on the card at a
    smoke size (``proof_items`` items at ``proof_size``^2), written into a
    temporary directory: finite losses, the JAX proofs' JSON keys, K1 and
    K2 launched.  Returns the proofs' launches."""
    import contextlib
    import io
    import json as json_
    import math
    import os
    import shutil
    import tempfile

    import torch

    from mpsnerf_torch.tools import (
        generalization_proof, pair_train_proof, train_proof,
    )

    with tempfile.TemporaryDirectory(prefix="mpsnerf_tools_") as tmp:
        t0 = time.perf_counter()
        root = write_thuman_fixture(tmp, size, n_verts)
        code, lines, _ = _validate(root)
        ok = code == 0 and len(lines) == 10 and all(
            ln.startswith("  PASS") for ln in lines)
        broken = os.path.join(tmp, "broken")
        shutil.copytree(root, broken)
        gone = os.path.join(broken, "mask_cihp", "00", "0.png")
        os.remove(gone)
        code_b, lines_b, text_b = _validate(broken)
        failed = [ln.split(":")[0].strip() for ln in lines_b
                  if ln.startswith("  FAIL")]
        ok_b = code_b == 1 and gone in text_b
        log(f"[14] (a) validate_dataset on phase 9's THuman fixture "
            f"({size}^2, 24 cameras): exit {code}, {len(lines)} checks "
            f"PASS {sum(ln.startswith('  PASS') for ln in lines)}; a mask "
            f"removed: exit {code_b}, {failed}, the file named "
            f"{gone in text_b}; {time.perf_counter() - t0:.1f} s: "
            f"{'ok' if ok and ok_b else 'FAIL'}")
        if not (ok and ok_b):
            log("\n".join(lines + lines_b))
            raise SystemExit(1)

        out_dir = os.path.join(tmp, "proofs")
        argv = ["--device", str(dev), "--size", str(proof_size),
                "--n_verts", str(proof_verts), "--items", str(proof_items),
                "--out", out_dir]
        reset_counts()
        ok_all = True
        for name, mod, extra in (
                ("train_proof", train_proof, []),
                ("generalization_proof", generalization_proof, []),
                ("pair_train_proof", pair_train_proof, ["--check", "0"])):
            t0 = time.perf_counter()
            counts0 = read_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                mod.main(argv + extra)
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            counts = {k: v - counts0[k] for k, v in read_counts().items()}
            with open(os.path.join(out_dir, PROOF_FILES[name])) as f:
                got = json_.load(f)
            losses = [h["loss"] for h in got["history"]]
            ok = (set(got) == PROOF_KEYS[name]
                  and all(math.isfinite(x) for x in losses)
                  and counts["nearest_vertex"] > 0
                  and counts["grid_sample_patch_fwd"] > 0
                  and counts["grid_sample_patch_bwd"] > 0)
            ok_all &= ok
            log(f"[14] (b) {name} ({proof_items} items at {proof_size}^2, "
                f"{proof_verts} vertices): {time.perf_counter() - t0:.1f} "
                f"s; losses {[round(x, 5) for x in losses]}; JSON keys "
                f"{'as JAX' if set(got) == PROOF_KEYS[name] else sorted(got)}"
                f"; setup {got['setup']!r}; launches {json.dumps(counts)}: "
                f"{'ok' if ok else 'FAIL'}")
        launches = read_counts()
    if not ok_all:
        raise SystemExit(1)
    return launches


def merge_path(records, launches, errs):
    """Add a path's launches (``launches_<run>``) and the worst errors of
    its comparisons (K2's keyed by latent or RGB) to the kernel records."""
    for rec in records:
        for run, counts in launches.items():
            rec[f"launches_{run}"] = counts[rec["name"]]
        for key, e in errs.items():
            if key == rec["name"]:
                rec["max_abs_err"] = max(rec["max_abs_err"], e)
            elif key[0] == rec["name"]:
                sub = rec if key[1] == "latent" else rec["rgb"]
                sub["max_abs_err"] = max(sub["max_abs_err"], e)


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-after", type=int, default=14,
                    help="end after this phase (no result lines)")
    stop_after = ap.parse_args(argv).stop_after

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    with launch_spy():
        return smoke(stop_after)


def smoke(stop_after):
    """Phases 1 to ``stop_after``; returns the exit code."""
    import numpy as np
    import torch

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
    try:
        import PIL
        log(f"[1] PIL {PIL.__version__} imports (JPEG images can be read)")
    except ImportError:
        log("[1] PIL does not import: JPEG images cannot be read, PNG can")
    clock_mhz = card_clock_mhz()
    t0 = time.perf_counter()
    sources = ("nearest_vertex", "nearest_vertex_packed", "grid_sample_patch",
               "layer_norm")
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
    for label, v in bucket_tables(verts):
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
    ln_err = compare_layer_norm(dev)
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
    graphs = renderer._tile_graphs
    # the warm-up view encodes the latent and captures the tail's graphs:
    # the first tile runs eagerly once, then is captured (4 LayerNorm
    # launches each), and every tile replays
    reset_counts()
    renderer.render_view(item, item, 1)
    warm = read_counts()
    latent = renderer._latent_for(item, renderer._device_side(item))
    cl = latent.is_contiguous(memory_format=torch.channels_last)
    ok = (cl and warm["layer_norm"] == 4 + 4
          and graphs.graph_tiles == graphs.tiles > 0)
    log(f"[4] warm-up view: the encoded latent {tuple(latent.shape)} "
        f"channels-last {cl} (strides {latent.stride()}); tail tiles "
        f"{graphs.tiles} ({graphs.graph_tiles} replayed), layer_norm "
        f"launches {warm['layer_norm']} (4 eager, 4 captured): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        return 1
    del latent
    reset_counts()
    launches, ln_launches = [], []
    for k in (1, 3, 5):
        before = read_counts()
        tiles, graph_tiles = graphs.tiles, graphs.graph_tiles
        rgb = renderer.finish_view(renderer.render_view_async(item, item, k))
        out = renderer.last_view
        after = read_counts()
        n_launch = after["nearest_vertex"] - before["nearest_vertex"]
        n_fwd = (after["grid_sample_patch_fwd"]
                 - before["grid_sample_patch_fwd"])
        n_ln = after["layer_norm"] - before["layer_norm"]
        n_tiles = graphs.tiles - tiles
        replayed = graphs.graph_tiles - graph_tiles
        opaque = float((out.acc > 0.5).mean())
        finite = bool(np.isfinite(rgb).all())
        ok = (out.n_dropped == 0 and finite and opaque > 0.01
              and n_launch >= 2 and n_fwd >= 2
              and replayed == n_tiles > 0 and n_ln == 0
              and rgb.shape == (512 * 512, 3))
        launches.append(n_launch)
        ln_launches.append(n_ln)
        log(f"[4] view {k}: hit rays {out.hit_rays}, candidates "
            f"{out.n_candidates}, capacity {out.capacity}, body points "
            f"{out.n_body}, fine capacity {out.fine_capacity}, tail tiles "
            f"{n_tiles} ({replayed} replayed), knn launches {n_launch}, K2 "
            f"forward launches {n_fwd}, layer_norm launches {n_ln}, n_dropped "
            f"{out.n_dropped}, acc>0.5 on {100 * opaque:.1f} % of pixels, "
            f"finite {finite}: {'ok' if ok else 'FAIL'}")
        if not ok:
            return 1
    serving_launches = read_counts()
    log(f"[4] launches over the 3 views {json.dumps(serving_launches)}; per "
        f"served view (view 1): K1 {launches[0]}, bucket builds "
        f"{serving_launches['vertex_buckets'] // 3}, layer_norm "
        f"{ln_launches[0]}")
    tail_sets, n_tiles = capture_view_knn(renderer, item, 1)
    log(f"[4] captured K1's inputs of view 1: the fine pre-pass and tail "
        f"tile {n_tiles // 2} of {n_tiles}")
    del renderer, model
    torch.cuda.empty_cache()

    # ---- 5. training at full width
    train_launches, captured = train_full_width(dev)
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
    records.append(buckets_record(fine_v, train_launches, serving_launches))
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
    records.append(layer_norm_record(dev, ln_err, train_launches,
                                     serving_launches, ln_launches,
                                     warm["layer_norm"]))
    if stop_after <= 7:
        return 0

    # ---- 8. the eval entry point at full width
    merge_path(records, *eval_full_width(dev, ds, smpl))
    if stop_after <= 8:
        return 0

    # ---- 9. the CLI on a THuman-layout fixture at full width
    merge_path(records, *cli_on_the_card(dev))
    log(f"[9] total {time.perf_counter() - t_start:.0f} s")
    if stop_after <= 9:
        return 0

    # ---- 10. every option and variant; the shipped H36M config
    t0 = time.perf_counter()
    variant_launches, _, calls = train_variants(dev)
    view_launches, _ = variant_views(dev, item, smpl)
    h36m_launches, h36m_errs = h36m_cli_on_the_card(dev)
    errs, bwd_inputs = compare_variant_inputs(calls)
    del calls
    bwd_times = time_variant_bwd(bwd_inputs)
    merge_path(records, {"variants": variant_launches,
                         "variant_views": view_launches, **h36m_launches},
               errs)
    merge_path(records, {}, h36m_errs)
    for rec in records:
        if rec["name"] == "grid_sample_patch_bwd":
            rec["variant_plain_step"] = bwd_times
    log(f"[10] phase in {time.perf_counter() - t0:.0f} s; total "
        f"{time.perf_counter() - t_start:.0f} s")
    if stop_after <= 10:
        return 0

    # ---- 11. the legacy family and the legacy eval at full width
    t0 = time.perf_counter()
    legacy_launches, _, calls = train_legacy(dev)
    legacy_view_launches, _, view_calls = legacy_view(dev)
    cli_launches, _, cli_calls = legacy_cli_on_the_card(dev)
    errs = compare_legacy_inputs(calls + view_calls + cli_calls)
    del calls, view_calls, cli_calls
    merge_path(records, {"legacy": legacy_launches,
                         "legacy_view": legacy_view_launches,
                         **cli_launches}, errs)
    log(f"[11] phase in {time.perf_counter() - t0:.0f} s; total "
        f"{time.perf_counter() - t_start:.0f} s")
    if stop_after <= 11:
        return 0

    # ---- 12. geometry and serving at full width
    t0 = time.perf_counter()
    geo_launches, errs, grid = geometry_and_serving(
        dev, item, smpl, ds.cameras[1], clock_mhz, instr["nearest_vertex"])
    merge_path(records, geo_launches, errs)
    records[0]["shapes"]["mesh_grid"] = grid
    log(f"[12] phase in {time.perf_counter() - t0:.0f} s; total "
        f"{time.perf_counter() - t_start:.0f} s")
    if stop_after <= 12:
        return 0

    # ---- 13. multi-device training and the sharded render
    t0 = time.perf_counter()
    merge_path(records, *multi_device(dev, item))
    log(f"[13] phase in {time.perf_counter() - t0:.0f} s; total "
        f"{time.perf_counter() - t_start:.0f} s")
    if stop_after <= 13:
        return 0

    # ---- 14. the jax-free tools
    t0 = time.perf_counter()
    merge_path(records, {"tools": tools_on_the_card(dev)}, {})
    log(f"[14] phase in {time.perf_counter() - t0:.0f} s; total "
        f"{time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": records}), flush=True)
    # ---- 15. the device line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
