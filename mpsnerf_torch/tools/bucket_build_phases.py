"""Where K1's bucket build spends its time on the card: the SM cycles of
each phase of ``vertex_buckets_kernel``.

    python -m mpsnerf_torch.tools.bucket_build_phases [--nv 6890]

It builds ``mpsnerf_torch/csrc/nearest_vertex.cu`` with
``-DMPSNERF_BUILD_STAMPS`` into a library of its own (through
``cuda_build``; the kernels' library has no stamps): thread 0 of the one
block reads the SM clock at the start and after each phase.  On a random
table of ``nv`` vertices (normal, sd 0.4, from a ``torch.Generator`` on
the card seeded with :data:`SEED`) it runs the build :data:`REPS` times,
checks the last result bit-equal to ``build_vertex_buckets_plain``, and
prints the card's name, power limit and maximum SM clock, then the median
cycles of each phase.  The stamped kernel has one more barrier (before
the last stamp) than the kernel the path launches.  It needs a CUDA
device and exits without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from mpsnerf_torch import cuda_build
from mpsnerf_torch.ops import knn

PHASES = ("box", "runs", "merge", "buckets")  # between consecutive stamps
REPS = 20
SEED = 0


def _stamped_library() -> ctypes.CDLL:
    lib = cuda_build.load_kernel_library("nearest_vertex",
                                         ("-DMPSNERF_BUILD_STAMPS",))
    lib.mpsnerf_vertex_buckets.argtypes = \
        knn._ARGTYPES["mpsnerf_vertex_buckets"] + [ctypes.c_void_p]
    lib.mpsnerf_vertex_buckets.restype = ctypes.c_int
    lib.mpsnerf_build_stamps.argtypes = [ctypes.c_void_p]
    lib.mpsnerf_build_stamps.restype = ctypes.c_int
    return lib


def phase_cycles(verts: torch.Tensor) -> dict:
    """``{"box", "runs", "merge", "buckets", "total"}``: median SM cycles
    of each phase of the build of ``verts`` (contiguous float32 on a CUDA
    device) over :data:`REPS` builds, and ``"bit_equal"`` to the plain
    version."""
    lib = _stamped_library()
    stamps = (ctypes.c_int64 * 5)()
    runs = []
    with torch.cuda.device(verts.device):
        stream = torch.cuda.current_stream(verts.device).cuda_stream
        for _ in range(REPS):
            table, boxes, scratch = knn._build_buffers(verts)
            err = lib.mpsnerf_vertex_buckets(
                verts.data_ptr(), verts.shape[0],
                0 if scratch is None else scratch.data_ptr(),
                table.data_ptr(), boxes.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"stamped build failed: CUDA error {err}")
            torch.cuda.synchronize()
            err = lib.mpsnerf_build_stamps(ctypes.addressof(stamps))
            if err != 0:
                raise RuntimeError(f"reading the stamps: CUDA error {err}")
            runs.append([stamps[i + 1] - stamps[i] for i in range(4)])
    plain = knn.build_vertex_buckets_plain(verts)
    out = {name: statistics.median(r[i] for r in runs)
           for i, name in enumerate(PHASES)}
    out["total"] = statistics.median(sum(r) for r in runs)
    out["bit_equal"] = bool(torch.equal(table, plain.table)
                            and torch.equal(boxes, plain.boxes))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nv", type=int, default=6890)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bucket_build_phases needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    v = torch.randn(args.nv, 3, generator=g, device="cuda") * 0.4
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = phase_cycles(v)
    print(card.strip())
    print(json.dumps({"nv": args.nv, **res}))
    return 0 if res["bit_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
