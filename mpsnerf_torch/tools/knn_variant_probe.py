"""Time the packed-key 1-NN kernel's launch variants on the card (the
port's counterpart of ``tools/knn_variant_probe.py``).

    python -m mpsnerf_torch.tools.knn_variant_probe [--n N] [--nv V]

At the probe's shape (2,572,288 queries uniform in [-1.2, 1.2]^3 against
6890 vertices uniform in [-1, 1]^3, from a seeded ``torch.Generator`` on
the card) it times with CUDA events: the exact 1-NN kernel K1
(``nearest_vertex_cuda``, its buckets built beforehand; these queries lie
in random order, K1's worst case), the packed-key kernel
(``csrc/nearest_vertex_packed.cu``) at each launch variant (queries per
thread x vertex tile in shared memory), and the packed kernel's plain
PyTorch version once.  It prints each time, the share of ids equal to
K1's, and whether each variant's ids equal the plain version's exactly.
It needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import torch

from mpsnerf_torch.ops import knn

VARIANTS = tuple((qpt, tile) for qpt in (1, 2, 4)
                 for tile in (128, 1152, 2304))


def cuda_ms(fn: Callable, reps: int) -> float:
    """Mean ms per call by CUDA events over ``reps`` calls, after one
    warm-up call."""
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


def probe_inputs(n: int, nv: int, seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.rand(n, 3, generator=g, device=device) * 2.4 - 1.2
    v = torch.rand(nv, 3, generator=g, device=device) * 2.0 - 1.0
    return q, v


def run_probe(n: int = 2_572_288, nv: int = 6890, seed: int = 0,
              device="cuda", reps: int = 10, log: Callable = print) -> Dict:
    """Time K1, every packed variant and the plain packed version once;
    returns ``{"k1_ms", "plain_ms", "variants": {"qpt<q>_tile<t>": {"ms",
    "equal_k1", "equal_plain"}}, "shape"}``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probe times the card; got device {device}")
    q, v = probe_inputs(n, nv, seed, device)
    buckets = knn.build_vertex_buckets(v)
    k1_ms = cuda_ms(lambda: knn.nearest_vertex_cuda(q, v, buckets), reps)
    _, ids_k1 = knn.nearest_vertex_cuda(q, v, buckets)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, ids_plain = knn.nearest_vertex_packed_plain(q, v, block_elems=1 << 26)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    log(f"[probe] {n} x {nv}: K1 {k1_ms:.3f} ms, packed plain "
        f"{plain_ms:.1f} ms (once)")
    out = {"shape": [n, nv], "k1_ms": k1_ms, "plain_ms": plain_ms,
           "variants": {}}
    for qpt, tile in VARIANTS:
        ms = cuda_ms(lambda: knn.nearest_vertex_packed_cuda(
            q, v, qpt=qpt, tile=tile), reps)
        _, ids = knn.nearest_vertex_packed_cuda(q, v, qpt=qpt, tile=tile)
        rec = {"ms": ms,
               "equal_k1": float((ids == ids_k1).double().mean()),
               "equal_plain": bool(torch.equal(ids, ids_plain))}
        out["variants"][f"qpt{qpt}_tile{tile}"] = rec
        log(f"[probe]   packed qpt={qpt} tile={tile:4d}: {ms:8.3f} ms, "
            f"ids equal to K1 {rec['equal_k1']:.6f}, equal to plain "
            f"{rec['equal_plain']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2_572_288)
    ap.add_argument("--nv", type=int, default=6890)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    print(torch.cuda.get_device_name(0))
    print(json.dumps(run_probe(args.n, args.nv, args.seed, "cuda",
                               args.reps)))


if __name__ == "__main__":
    main()
