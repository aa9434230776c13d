// Exact 1-NN of fp32 3-D query points against a vertex table, for Hopper
// (sm_90a).  Built by mpsnerf_torch/cuda_build.py with nvcc into a shared
// library with a plain C interface, bound with ctypes
// (mpsnerf_torch/ops/knn.py).
//
// Replaces: mpsnerf_tpu/ops/knn.py:_nn_kernel (launched by
// nearest_vertex_pallas).  Same function, not the same structure: the TPU
// kernel packs a 13-bit vertex id into the low mantissa bits of d^2 and
// min-reduces the packed key over vertex tiles.  Here every thread keeps a
// running (min d^2, argmin) in registers, so there is no id packing and no
// limit on the vertex count.
//
// What bounds it on this card: fp32 CUDA-core arithmetic.  Each
// query-vertex pair costs about 8 fp32 operations (3 subtractions, 3
// products, 2 additions) plus a compare and select; there is no product
// that tensor cores could take without giving up the diff form, and the
// inputs are tiny (N x 12 bytes + V x 12 bytes), so memory traffic is
// negligible.  What the design does about it:
//   * the vertex table streams through shared memory in tiles of float4,
//     so each vertex is one broadcast 16-byte shared load for the whole
//     warp, reused by every query of the block;
//   * each thread carries QPT queries, so one shared load feeds QPT pairs
//     and the loop has QPT independent dependency chains;
//   * d^2 uses the diff form sum_d (q_d - v_d)^2 with explicit round-to-
//     nearest intrinsics (no FMA contraction), so it is bit-identical to
//     the plain PyTorch version ((dx*dx + dy*dy) + dz*dz), and a strict <
//     over ascending vertex ids keeps the lowest index on ties.
// Small launches (the renderer's 16384-point tail tiles) take QPT = 1 so
// that more blocks fill the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVertTile = 2048;  // 2048 x 16 B = 32 KB of shared memory

template <int QPT>
__global__ void __launch_bounds__(kThreads)
nearest_vertex_kernel(const float* __restrict__ q,
                      const float* __restrict__ v,
                      int64_t n, int nv, int64_t* __restrict__ ids) {
  __shared__ float4 tile[kVertTile];

  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kThreads * QPT) + threadIdx.x;
  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int arg[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * kThreads;
    const bool ok = i < n;
    qx[k] = ok ? q[3 * i + 0] : 0.f;
    qy[k] = ok ? q[3 * i + 1] : 0.f;
    qz[k] = ok ? q[3 * i + 2] : 0.f;
    best[k] = INFINITY;
    arg[k] = 0;
  }

  for (int t0 = 0; t0 < nv; t0 += kVertTile) {
    const int cnt = min(kVertTile, nv - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* p = v + 3 * static_cast<int64_t>(t0 + j);
      tile[j] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 w = tile[j];
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        const float dx = __fsub_rn(qx[k], w.x);
        const float dy = __fsub_rn(qy[k], w.y);
        const float dz = __fsub_rn(qz[k], w.z);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (d2 < best[k]) {
          best[k] = d2;
          arg[k] = t0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * kThreads;
    if (i < n) ids[i] = arg[k];
  }
}

template <int QPT>
void launch(const float* q, const float* v, int64_t n, int nv, int64_t* ids,
            cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * QPT;
  const int64_t blocks = (n + per_block - 1) / per_block;
  nearest_vertex_kernel<QPT><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(q, v, n, nv, ids);
}

}  // namespace

// q: (n, 3) f32, v: (nv, 3) f32, ids: (n,) int64, all contiguous on the
// current device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int mpsnerf_nearest_vertex(const void* q, const void* v,
                                      int64_t n, int64_t nv, void* ids,
                                      void* stream) {
  if (n <= 0) return 0;
  if (nv <= 0 || nv > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* vf = static_cast<const float*>(v);
  int64_t* out = static_cast<int64_t*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // QPT = 4 once it still leaves at least two blocks per SM
  if (n >= 2LL * 132 * kThreads * 4) {
    launch<4>(qf, vf, n, static_cast<int>(nv), out, s);
  } else {
    launch<1>(qf, vf, n, static_cast<int>(nv), out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
