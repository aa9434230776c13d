// Packed-key 1-NN of fp32 3-D query points against a vertex table of at
// most 8064 vertices, for Hopper (sm_90a).  Built by
// mpsnerf_torch/cuda_build.py with nvcc into a shared library with a plain
// C interface, bound with ctypes (mpsnerf_torch/ops/knn.py).
//
// Replaces: tools/knn_variant_probe.py:kernel_vT (launched by nn_vT), the
// TPU probe's variant of mpsnerf_tpu/ops/knn.py:_nn_kernel.  Same
// function: for each query the key (bits(d^2) & ~0x1FFF) | id is min-
// reduced over all vertices and the id is the key's low 13 bits, so ties
// within d^2's 13 truncated mantissa bits go to the lowest id.  d^2 >= 0,
// so its IEEE bits order like the value and one integer min does min and
// argmin at once.  The exact d^2 is recomputed outside from the id.
//
// The TPU kernel's variants were its tiling: the query block, the vertex
// tile width and whether the tile's min is accumulated elementwise.  Here
// the variants are the launch's: QPT queries per thread (1, 2 or 4) and the
// vertex tile in shared memory (`tile` vertices of float4, given at launch;
// 128, 1152 and 2304 are the probe's).  The probe in
// mpsnerf_torch/tools/knn_variant_probe.py times each.
//
// What bounds it on this card: fp32 CUDA-core arithmetic, as for K1
// (csrc/nearest_vertex.cu): about 8 operations per query-vertex pair
// (3 subtractions, 3 products, 2 additions) plus an and, an or and an
// integer min; the inputs are tiny.  The design is K1's: the vertex tile
// streams through shared memory as float4 (one broadcast load per vertex
// per warp, reused by the block's queries), each thread keeps QPT running
// keys in registers, and d^2 uses explicit round-to-nearest intrinsics so
// it is bit-identical to the plain PyTorch version ((dx*dx + dy*dy) +
// dz*dz), which makes the ids equal to the plain version's exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIdBits = 13;
constexpr int kLowMask = (1 << kIdBits) - 1;

template <int QPT>
__global__ void __launch_bounds__(kThreads)
nearest_vertex_packed_kernel(const float* __restrict__ q,
                             const float* __restrict__ v, int64_t n, int nv,
                             int tile_size, int64_t* __restrict__ ids) {
  extern __shared__ float4 tile[];

  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kThreads * QPT) + threadIdx.x;
  float qx[QPT], qy[QPT], qz[QPT];
  int best[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * kThreads;
    const bool ok = i < n;
    qx[k] = ok ? q[3 * i + 0] : 0.f;
    qy[k] = ok ? q[3 * i + 1] : 0.f;
    qz[k] = ok ? q[3 * i + 2] : 0.f;
    best[k] = 0x7FFFFFFF;
  }

  for (int t0 = 0; t0 < nv; t0 += tile_size) {
    const int cnt = min(tile_size, nv - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* p = v + 3 * static_cast<int64_t>(t0 + j);
      tile[j] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 w = tile[j];
      const int id = t0 + j;
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        const float dx = __fsub_rn(qx[k], w.x);
        const float dy = __fsub_rn(qy[k], w.y);
        const float dz = __fsub_rn(qz[k], w.z);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        best[k] = min(best[k], (__float_as_int(d2) & ~kLowMask) | id);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * kThreads;
    if (i < n) ids[i] = best[k] & kLowMask;
  }
}

template <int QPT>
void launch(const float* q, const float* v, int64_t n, int nv, int tile,
            int64_t* ids, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * QPT;
  const int64_t blocks = (n + per_block - 1) / per_block;
  nearest_vertex_packed_kernel<QPT>
      <<<static_cast<unsigned>(blocks), kThreads, tile * sizeof(float4),
         stream>>>(q, v, n, nv, tile, ids);
}

}  // namespace

// q: (n, 3) f32, v: (nv, 3) f32 with nv <= 8192, ids: (n,) int64, all
// contiguous on the current device.  qpt in {1, 2, 4}; tile in [1, 3072]
// vertices (48 KB of shared memory at most).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int mpsnerf_nearest_vertex_packed(const void* q, const void* v,
                                             int64_t n, int64_t nv, void* ids,
                                             int64_t qpt, int64_t tile,
                                             void* stream) {
  if (n <= 0) return 0;
  if (nv <= 0 || nv > (1 << kIdBits) || tile < 1 || tile > 3072)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* vf = static_cast<const float*>(v);
  int64_t* out = static_cast<int64_t*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qpt) {
    case 1: launch<1>(qf, vf, n, (int)nv, (int)tile, out, s); break;
    case 2: launch<2>(qf, vf, n, (int)nv, (int)tile, out, s); break;
    case 4: launch<4>(qf, vf, n, (int)nv, (int)tile, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
