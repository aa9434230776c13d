// LayerNorm over the last dimension of (rows, D) fp32 rows, affine, eps
// given, for Hopper (sm_90a).  Built by mpsnerf_torch/cuda_build.py with
// nvcc into a shared library with a plain C interface, bound with ctypes
// (mpsnerf_torch/ops/layer_norm.py).
//
// Replaces no TPU kernel: the JAX package leaves the view-fusion
// transformer's LayerNorm (mpsnerf_tpu/models/transformer.py, D = 155 in
// both shipped configs) to XLA.  It was added because torch's CUDA
// LayerNorm takes one block a row for its moments at a width that is not a
// multiple of 4 (RowwiseMomentsCUDAKernel: the largest device operation of
// a served view before this kernel).
//
// What bounds it on this card: bytes.  A row is read once and written once
// (2 D floats: 1.24 kB at D = 155) against ~8 D flops; a served tile's 4
// calls (3, 3, 3 and 2 row groups of 16,384) move ~0.22 GB, ~0.07 ms at
// 3.35 TB/s.
//
// Design: one warp a row, 8 rows a block.  A lane holds the row's
// elements lane, lane + 32, ..., lane + 128 in registers (5 of them: rows
// up to 160 wide, the 155 of both shipped configs; the wrapper refuses a
// wider row and the transformer takes nn.LayerNorm there), so the row is
// read from device memory once: consecutive lanes load consecutive
// addresses (coalesced at any width, not only multiples of 4), the mean is
// a register sum and a shuffle reduction, the variance a second pass over
// the same registers around that mean (centred, as the plain version
// computes it), and the output is written with the same coalesced
// pattern.  The statistics are fp32; the variance is the biased one (over
// D), eps is added before rsqrt, as torch.nn.LayerNorm does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = kWarps * 32;
constexpr int kRegs = 5;  // a lane's elements: D <= 32 * kRegs

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    layer_norm_rows(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ y,
                    int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: its shuffles stay full
  const float* xr = x + row * d;
  float v[kRegs];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < d ? __ldg(xr + c) : 0.f;
    s += v[k];
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    const float t = lane + 32 * k < d ? v[k] - mean : 0.f;
    q += t * t;
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
  float* yr = y + row * d;
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    const int c = lane + 32 * k;
    if (c < d) yr[c] = (v[k] - mean) * rstd * __ldg(w + c) + __ldg(b + c);
  }
}

}  // namespace

// x, y: (rows, d) contiguous fp32, 0 < d <= 160; w, b: (d,) fp32.  Returns
// the launch's CUDA error (0 when it was taken).
extern "C" int mpsnerf_layer_norm(const void* x, const void* w, const void* b,
                                  void* y, int64_t rows, int64_t d,
                                  double eps, void* stream) {
  if (rows < 0 || d <= 0 || d > 32 * kRegs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  layer_norm_rows<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), rows,
      static_cast<int>(d), static_cast<float>(eps));
  return static_cast<int>(cudaGetLastError());
}
