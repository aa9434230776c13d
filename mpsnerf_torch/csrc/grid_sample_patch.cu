// K2: bilinear patch sampling of (V, C, H, W) fp32 images at (V, N, 2)
// normalized coordinates, align_corners=True with border replication, and
// its backward and double backward, for Hopper (sm_90a).  Built by
// mpsnerf_torch/cuda_build.py with nvcc into a shared library with a plain
// C interface, bound with ctypes (mpsnerf_torch/ops/grid_sample.py).
//
// Replaces: mpsnerf_tpu/ops/grid_sample.py:grid_sample_2d_patch (a
// jax.custom_vjp compiled by XLA, not Pallas): forward :96-125 (the patch
// form), backward :132-143 (the VJP of the 4-corner grid_sample_2d,
// :19-58), and the double backward JAX derives from that VJP.
//
// Notation, per view v and point n:
//   ix = ((cx + 1) * 0.5) * (W - 1),  iy likewise with H;  sx = (W-1)/2,
//   sy = (H-1)/2 (d ix / d cx, d iy / d cy);  x0 = floor(ix), x1 = x0 + 1,
//   y0, y1 likewise;  ax = x1 - ix, bx = ix - x0, ay = y1 - iy, by = iy - y0.
//   Corners k = nw, ne, sw, se at the CLAMPED pixels p_k = (y0|y1, x0|x1)
//   with weights from the UNCLAMPED positions:
//     w   = (ax*ay, bx*ay, ax*by, bx*by)
//     w_x = d w / d ix = (-ay, ay, -by, by)
//     w_y = d w / d iy = (-ax, -bx, ax, bx)
//     w_xy = d2 w / d ix d iy = (+1, -1, -1, +1),
//     d2 w / d ix2 = d2 w / d iy2 = 0.
//
// Forward (the patch form; equal in value to sum_k w_k I[p_k]):
//   out[c,n] = p00 (1-wx)(1-wy) + p01 wx(1-wy) + p10 (1-wx)wy + p11 wx wy
//   with the patch start clipped to (W-2, H-2) and wx, wy clamped to [0,1].
// Backward, for the upstream g[c,n]:
//   dI[c, p_k] += w_k g[c,n]                                (scatter-add)
//   dcx[n] = sx sum_c g[c,n] sum_k w_x,k I[c,p_k]   (dcy with sy, w_y)
//   Beyond the border in x the clamped indices repeat one column, so dcx
//   is 0 there and dcy runs along the border column.  On the last column
//   (ix = W-1 exactly) dcx is 0 too, where autograd through the patch
//   form's clamped weight would give the backward difference.
// Double backward, for the upstream (ggI[c, p], ggc[n] = (ggx, ggy)),
// with tx = ggx sx, ty = ggy sy:
//   dg[c,n]    = sum_k w_k ggI[c,p_k] + tx sum_k w_x,k I[c,p_k]
//                                     + ty sum_k w_y,k I[c,p_k]
//   dI[c,p_k] += g[c,n] (tx w_x,k + ty w_y,k)
//   dcx[n]     = sx sum_c g sum_k w_x,k ggI[c,p_k] + sx ty M[n]
//   dcy[n]     = sy sum_c g sum_k w_y,k ggI[c,p_k] + sy tx M[n]
//   where M[n] = sum_c g[c,n] sum_k w_xy,k I[c,p_k] is the mixed term.
//
// Layout: every kernel reads the image channels-last, (V, H, W, C), so a
// corner's C channels are contiguous (the JAX form's img_hwc); g and the
// forward output are (V, C, N), coords (V, N, 2); dI is summed with
// atomicAdd into a zeroed channels-last buffer that the wrapper permutes
// back.
//
// What bounds it on this card: bytes.  Per output value the forward does
// 4 loads and 7 flops; the image, coords and output each cross HBM about
// once, so at the training shapes (latent 3x128x128x128, 64,512 points) it
// is ~126 MB against ~0.2 GFLOP.  The design: one thread per (view,
// point, group of 4 channels) with float4 loads of each corner when C % 4
// == 0 (the 128-channel latent), one per channel otherwise (the RGB);
// consecutive threads take consecutive points, so the (V, C, N) stores
// coalesce.  The backward and double backward run one thread per (view,
// point) and loop over C, so the coordinate gradient's reduction over C
// stays in registers; the image gradient costs 4 atomics per channel and
// point.  Simple first: no shared-memory staging, no warp-level
// reduction of the atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float position(float c, int size) {
  return __fmul_rn(__fmul_rn(__fadd_rn(c, 1.f), 0.5f),
                   static_cast<float>(size - 1));
}

struct Corners {
  int64_t p[4];  // flat pixel index (y * W + x), clamped
  float w[4], dx[4], dy[4];
};

__device__ __forceinline__ Corners corners(float ix, float iy, int h, int w) {
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  const float fx1 = fx0 + 1.f, fy1 = fy0 + 1.f;
  const float ax = __fsub_rn(fx1, ix), bx = __fsub_rn(ix, fx0);
  const float ay = __fsub_rn(fy1, iy), by = __fsub_rn(iy, fy0);
  const float xmax = static_cast<float>(w - 1);
  const float ymax = static_cast<float>(h - 1);
  const int64_t x0 = static_cast<int64_t>(fminf(fmaxf(fx0, 0.f), xmax));
  const int64_t x1 = static_cast<int64_t>(fminf(fmaxf(fx1, 0.f), xmax));
  const int64_t y0 = static_cast<int64_t>(fminf(fmaxf(fy0, 0.f), ymax));
  const int64_t y1 = static_cast<int64_t>(fminf(fmaxf(fy1, 0.f), ymax));
  Corners k;
  k.p[0] = y0 * w + x0;
  k.p[1] = y0 * w + x1;
  k.p[2] = y1 * w + x0;
  k.p[3] = y1 * w + x1;
  k.w[0] = __fmul_rn(ax, ay);
  k.w[1] = __fmul_rn(bx, ay);
  k.w[2] = __fmul_rn(ax, by);
  k.w[3] = __fmul_rn(bx, by);
  k.dx[0] = -ay; k.dx[1] = ay; k.dx[2] = -by; k.dx[3] = by;
  k.dy[0] = -ax; k.dy[1] = -bx; k.dy[2] = ax; k.dy[3] = bx;
  return k;
}

__device__ __forceinline__ float blend(float a, float b, float c, float d,
                                       float wa, float wb, float wc,
                                       float wd) {
  // ((a wa + b wb) + c wc) + d wd, rounded as the plain version rounds
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb)),
                             __fmul_rn(c, wc)),
                   __fmul_rn(d, wd));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
grid_sample_patch_fwd_kernel(const float* __restrict__ img,
                             const float* __restrict__ crd,
                             float* __restrict__ out, int V, int C, int H,
                             int W, int64_t N) {
  constexpr int CG = VEC ? 4 : 1;
  const int G = C / CG;
  const int64_t total = static_cast<int64_t>(V) * G * N;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t n = t % N;
    const int64_t r = t / N;
    const int grp = static_cast<int>(r % G);
    const int v = static_cast<int>(r / G);
    const int64_t vn = static_cast<int64_t>(v) * N + n;
    const float ix = position(crd[2 * vn], W);
    const float iy = position(crd[2 * vn + 1], H);
    const float fx = fminf(fmaxf(floorf(ix), 0.f), static_cast<float>(W - 2));
    const float fy = fminf(fmaxf(floorf(iy), 0.f), static_cast<float>(H - 2));
    const float wx = fminf(fmaxf(__fsub_rn(ix, fx), 0.f), 1.f);
    const float wy = fminf(fmaxf(__fsub_rn(iy, fy), 0.f), 1.f);
    const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
    const float w00 = __fmul_rn(ux, uy), w01 = __fmul_rn(wx, uy);
    const float w10 = __fmul_rn(ux, wy), w11 = __fmul_rn(wx, wy);
    const int64_t row = static_cast<int64_t>(W) * C;
    const float* p00 = img + ((static_cast<int64_t>(v) * H +
                               static_cast<int64_t>(fy)) * W +
                              static_cast<int64_t>(fx)) * C + grp * CG;
    const float* p01 = p00 + C;
    const float* p10 = p00 + row;
    const float* p11 = p10 + C;
    float* o = out + (static_cast<int64_t>(v) * C + grp * CG) * N + n;
    if (VEC) {
      const float4 a = *reinterpret_cast<const float4*>(p00);
      const float4 b = *reinterpret_cast<const float4*>(p01);
      const float4 c = *reinterpret_cast<const float4*>(p10);
      const float4 d = *reinterpret_cast<const float4*>(p11);
      o[0] = blend(a.x, b.x, c.x, d.x, w00, w01, w10, w11);
      o[N] = blend(a.y, b.y, c.y, d.y, w00, w01, w10, w11);
      o[2 * N] = blend(a.z, b.z, c.z, d.z, w00, w01, w10, w11);
      o[3 * N] = blend(a.w, b.w, c.w, d.w, w00, w01, w10, w11);
    } else {
      o[0] = blend(*p00, *p01, *p10, *p11, w00, w01, w10, w11);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
grid_sample_patch_bwd_kernel(const float* __restrict__ g,
                             const float* __restrict__ img,
                             const float* __restrict__ crd,
                             float* __restrict__ dimg,
                             float* __restrict__ dcrd, int V, int C, int H,
                             int W, int64_t N) {
  const int64_t total = static_cast<int64_t>(V) * N;
  const int64_t hwc = static_cast<int64_t>(H) * W * C;
  const float sx = 0.5f * (W - 1), sy = 0.5f * (H - 1);
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t n = t % N;
    const int v = static_cast<int>(t / N);
    const Corners k = corners(position(crd[2 * t], W),
                              position(crd[2 * t + 1], H), H, W);
    const float* I = img + v * hwc;
    float* D = dimg ? dimg + v * hwc : nullptr;
    const float* gv = g + static_cast<int64_t>(v) * C * N + n;
    float ex = 0.f, ey = 0.f;
    for (int c = 0; c < C; ++c) {
      const float gc = gv[static_cast<int64_t>(c) * N];
      float sxk = 0.f, syk = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float i = I[k.p[j] * C + c];
        sxk += k.dx[j] * i;
        syk += k.dy[j] * i;
        if (D) atomicAdd(D + k.p[j] * C + c, k.w[j] * gc);
      }
      ex += gc * sxk;
      ey += gc * syk;
    }
    dcrd[2 * t] = ex * sx;
    dcrd[2 * t + 1] = ey * sy;
  }
}

__global__ void __launch_bounds__(kThreads)
grid_sample_patch_bwd2_kernel(const float* __restrict__ g,
                              const float* __restrict__ img,
                              const float* __restrict__ crd,
                              const float* __restrict__ ggimg,
                              const float* __restrict__ ggcrd,
                              float* __restrict__ dg, float* __restrict__ dimg,
                              float* __restrict__ dcrd, int V, int C, int H,
                              int W, int64_t N) {
  const int64_t total = static_cast<int64_t>(V) * N;
  const int64_t hwc = static_cast<int64_t>(H) * W * C;
  const float sx = 0.5f * (W - 1), sy = 0.5f * (H - 1);
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t n = t % N;
    const int v = static_cast<int>(t / N);
    const Corners k = corners(position(crd[2 * t], W),
                              position(crd[2 * t + 1], H), H, W);
    const float* I = img + v * hwc;
    const float* GG = ggimg ? ggimg + v * hwc : nullptr;
    float* D = dimg ? dimg + v * hwc : nullptr;
    const int64_t gbase = static_cast<int64_t>(v) * C * N + n;
    const float tx = ggcrd ? ggcrd[2 * t] * sx : 0.f;
    const float ty = ggcrd ? ggcrd[2 * t + 1] * sy : 0.f;
    float ex = 0.f, ey = 0.f, mixed = 0.f;
    for (int c = 0; c < C; ++c) {
      const float gc = g[gbase + static_cast<int64_t>(c) * N];
      float i[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) i[j] = I[k.p[j] * C + c];
      float dgc = 0.f;
      if (GG) {
        float sw = 0.f, sxk = 0.f, syk = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float q = GG[k.p[j] * C + c];
          sw += k.w[j] * q;
          sxk += k.dx[j] * q;
          syk += k.dy[j] * q;
        }
        dgc += sw;
        ex += gc * sxk;
        ey += gc * syk;
      }
      if (ggcrd) {
        float sxk = 0.f, syk = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sxk += k.dx[j] * i[j];
          syk += k.dy[j] * i[j];
          if (D) {
            atomicAdd(D + k.p[j] * C + c, gc * (tx * k.dx[j] + ty * k.dy[j]));
          }
        }
        dgc += tx * sxk + ty * syk;
        mixed += gc * (((i[0] - i[1]) - i[2]) + i[3]);
      }
      if (dg) dg[gbase + static_cast<int64_t>(c) * N] = dgc;
    }
    if (dcrd) {
      dcrd[2 * t] = sx * ex + sx * ty * mixed;
      dcrd[2 * t + 1] = sy * ey + sy * tx * mixed;
    }
  }
}

unsigned blocks_for(int64_t total) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < (1 << 30) ? (b > 0 ? b : 1) : (1 << 30));
}

bool bad_sizes(int64_t V, int64_t C, int64_t H, int64_t W, int64_t N) {
  return V <= 0 || C <= 0 || H < 2 || W < 2 || N < 0 || V > 0x7fffffff ||
         C > 0x7fffffff || H > 0x7fffffff || W > 0x7fffffff;
}

}  // namespace

// img: (V, H, W, C) f32 channels-last; crd: (V, N, 2); out: (V, C, N).
// All contiguous on the current device.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int mpsnerf_grid_sample_patch_fwd(const void* img, const void* crd,
                                             void* out, int64_t V, int64_t C,
                                             int64_t H, int64_t W, int64_t N,
                                             void* stream) {
  if (bad_sizes(V, C, H, W, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(img);
  const float* c = static_cast<const float*>(crd);
  float* o = static_cast<float*>(out);
  if (C % 4 == 0) {
    grid_sample_patch_fwd_kernel<true>
        <<<blocks_for(V * (C / 4) * N), kThreads, 0, s>>>(
        i, c, o, (int)V, (int)C, (int)H, (int)W, N);
  } else {
    grid_sample_patch_fwd_kernel<false>
        <<<blocks_for(V * C * N), kThreads, 0, s>>>(
        i, c, o, (int)V, (int)C, (int)H, (int)W, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: (V, C, N); img: (V, H, W, C) channels-last; crd: (V, N, 2);
// dimg: zeroed (V, H, W, C) or null (no image gradient); dcrd: (V, N, 2).
extern "C" int mpsnerf_grid_sample_patch_bwd(const void* g, const void* img,
                                             const void* crd, void* dimg,
                                             void* dcrd, int64_t V, int64_t C,
                                             int64_t H, int64_t W, int64_t N,
                                             void* stream) {
  if (bad_sizes(V, C, H, W, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  grid_sample_patch_bwd_kernel<<<blocks_for(V * N), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(img),
      static_cast<const float*>(crd), static_cast<float*>(dimg),
      static_cast<float*>(dcrd), (int)V, (int)C, (int)H, (int)W, N);
  return static_cast<int>(cudaGetLastError());
}

// g: (V, C, N); img, ggimg: (V, H, W, C) channels-last (ggimg may be
// null); crd, ggcrd: (V, N, 2) (ggcrd may be null); outputs dg (V, C, N),
// dimg zeroed (V, H, W, C), dcrd (V, N, 2), each null when not wanted.
extern "C" int mpsnerf_grid_sample_patch_bwd2(
    const void* g, const void* img, const void* crd, const void* ggimg,
    const void* ggcrd, void* dg, void* dimg, void* dcrd, int64_t V,
    int64_t C, int64_t H, int64_t W, int64_t N, void* stream) {
  if (bad_sizes(V, C, H, W, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  grid_sample_patch_bwd2_kernel<<<blocks_for(V * N), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(img),
      static_cast<const float*>(crd), static_cast<const float*>(ggimg),
      static_cast<const float*>(ggcrd), static_cast<float*>(dg),
      static_cast<float*>(dimg), static_cast<float*>(dcrd), (int)V, (int)C,
      (int)H, (int)W, N);
  return static_cast<int>(cudaGetLastError());
}
