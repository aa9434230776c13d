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
// Layout.  Images are read through their element strides (sV, sC, sH,
// sW), so no kernel needs a copy: the encoder's latent is channels-last
// (sC = 1, a corner's C channels contiguous), the RGB images lie as
// (V, C, H, W).  g is read through its strides (gV, gC, gN) too: on the
// training path it is the channel-innermost gradient of the consumer's
// (V, N, C) view.  The forward writes (V, N, C) memory, which the wrapper
// returns as a (V, C, N) view (the layout the plain version returns and
// the one the consumer reads).  dI is a zeroed channels-last (V, H, W, C)
// buffer; dcoords (V, N, 2).  A null output pointer means that output is
// not wanted (the backward's dcrd null is need_coords = false).
//
// What bounds it on this card: bytes.  At the training shapes (latent
// 3x128x128x128 = 25 MB, 64,512 points) the forward moves ~126 MB (99 MB
// of it the output) against ~0.2 GFLOP; the backward reads g (99 MB) and
// writes dI (25 MB).  Two designs, chosen per call by the image's layout:
//
// * Channel tiles (C % 4 == 0, channels contiguous, 16-byte aligned rows:
//   the latent).  Lanes run over channels, 4 a lane (float4), so a warp
//   reads one corner's 128 channels as one coalesced 512-byte load.
//   Forward: a warp takes 2 points, starts their 8 corner loads before it
//   blends, and stores each point's 512-byte output row whole.  Backward:
//   a block takes a tile of 64 consecutive points of one view and stages
//   their g rows in shared memory (read coalesced along whichever of C or
//   N is contiguous, so a (V, C, N) g is transposed there).  The image
//   gradient is the scatter that collides: points along one ray are
//   neighbours in the compacted order and land on the same few pixels, so
//   a per-point atomic per channel serialises on those addresses.  The
//   block instead sorts its 256 (pixel, point-corner) entries by pixel
//   (bitonic, in shared memory), and one warp per distinct pixel sums
//   w_k g over that pixel's entries and adds the sum with ONE float4
//   atomicAdd per lane (sm_90): one atomic per pixel, channel group and
//   tile instead of one per point, corner and channel.  The coordinate
//   gradient (only when wanted) reads the 4 corners per point coalesced
//   and reduces sum_c with warp shuffles.  The order of every sum differs
//   from the plain version's (and from run to run across blocks), so the
//   backward agrees with it to rounding, not bit for bit.
// * Points (anything else: the 3-channel RGB).  One thread per point
//   loops over C, as F.grid_sample does, reading the image where it lies
//   and, in the backward, adding the image gradient with scalar atomics.
//
// The double backward keeps its first design: one thread per point, a loop
// over C, 4 atomics per channel and point for dI; only its reads go
// through strides.  The forward rounds as the plain version does (_rn
// intrinsics), so it is bit-identical to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kFwdPoints = 2;          // points per warp, tiled forward
constexpr int kTile = 64;              // points per block, tiled backward
constexpr int kEntries = 4 * kTile;    // (point, corner) entries of a tile
constexpr int kChunk = 128;            // channels per pass: 32 lanes x 4
constexpr int kRow = kChunk + 4;       // a staged g row, float4-aligned
constexpr unsigned kNoPixel = 0xffffffffu;
static_assert(kEntries == kThreads, "the sort takes one entry a thread");

struct Strides {  // of an image, in elements
  int64_t v, c, h, w;
};

struct GStrides {  // of g (V, C, N), in elements
  int64_t v, c, n;
};

__device__ __forceinline__ float position(float c, int size) {
  return __fmul_rn(__fmul_rn(__fadd_rn(c, 1.f), 0.5f),
                   static_cast<float>(size - 1));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

struct Corners {
  int y[4], x[4];  // the clamped pixel of each corner
  float w[4], dx[4], dy[4];
  __device__ int64_t at(const Strides& s, int j) const {
    return y[j] * s.h + x[j] * s.w;
  }
  __device__ int64_t pixel(int j, int w_) const {
    return static_cast<int64_t>(y[j]) * w_ + x[j];
  }
};

__device__ __forceinline__ Corners corners(float ix, float iy, int h, int w) {
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  const float fx1 = fx0 + 1.f, fy1 = fy0 + 1.f;
  const float ax = __fsub_rn(fx1, ix), bx = __fsub_rn(ix, fx0);
  const float ay = __fsub_rn(fy1, iy), by = __fsub_rn(iy, fy0);
  const float xmax = static_cast<float>(w - 1);
  const float ymax = static_cast<float>(h - 1);
  const int x0 = static_cast<int>(fminf(fmaxf(fx0, 0.f), xmax));
  const int x1 = static_cast<int>(fminf(fmaxf(fx1, 0.f), xmax));
  const int y0 = static_cast<int>(fminf(fmaxf(fy0, 0.f), ymax));
  const int y1 = static_cast<int>(fminf(fmaxf(fy1, 0.f), ymax));
  Corners k;
  k.y[0] = y0; k.x[0] = x0;
  k.y[1] = y0; k.x[1] = x1;
  k.y[2] = y1; k.x[2] = x0;
  k.y[3] = y1; k.x[3] = x1;
  k.w[0] = __fmul_rn(ax, ay);
  k.w[1] = __fmul_rn(bx, ay);
  k.w[2] = __fmul_rn(ax, by);
  k.w[3] = __fmul_rn(bx, by);
  k.dx[0] = -ay; k.dx[1] = ay; k.dx[2] = -by; k.dx[3] = by;
  k.dy[0] = -ax; k.dy[1] = -bx; k.dy[2] = ax; k.dy[3] = bx;
  return k;
}

struct Patch {
  int64_t off;  // the top-left corner, within the view
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Patch patch(float cx, float cy, int h, int w,
                                       const Strides& s) {
  const float ix = position(cx, w), iy = position(cy, h);
  const float fx = fminf(fmaxf(floorf(ix), 0.f), static_cast<float>(w - 2));
  const float fy = fminf(fmaxf(floorf(iy), 0.f), static_cast<float>(h - 2));
  const float wx = fminf(fmaxf(__fsub_rn(ix, fx), 0.f), 1.f);
  const float wy = fminf(fmaxf(__fsub_rn(iy, fy), 0.f), 1.f);
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
  Patch p;
  p.off = static_cast<int64_t>(fy) * s.h + static_cast<int64_t>(fx) * s.w;
  p.w00 = __fmul_rn(ux, uy);
  p.w01 = __fmul_rn(wx, uy);
  p.w10 = __fmul_rn(ux, wy);
  p.w11 = __fmul_rn(wx, wy);
  return p;
}

__device__ __forceinline__ float blend(float a, float b, float c, float d,
                                       const Patch& p) {
  // ((a w00 + b w01) + c w10) + d w11, rounded as the plain version rounds
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a, p.w00), __fmul_rn(b, p.w01)),
                __fmul_rn(c, p.w10)),
      __fmul_rn(d, p.w11));
}

// sum over the 4 channels of a float4 group of g_c * sum_k u_k I_k[c]
__device__ __forceinline__ float weigh4(const float4& g, const float4* i,
                                        const float* u) {
  return g.x * (((u[0] * i[0].x + u[1] * i[1].x) + u[2] * i[2].x) +
                u[3] * i[3].x) +
         g.y * (((u[0] * i[0].y + u[1] * i[1].y) + u[2] * i[2].y) +
                u[3] * i[3].y) +
         g.z * (((u[0] * i[0].z + u[1] * i[1].z) + u[2] * i[2].z) +
                u[3] * i[3].z) +
         g.w * (((u[0] * i[0].w + u[1] * i[1].w) + u[2] * i[2].w) +
                u[3] * i[3].w);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- forward --------------------------------------------------------------

// Channel tiles: a block per (kWarps x kFwdPoints points, view), a warp
// per kFwdPoints points, lanes over channels.  The output rows stream out
// past L2 (__stcs) so that the image stays there for the gathers.
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_tile(const float* __restrict__ img,
                     const float* __restrict__ crd, float* __restrict__ out,
                     int C, int H, int W, int64_t N, Strides s) {
  const int lane = threadIdx.x & 31;
  const int64_t n0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) *
      kFwdPoints;
  if (n0 >= N) return;
  const int64_t first = blockIdx.y * N + n0;  // flat (view, point)
  const float* view = img + blockIdx.y * s.v;
  Patch q[kFwdPoints];
  bool ok[kFwdPoints];
#pragma unroll
  for (int j = 0; j < kFwdPoints; ++j) {
    ok[j] = n0 + j < N;
    const int64_t t = ok[j] ? first + j : first;
    q[j] = patch(crd[2 * t], crd[2 * t + 1], H, W, s);
  }
  for (int c = 4 * lane; c < C; c += 4 * 32) {
    float4 a[kFwdPoints][4];
#pragma unroll
    for (int j = 0; j < kFwdPoints; ++j) {
      if (!ok[j]) continue;
      const float* p = view + q[j].off + c;
      a[j][0] = load4(p);
      a[j][1] = load4(p + s.w);
      a[j][2] = load4(p + s.h);
      a[j][3] = load4(p + s.h + s.w);
    }
#pragma unroll
    for (int j = 0; j < kFwdPoints; ++j) {
      if (!ok[j]) continue;
      float4 r;
      r.x = blend(a[j][0].x, a[j][1].x, a[j][2].x, a[j][3].x, q[j]);
      r.y = blend(a[j][0].y, a[j][1].y, a[j][2].y, a[j][3].y, q[j]);
      r.z = blend(a[j][0].z, a[j][1].z, a[j][2].z, a[j][3].z, q[j]);
      r.w = blend(a[j][0].w, a[j][1].w, a[j][2].w, a[j][3].w, q[j]);
      __stcs(reinterpret_cast<float4*>(out + (first + j) * C + c), r);
    }
  }
}

// Points: a block per (kThreads points, view), a thread per point, a loop
// over C.
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_point(const float* __restrict__ img,
                      const float* __restrict__ crd, float* __restrict__ out,
                      int C, int H, int W, int64_t N, Strides s) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const int64_t t = blockIdx.y * N + n;
  const Patch q = patch(crd[2 * t], crd[2 * t + 1], H, W, s);
  const float* p00 = img + blockIdx.y * s.v + q.off;
  const float* p01 = p00 + s.w;
  const float* p10 = p00 + s.h;
  const float* p11 = p10 + s.w;
  float* o = out + t * C;
  for (int c = 0; c < C; ++c) {
    const int64_t k = c * s.c;
    o[c] = blend(p00[k], p01[k], p10[k], p11[k], q);
  }
}

// ---- backward -------------------------------------------------------------

// Channel tiles: a block per (tile of kTile points, view); see the header.
__global__ void __launch_bounds__(kThreads)
grid_sample_bwd_tile(const float* __restrict__ g,
                     const float* __restrict__ img,
                     const float* __restrict__ crd, float* __restrict__ dimg,
                     float* __restrict__ dcrd, int C, int H, int W, int64_t N,
                     GStrides gs, Strides s) {
  __shared__ __align__(16) float gt[kTile * kRow];  // g rows of the tile
  __shared__ unsigned long long keys[kEntries];     // pixel << 32 | entry
  __shared__ float wts[kEntries];                   // w_k of each entry
  __shared__ int heads[kEntries + 1];  // first entry of each pixel's run
  __shared__ int warp_heads[kWarps];
  __shared__ float ex_s[kTile], ey_s[kTile];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int v = blockIdx.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int npts = static_cast<int>(min(static_cast<int64_t>(kTile), N - n0));
  const float* cv = crd + (static_cast<int64_t>(v) * N + n0) * 2;
  const float sx = 0.5f * (W - 1), sy = 0.5f * (H - 1);

  int nheads = 0;
  if (dimg) {
    // entry e = 4 p + k is corner k of point p; points past N sort last
    if (t < kTile) {
      if (t < npts) {
        const Corners k = corners(position(cv[2 * t], W),
                                  position(cv[2 * t + 1], H), H, W);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          keys[4 * t + j] =
              (static_cast<unsigned long long>(k.pixel(j, W)) << 32) |
              static_cast<unsigned>(4 * t + j);
          wts[4 * t + j] = k.w[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          keys[4 * t + j] = (static_cast<unsigned long long>(kNoPixel) << 32) |
                            static_cast<unsigned>(4 * t + j);
          wts[4 * t + j] = 0.f;
        }
      }
    }
    __syncthreads();
    // bitonic sort, one entry a thread: runs of one pixel become
    // contiguous, in entry order within a run
    for (int k = 2; k <= kEntries; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int l = t ^ j;
        if (l > t) {
          const unsigned long long a = keys[t], b = keys[l];
          if ((a > b) == ((t & k) == 0)) {
            keys[t] = b;
            keys[l] = a;
          }
        }
        __syncthreads();
      }
    }
    const unsigned pix = static_cast<unsigned>(keys[t] >> 32);
    const bool head =
        pix != kNoPixel &&
        (t == 0 || static_cast<unsigned>(keys[t - 1] >> 32) != pix);
    const unsigned ballot = __ballot_sync(0xffffffffu, head);
    if (lane == 0) warp_heads[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_heads[w] : 0;
      nheads += warp_heads[w];
    }
    if (head) heads[before + __popc(ballot & ((1u << lane) - 1u))] = t;
    if (t == 0) heads[nheads] = 4 * npts;
  }
  if (dcrd && t < kTile) {
    ex_s[t] = 0.f;
    ey_s[t] = 0.f;
  }

  const float* gv = g + v * gs.v + n0 * gs.n;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cc = min(kChunk, C - c0);
    __syncthreads();  // the previous chunk's readers are done
    if (gs.c == 1) {  // channels contiguous: a warp reads a point's row
      for (int p = warp; p < kTile; p += kWarps) {
        for (int c = lane; c < cc; c += 32) {
          gt[p * kRow + c] = p < npts ? gv[p * gs.n + c0 + c] : 0.f;
        }
      }
    } else {  // a warp reads a channel along n: transposed here
      for (int c = warp; c < cc; c += kWarps) {
        for (int p = lane; p < kTile; p += 32) {
          gt[p * kRow + c] = p < npts ? gv[(c0 + c) * gs.c + p * gs.n] : 0.f;
        }
      }
    }
    __syncthreads();
    if (dimg) {
      float* dv = dimg + static_cast<int64_t>(v) * H * W * C + c0;
      for (int h = warp; h < nheads; h += kWarps) {
        const int e0 = heads[h], e1 = heads[h + 1];
        float* dst = dv + static_cast<int64_t>(keys[e0] >> 32) * C;
        for (int c = 4 * lane; c < cc; c += 4 * 32) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int q = e0; q < e1; ++q) {
            const int e = static_cast<int>(keys[q] & 0xffffffffu);
            const float w = wts[e];
            const float4 gq =
                *reinterpret_cast<const float4*>(gt + (e >> 2) * kRow + c);
            acc.x = fmaf(w, gq.x, acc.x);
            acc.y = fmaf(w, gq.y, acc.y);
            acc.z = fmaf(w, gq.z, acc.z);
            acc.w = fmaf(w, gq.w, acc.w);
          }
          atomicAdd(reinterpret_cast<float4*>(dst + c), acc);
        }
      }
    }
    if (dcrd) {
      const float* iv = img + v * s.v + c0;
      for (int p = warp; p < npts; p += kWarps) {
        const Corners k = corners(position(cv[2 * p], W),
                                  position(cv[2 * p + 1], H), H, W);
        float ex = 0.f, ey = 0.f;
        for (int c = 4 * lane; c < cc; c += 4 * 32) {
          const float4 gq = *reinterpret_cast<const float4*>(gt + p * kRow + c);
          float4 i[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) i[j] = load4(iv + k.at(s, j) + c);
          ex += weigh4(gq, i, k.dx);
          ey += weigh4(gq, i, k.dy);
        }
        ex = warp_sum(ex);
        ey = warp_sum(ey);
        if (lane == 0) {
          ex_s[p] += ex;
          ey_s[p] += ey;
        }
      }
    }
  }
  if (dcrd) {
    __syncthreads();
    if (t < npts) {
      float* d = dcrd + (static_cast<int64_t>(v) * N + n0 + t) * 2;
      d[0] = ex_s[t] * sx;
      d[1] = ey_s[t] * sy;
    }
  }
}

// Points: a block per (kThreads points, view), a thread per point, a loop
// over C, scalar atomics for dI.
__global__ void __launch_bounds__(kThreads)
grid_sample_bwd_point(const float* __restrict__ g,
                      const float* __restrict__ img,
                      const float* __restrict__ crd, float* __restrict__ dimg,
                      float* __restrict__ dcrd, int C, int H, int W,
                      int64_t N, GStrides gs, Strides s) {
  const float sx = 0.5f * (W - 1), sy = 0.5f * (H - 1);
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const int64_t v = blockIdx.y, t = v * N + n;
  const Corners k = corners(position(crd[2 * t], W),
                            position(crd[2 * t + 1], H), H, W);
  const float* I = img + v * s.v;
  float* D = dimg ? dimg + v * H * W * C : nullptr;
  const float* gp = g + v * gs.v + n * gs.n;
  float ex = 0.f, ey = 0.f;
  for (int c = 0; c < C; ++c) {
    const float gc = gp[c * gs.c];
    if (dcrd) {
      float sxk = 0.f, syk = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float i = I[k.at(s, j) + c * s.c];
        sxk += k.dx[j] * i;
        syk += k.dy[j] * i;
      }
      ex += gc * sxk;
      ey += gc * syk;
    }
    if (D) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        atomicAdd(D + k.pixel(j, W) * C + c, k.w[j] * gc);
      }
    }
  }
  if (dcrd) {
    dcrd[2 * t] = ex * sx;
    dcrd[2 * t + 1] = ey * sy;
  }
}

// ---- double backward ------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
grid_sample_patch_bwd2_kernel(const float* __restrict__ g,
                              const float* __restrict__ img,
                              const float* __restrict__ crd,
                              const float* __restrict__ ggimg,
                              const float* __restrict__ ggcrd,
                              float* __restrict__ dg, float* __restrict__ dimg,
                              float* __restrict__ dcrd, int V, int C, int H,
                              int W, int64_t N, GStrides gs, Strides s,
                              Strides ts) {
  const int64_t total = static_cast<int64_t>(V) * N;
  const int64_t hwc = static_cast<int64_t>(H) * W * C;
  const float sx = 0.5f * (W - 1), sy = 0.5f * (H - 1);
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t n = t % N;
    const int v = static_cast<int>(t / N);
    const Corners k = corners(position(crd[2 * t], W),
                              position(crd[2 * t + 1], H), H, W);
    const float* I = img + v * s.v;
    const float* GG = ggimg ? ggimg + v * ts.v : nullptr;
    float* D = dimg ? dimg + v * hwc : nullptr;
    const float* gp = g + v * gs.v + n * gs.n;
    const int64_t gbase = static_cast<int64_t>(v) * C * N + n;
    const float tx = ggcrd ? ggcrd[2 * t] * sx : 0.f;
    const float ty = ggcrd ? ggcrd[2 * t + 1] * sy : 0.f;
    float ex = 0.f, ey = 0.f, mixed = 0.f;
    for (int c = 0; c < C; ++c) {
      const float gc = gp[c * gs.c];
      float i[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) i[j] = I[k.at(s, j) + c * s.c];
      float dgc = 0.f;
      if (GG) {
        float sw = 0.f, sxk = 0.f, syk = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float q = GG[k.at(ts, j) + c * ts.c];
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
            atomicAdd(D + k.pixel(j, W) * C + c,
                      gc * (tx * k.dx[j] + ty * k.dy[j]));
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
  // V is a grid dimension (y) and so are the point blocks (x); a pixel
  // index (< H W) must fit the sort key's 32 bits below kNoPixel
  return V <= 0 || C <= 0 || H < 2 || W < 2 || N < 0 || V > 65535 ||
         C > 0x7fffffff || H * W >= 0x7fffffff ||
         (N + kWarps * kFwdPoints - 1) / (kWarps * kFwdPoints) > 0x7fffffff;
}

// the channel-tiled kernels' layout: channels contiguous, float4-aligned
bool tiled(const void* img, int64_t C, const Strides& s) {
  return C % 4 == 0 && s.c == 1 && s.v % 4 == 0 && s.h % 4 == 0 &&
         s.w % 4 == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0;
}

}  // namespace

// img: (V, C, H, W) f32 with element strides (sV, sC, sH, sW); crd:
// (V, N, 2) contiguous; out: (V, N, C) contiguous.  All on the current
// device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int mpsnerf_grid_sample_patch_fwd(
    const void* img, const void* crd, void* out, int64_t V, int64_t C,
    int64_t H, int64_t W, int64_t N, int64_t sV, int64_t sC, int64_t sH,
    int64_t sW, void* stream) {
  if (bad_sizes(V, C, H, W, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{sV, sC, sH, sW};
  const float* i = static_cast<const float*>(img);
  const float* c = static_cast<const float*>(crd);
  float* o = static_cast<float*>(out);
  if (tiled(img, C, s)) {
    const int64_t per_block = kWarps * kFwdPoints;
    const dim3 grid(static_cast<unsigned>((N + per_block - 1) / per_block),
                    static_cast<unsigned>(V));
    grid_sample_fwd_tile<<<grid, kThreads, 0, st>>>(i, c, o, (int)C, (int)H,
                                                    (int)W, N, s);
  } else {
    const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads),
                    static_cast<unsigned>(V));
    grid_sample_fwd_point<<<grid, kThreads, 0, st>>>(i, c, o, (int)C, (int)H,
                                                     (int)W, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: (V, C, N) with element strides (gV, gC, gN); img: (V, C, H, W) with
// strides (sV, sC, sH, sW); crd: (V, N, 2) contiguous; dimg: zeroed
// (V, H, W, C) contiguous, or null for no image gradient; dcrd: (V, N, 2),
// or null for no coordinate gradient (need_coords false: the image is then
// not read).
extern "C" int mpsnerf_grid_sample_patch_bwd(
    const void* g, const void* img, const void* crd, void* dimg, void* dcrd,
    int64_t V, int64_t C, int64_t H, int64_t W, int64_t N, int64_t gV,
    int64_t gC, int64_t gN, int64_t sV, int64_t sC, int64_t sH, int64_t sW,
    void* stream) {
  if (bad_sizes(V, C, H, W, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || (!dimg && !dcrd)) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{sV, sC, sH, sW};
  const GStrides gs{gV, gC, gN};
  const float* gp = static_cast<const float*>(g);
  const float* i = static_cast<const float*>(img);
  const float* c = static_cast<const float*>(crd);
  float* di = static_cast<float*>(dimg);
  float* dc = static_cast<float*>(dcrd);
  // without dcrd the image is not read: only C and dimg's alignment count
  if (C % 4 == 0 && (!dcrd || tiled(img, C, s)) &&
      (reinterpret_cast<uintptr_t>(dimg) & 15) == 0) {
    const dim3 grid(static_cast<unsigned>((N + kTile - 1) / kTile),
                    static_cast<unsigned>(V));
    grid_sample_bwd_tile<<<grid, kThreads, 0, st>>>(gp, i, c, di, dc, (int)C,
                                                (int)H, (int)W, N, gs, s);
  } else {
    const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads),
                    static_cast<unsigned>(V));
    grid_sample_bwd_point<<<grid, kThreads, 0, st>>>(
        gp, i, c, di, dc, (int)C, (int)H, (int)W, N, gs, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: (V, C, N) with strides (gV, gC, gN); img: (V, C, H, W) with strides
// (sV, sC, sH, sW); ggimg: the same shape with strides (tV, tC, tH, tW),
// or null; crd, ggcrd: (V, N, 2) contiguous (ggcrd may be null); outputs
// dg (V, C, N) contiguous, dimg zeroed (V, H, W, C) contiguous, dcrd
// (V, N, 2), each null when not wanted.
extern "C" int mpsnerf_grid_sample_patch_bwd2(
    const void* g, const void* img, const void* crd, const void* ggimg,
    const void* ggcrd, void* dg, void* dimg, void* dcrd, int64_t V,
    int64_t C, int64_t H, int64_t W, int64_t N, int64_t gV, int64_t gC,
    int64_t gN, int64_t sV, int64_t sC, int64_t sH, int64_t sW, int64_t tV,
    int64_t tC, int64_t tH, int64_t tW, void* stream) {
  if (bad_sizes(V, C, H, W, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  grid_sample_patch_bwd2_kernel<<<blocks_for(V * N), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(img),
      static_cast<const float*>(crd), static_cast<const float*>(ggimg),
      static_cast<const float*>(ggcrd), static_cast<float*>(dg),
      static_cast<float*>(dimg), static_cast<float*>(dcrd), (int)V, (int)C,
      (int)H, (int)W, N, GStrides{gV, gC, gN}, Strides{sV, sC, sH, sW},
      Strides{tV, tC, tH, tW});
  return static_cast<int>(cudaGetLastError());
}
