// Exact 1-NN of fp32 3-D query points against a vertex table, for Hopper
// (sm_90a).  Built by mpsnerf_torch/cuda_build.py with nvcc into a shared
// library with a plain C interface, bound with ctypes
// (mpsnerf_torch/ops/knn.py).
//
// Replaces: mpsnerf_tpu/ops/knn.py:_nn_kernel (launched by
// nearest_vertex_pallas).  Same function, not the same structure: the TPU
// kernel packs a 13-bit vertex id into the low mantissa bits of d^2 and
// min-reduces the packed key over every vertex tile.  Here the result is
// exact for any vertex count: for each query the id of the vertex with the
// least d^2 = (dx*dx + dy*dy) + dz*dz (round-to-nearest, no FMA: bit-
// identical to the plain PyTorch version), the lowest id on a tie in that
// fp32 d^2, and that d^2.
//
// What bounds it on this card: fp32 issue.  A query-vertex pair costs 11
// instructions in the visit loop below (3 subtractions, 3 products, 2
// additions, a compare and 2 selects), none of them fused, and the card
// issues 132 SMs x 128 lanes of them a clock.  Brute force evaluates every
// pair; the design evaluates few of them.
//
// The vertex table (knn.py:build_vertex_buckets, once per table) is cut
// into buckets of 32 vertices in Morton order over its bounding box, each
// bucket with its axis-aligned box, each vertex with its original id
// (float4: x, y, z, id bits), the ids ascending within a bucket.  The
// build is the second kernel here (vertex_buckets_kernel): one block sorts
// the (Morton code, id) keys, so a table costs one launch, not the ~48
// small ones of its plain PyTorch version (knn.py:build_vertex_buckets_
// plain, which it equals bit for bit): the steps that build a table are
// bound by the host's launches.
//
// A warp takes 32 consecutive queries (in the compacted order, samples of
// one or two rays: close together) and:
//   1. reduces their box with shuffles;
//   2. visits first the bucket whose box is nearest the box's centre (each
//      lane scores the buckets lane, lane + 32, ...; a warp argmin picks
//      the lowest bucket on a tie), which seeds every lane's best;
//   3. walks the buckets 32 at a time: at the start of each chunk the warp
//      takes the largest best of its lanes, every lane tests one bucket's
//      box against the query box, and a ballot keeps those whose lower
//      bound does not exceed it; each kept bucket is tested once more per
//      lane (point to box, against the lane's own best) and visited unless
//      every lane's bound exceeds its best (__any_sync: the decision is the
//      warp's, there is no divergence).
// A visit runs over the bucket's 32 vertices with a strict < (ids ascend
// within a bucket, so the bucket's lowest id wins its ties) and merges the
// bucket's (d^2, id) into the lane's (best, id) lexicographically, so the
// order of visits cannot change the result.
//
// Why a skipped bucket cannot hold a vertex that wins or ties.  For a query
// q in [lo_q, hi_q] and a vertex v in the bucket's [lo_b, hi_b], per axis
// v - q >= lo_b - hi_q and q - v >= lo_q - hi_b exactly.  Rounding to
// nearest is monotone and odd, so |fl(q - v)| >= g = max(fl(lo_b - hi_q),
// fl(lo_q - hi_b), 0).  Products and sums of non-negative values round
// monotonically in each argument, so the d^2 the visit would compute,
// fl(fl(fl(dx*dx) + fl(dy*dy)) + fl(dz*dz)), is >= the bound computed by
// the same operations on (gx, gy, gz).  A bucket is skipped only when that
// bound is strictly greater than the best (the warp's largest for the box
// test, the lane's own for the point test, where lo_q = hi_q = q), so every
// vertex in it has a d^2 strictly greater than the best: it can neither win
// nor tie.  An infinite d^2 (a query so far away that d^2 overflows) gives
// an infinite bound, which is not greater than an infinite best, so such
// buckets are visited and the lowest id still wins.
//
// Where the table lives.  A table of up to kMaxSharedBytes (12,032
// vertices; the 6890-vertex rig takes 117.5 KB) is copied into shared
// memory once per block with two bulk asynchronous copies (cp.async.bulk,
// completion on an mbarrier), and every vertex read is a broadcast shared
// load.  A larger table is read from global memory through the read-only
// cache (the streamed path), with the same algorithm.
//
// Filling the card.  The grid is persistent: one block per SM (the table
// takes half of its shared memory), at most 32 warps a block, and query
// group g goes to block g % blocks and warp (g / blocks) % warps, so a
// 16,384-point tail tile (512 groups) spreads over all 132 SMs instead of
// filling 64 of them.
//
// Pair counter.  Given a non-null `pairs`, each warp adds the pairs it
// evaluated (32 per visited bucket and valid query); the path passes null.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBucket = 32;            // vertices per bucket
constexpr int kGroup = 32;             // queries per warp
constexpr int kMaxWarps = 32;          // 1024 threads a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBucketBytes = kBucket * 16 + 32;  // its vertices and its box
constexpr int kMaxSharedBytes = 376 * kBucketBytes;  // 204,544 B

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <bool kShared>
__device__ __forceinline__ float4 load(const float4* p) {
  if (kShared) return *p;
  return __ldg(p);
}

// a lower bound of |fl(q - v)| over q in [lo_q, hi_q], v in [lo_b, hi_b]
__device__ __forceinline__ float gap(float lo_q, float hi_q, float lo_b,
                                     float hi_b) {
  return fmaxf(fmaxf(__fsub_rn(lo_b, hi_q), __fsub_rn(lo_q, hi_b)), 0.f);
}

// (x*x + y*y) + z*z, rounded as d^2 is
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool barrier_done(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One bucket's vertices t[0..kBucket) against the lane's query: the
// bucket's least d^2 (strict <, ids ascending: its lowest id on a tie),
// merged into (best, best_id) lexicographically.
template <bool kShared>
__device__ __forceinline__ void visit(const float4* t, float qx, float qy,
                                      float qz, float& best, int& best_id) {
  float4 w = load<kShared>(t);
  float bd = norm2(__fsub_rn(qx, w.x), __fsub_rn(qy, w.y), __fsub_rn(qz, w.z));
  int bi = __float_as_int(w.w);
#pragma unroll
  for (int k = 1; k < kBucket; ++k) {
    w = load<kShared>(t + k);
    const float d2 =
        norm2(__fsub_rn(qx, w.x), __fsub_rn(qy, w.y), __fsub_rn(qz, w.z));
    if (d2 < bd) {
      bd = d2;
      bi = __float_as_int(w.w);
    }
  }
  if (bd < best || (bd == best && bi < best_id)) {
    best = bd;
    best_id = bi;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
nearest_vertex_kernel(const float* __restrict__ q, int64_t n,
                      const float4* __restrict__ gtable,
                      const float4* __restrict__ gboxes, int nb,
                      float* __restrict__ d2_out,
                      int64_t* __restrict__ ids_out,
                      unsigned long long* __restrict__ pairs) {
  extern __shared__ __align__(16) float4 smem[];
  __shared__ __align__(8) unsigned long long bar;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t groups = (n + kGroup - 1) / kGroup;
  int64_t grp = static_cast<int64_t>(warp) * gridDim.x + blockIdx.x;

  const float4* table = gtable;
  const float4* boxes = gboxes;  // (lo, hi) float4 pairs
  if (kShared) {
    const unsigned tbytes = static_cast<unsigned>(nb) * kBucket * 16;
    const unsigned bbytes = static_cast<unsigned>(nb) * 32;  // 2 float4
    const unsigned b = smem_u32(&bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(b), "r"(tbytes + bbytes)
                   : "memory");
      bulk_copy(smem, gtable, tbytes, b);
      bulk_copy(smem + nb * kBucket, gboxes, bbytes, b);
    }
    table = smem;
    boxes = smem + nb * kBucket;
    // warp 0 of every block has a group, so the issuing thread waits
    if (grp < groups) {
      while (!barrier_done(b, 0)) {
      }
    }
  }

  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * (blockDim.x / 32);
  unsigned long long evaluated = 0;
  for (; grp < groups; grp += stride) {
    const int64_t first = grp * kGroup;
    const int64_t i = first + lane;
    const bool valid = i < n;
    const int64_t src = valid ? i : first;  // idle lanes repeat lane 0
    const float qx = q[3 * src], qy = q[3 * src + 1], qz = q[3 * src + 2];
    const int nvalid = static_cast<int>(imin(kGroup, n - first));

    const float lx = warp_min(qx), ly = warp_min(qy), lz = warp_min(qz);
    const float hx = warp_max(qx), hy = warp_max(qy), hz = warp_max(qz);

    // 2. the seed: the bucket nearest the box's centre, lowest on a tie
    const float cx = __fmul_rn(__fadd_rn(lx, hx), 0.5f);
    const float cy = __fmul_rn(__fadd_rn(ly, hy), 0.5f);
    const float cz = __fmul_rn(__fadd_rn(lz, hz), 0.5f);
    float score = INFINITY;
    int seed = 0x7fffffff;
    for (int b = lane; b < nb; b += 32) {
      const float4 lo = load<kShared>(boxes + 2 * b);
      const float4 hi = load<kShared>(boxes + 2 * b + 1);
      const float s = norm2(gap(cx, cx, lo.x, hi.x), gap(cy, cy, lo.y, hi.y),
                            gap(cz, cz, lo.z, hi.z));
      if (s < score) {
        score = s;
        seed = b;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(kFull, score, o);
      const int ob = __shfl_xor_sync(kFull, seed, o);
      if (os < score || (os == score && ob < seed)) {
        score = os;
        seed = ob;
      }
    }

    float best = INFINITY;
    int best_id = 0x7fffffff;
    visit<kShared>(table + seed * kBucket, qx, qy, qz, best, best_id);
    int visits = 1;

    // 3. every other bucket, skipped where the bounds allow
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const float worst = warp_max(best);
      const int b = b0 + lane;
      bool keep = false;
      if (b < nb && b != seed) {
        const float4 lo = load<kShared>(boxes + 2 * b);
        const float4 hi = load<kShared>(boxes + 2 * b + 1);
        keep = norm2(gap(lx, hx, lo.x, hi.x), gap(ly, hy, lo.y, hi.y),
                     gap(lz, hz, lo.z, hi.z)) <= worst;
      }
      unsigned mask = __ballot_sync(kFull, keep);
      while (mask) {
        const int bb = b0 + __ffs(mask) - 1;
        mask &= mask - 1;
        const float4 lo = load<kShared>(boxes + 2 * bb);
        const float4 hi = load<kShared>(boxes + 2 * bb + 1);
        const float lb = norm2(gap(qx, qx, lo.x, hi.x),
                               gap(qy, qy, lo.y, hi.y),
                               gap(qz, qz, lo.z, hi.z));
        if (__any_sync(kFull, lb <= best)) {
          visit<kShared>(table + bb * kBucket, qx, qy, qz, best, best_id);
          ++visits;
        }
      }
    }

    if (valid) {
      d2_out[i] = best;
      ids_out[i] = best_id;
    }
    evaluated += static_cast<unsigned long long>(visits) * kBucket * nvalid;
  }
  if (pairs && lane == 0 && evaluated) atomicAdd(pairs, evaluated);
}

// ---- the bucket build ----------------------------------------------------

constexpr int kBuildThreads = 1024;
constexpr int kMortonBits = 10;
constexpr int kMaxSharedKeys = 16384;  // 128 KB of keys in shared memory

__device__ __forceinline__ unsigned long long spread3(unsigned x) {
  unsigned long long r = 0;
#pragma unroll
  for (int b = 0; b < kMortonBits; ++b)
    r |= static_cast<unsigned long long>((x >> b) & 1u) << (3 * b);
  return r;
}

// One block: the table's box, each vertex's Morton key (code << 32 | id)
// on a 1024^3 grid over it, a bitonic sort of the keys (in shared memory,
// or in `scratch` above kMaxSharedKeys), the last bucket padded with the
// last vertex, then a warp per bucket sorts its ids, writes its rows and
// reduces its box.  The arithmetic is the plain version's, op for op.
__global__ void __launch_bounds__(kBuildThreads)
vertex_buckets_kernel(const float* __restrict__ v, int nv, int pow2,
                      unsigned long long* __restrict__ scratch,
                      float4* __restrict__ table, float4* __restrict__ boxes) {
  extern __shared__ unsigned long long skeys[];
  __shared__ float red[6][kBuildThreads / 32];
  __shared__ float frame[6];  // lo xyz, scale xyz
  unsigned long long* keys = scratch ? scratch : skeys;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int i = t; i < nv; i += kBuildThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], v[3 * i + a]);
      hi[a] = fmaxf(hi[a], v[3 * i + a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = warp_min(lo[a]);
    hi[a] = warp_max(hi[a]);
    if (lane == 0) {
      red[a][warp] = lo[a];
      red[3 + a][warp] = hi[a];
    }
  }
  __syncthreads();
  if (t < 3) {
    float l = INFINITY, h = -INFINITY;
    for (int w = 0; w < kBuildThreads / 32; ++w) {
      l = fminf(l, red[t][w]);
      h = fmaxf(h, red[3 + t][w]);
    }
    frame[t] = l;
    // reciprocal(max(hi - lo, 1e-30)) * 1023, as the plain version rounds
    frame[3 + t] = __fmul_rn(__frcp_rn(fmaxf(__fsub_rn(h, l), 1e-30f)),
                             static_cast<float>((1 << kMortonBits) - 1));
  }
  __syncthreads();
  for (int i = t; i < pow2; i += kBuildThreads) {
    unsigned long long key = ~0ull;
    if (i < nv) {
      unsigned long long code = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float f = __fmul_rn(__fsub_rn(v[3 * i + a], frame[a]),
                                  frame[3 + a]);
        const long long c = static_cast<long long>(f);  // truncation
        const unsigned cell = static_cast<unsigned>(
            c < 0 ? 0 : (c > (1 << kMortonBits) - 1 ? (1 << kMortonBits) - 1
                                                     : c));
        code |= spread3(cell) << a;
      }
      key = (code << 32) | static_cast<unsigned>(i);
    }
    keys[i] = key;
  }
  __syncthreads();
  for (int k = 2; k <= pow2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < pow2; i += kBuildThreads) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = keys[i], b = keys[l];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const int nb = (nv + kBucket - 1) / kBucket;
  const unsigned last = static_cast<unsigned>(keys[nv - 1] & 0xffffffffu);
  for (int b = warp; b < nb; b += kBuildThreads / 32) {
    const int i = b * kBucket + lane;
    unsigned id = i < nv ? static_cast<unsigned>(keys[i] & 0xffffffffu) : last;
    // bitonic sort of the bucket's 32 ids across the warp, ascending
    for (int k = 2; k <= 32; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const unsigned other = __shfl_xor_sync(kFull, id, j);
        const bool up = (lane & k) == 0;
        const bool low = (lane & j) == 0;
        id = (low == up) ? min(id, other) : max(id, other);
      }
    }
    const float x = v[3 * id], y = v[3 * id + 1], z = v[3 * id + 2];
    table[i] = make_float4(x, y, z, __int_as_float(static_cast<int>(id)));
    const float lx = warp_min(x), ly = warp_min(y), lz = warp_min(z);
    const float hx = warp_max(x), hy = warp_max(y), hz = warp_max(z);
    if (lane == 0) {
      boxes[2 * b] = make_float4(lx, ly, lz, 0.f);
      boxes[2 * b + 1] = make_float4(hx, hy, hz, 0.f);
    }
  }
}

constexpr int kMaxDevices = 64;

// per device: its SM count, and whether the search (the build) may take
// its largest dynamic shared memory
struct DeviceState {
  int sms = 0;
  bool big_smem = false;
  bool big_build_smem = false;
};

DeviceState* device_state() {
  static DeviceState states[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return nullptr;
  DeviceState& st = states[dev];
  if (st.sms == 0 &&
      (cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, dev) !=
           cudaSuccess ||
       st.sms <= 0))
    return nullptr;
  return &st;
}

}  // namespace

// q: (n, 3) f32 contiguous; table: (nb * 32, 4) f32 and boxes: (nb, 8) f32,
// both contiguous and 16-byte aligned (knn.py:build_vertex_buckets); d2:
// (n,) f32, ids: (n,) int64; pairs: one uint64 to add the evaluated pairs
// to, or null.  All on the current device.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int mpsnerf_nearest_vertex(const void* q, int64_t n,
                                      const void* table, const void* boxes,
                                      int64_t nb, void* d2, void* ids,
                                      void* pairs, void* stream) {
  if (n < 0 || nb <= 0 || nb > (0x7fffffff / kBucket))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(table) & 15) ||
      (reinterpret_cast<uintptr_t>(boxes) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);
  DeviceState* st = device_state();
  if (!st) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t groups = (n + kGroup - 1) / kGroup;
  const int blocks = static_cast<int>(imin(st->sms, groups));
  const int warps =
      static_cast<int>(imin(kMaxWarps, (groups + blocks - 1) / blocks));
  const float* qf = static_cast<const float*>(q);
  const float4* tf = static_cast<const float4*>(table);
  const float4* bf = static_cast<const float4*>(boxes);
  float* df = static_cast<float*>(d2);
  int64_t* idf = static_cast<int64_t*>(ids);
  auto* pf = static_cast<unsigned long long*>(pairs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bytes = nb * kBucketBytes;
  if (bytes <= kMaxSharedBytes) {
    if (!st->big_smem) {
      const cudaError_t err = cudaFuncSetAttribute(
          nearest_vertex_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      st->big_smem = true;
    }
    nearest_vertex_kernel<true><<<blocks, warps * 32, bytes, s>>>(
        qf, n, tf, bf, static_cast<int>(nb), df, idf, pf);
  } else {
    nearest_vertex_kernel<false><<<blocks, warps * 32, 0, s>>>(
        qf, n, tf, bf, static_cast<int>(nb), df, idf, pf);
  }
  return static_cast<int>(cudaGetLastError());
}

// v: (nv, 3) f32 contiguous; table: (nb * 32, 4) f32 and boxes: (nb, 8)
// f32, nb = ceil(nv / 32), both contiguous and 16-byte aligned; scratch:
// next_pow2(nv) uint64 when that exceeds 16,384, else null.  Launches one
// block on `stream` and returns cudaGetLastError().
extern "C" int mpsnerf_vertex_buckets(const void* v, int64_t nv, void* scratch,
                                      void* table, void* boxes,
                                      void* stream) {
  if (nv <= 0 || nv > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(table) & 15) ||
      (reinterpret_cast<uintptr_t>(boxes) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int pow2 = 1;
  while (pow2 < nv) pow2 <<= 1;
  const bool shared = pow2 <= kMaxSharedKeys;
  if (!shared && !scratch) return static_cast<int>(cudaErrorInvalidValue);
  DeviceState* st = device_state();
  if (!st) return static_cast<int>(cudaErrorInvalidDevice);
  if (shared && !st->big_build_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        vertex_buckets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSharedKeys * 8);
    if (err != cudaSuccess) return static_cast<int>(err);
    st->big_build_smem = true;
  }
  vertex_buckets_kernel<<<1, kBuildThreads, shared ? pow2 * 8 : 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<int>(nv), pow2,
      shared ? nullptr : static_cast<unsigned long long*>(scratch),
      static_cast<float4*>(table), static_cast<float4*>(boxes));
  return static_cast<int>(cudaGetLastError());
}
