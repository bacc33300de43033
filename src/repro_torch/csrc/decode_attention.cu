// Decode attention: one new query row per (b, h) against a KV cache of Smax
// entries, of which the first `cache_len` are valid (optionally only the
// last `window` of those), with grouped-query heads.
//
// Replaces the Pallas kernel `decode_attention_kernel` /
// `decode_attention_call` of src/repro/kernels/decode_attention.py
// (pallas_call at :105).  There `cache_len` is a scalar prefetched into
// SMEM, kv blocks are a sequential grid axis carrying the partial softmax in
// VMEM, and blocks past `cache_len` are skipped.  Here `cache_len` is an
// int32 in device memory that every block reads itself, so a decode loop
// needs no host round trip (and can be captured in a CUDA graph).
//
// Layout: q and out [B, 1, H, D], caches [B, Smax, KVH, D], read through
// their strides (the last dimension contiguous), in place: the cache is the
// model's, and no call copies it.  float32 or bfloat16 in, float32 inside,
// out in the input type.  One kernel a call: head dims up to 128
// (llama3.2-3b's and hymba-1.5b's heads, kimi-k2-1t-a32b's 112,
// SigLIP-so400m's 72) run decode_attention_kernel, designed here; head dims
// from 129 to 256 (paligemma-3b's 256; 192) run decode_attention_d256_kernel,
// with a design of its own (below, with its note).  A head dim D that is not
// an instantiated width runs the geometry of the next one, W (16, 32, 64,
// 128: 112 and 72 at 128, whose W / 8 = 16 dimensions a lane and W / 4 lanes
// across a row divide the block; D's own would not; 256 above 128): a row's
// D columns are copied, the rest of its W-wide shared row and q's columns
// past D are zeros, so the scores and the first D columns of P V are D's;
// the splits' partial sums are W wide in the workspace, and only o's D
// columns are written.  It reads no extra byte of device memory; the padded
// columns cost W / D of the (few) operations.
//
// Copies: a row is copied in pieces of the widest of 16, 8 or 4 bytes (2,
// a bfloat16, for an odd D) that divides its D sizeof(T) bytes, the caches'
// (and for the head-dim-256 kernel q's) base addresses and strides
// (`copy_unit`, on the host): 16-byte `cp.async` or bulk copies where the
// rows allow them, as every served model's do, else 8- or 4-byte `cp.async`,
// else plain loads, so any layout with a contiguous last dimension is read
// where it lies.
//
// What bounds both on this card: bytes.  A call must read the valid K and V
// rows once (llama3.2-3b's decode, B = 4, KVH = 8, D = 128, 544 entries,
// float32: 17.8 MB, 5.3 us at 3.35 TB/s) and does 4 flops per element read,
// far below the card's ~20 flops per byte.  So the design keeps the cache's
// bytes in flight on every SM, in one launch:
//  * split-KV (flash-decoding): one block per (b, kv head, split of the
//    cache).  The wrapper picks the split (16 to 64 entries) from Smax so
//    that the blocks come to at most four an SM: 48 entries and 384 blocks
//    at llama's shape, 32 and 340 at hymba-1.5b's.  A split that holds no
//    valid entry (past cache_len, or before the window) exits before
//    reading anything, so the work follows the filled cache;
//  * a block serves all H / KVH query heads of its kv head (up to 8; more
//    take more blocks), so each K and V row is read from device memory once;
//  * a block issues all its K rows, then all its V rows, as 16-byte
//    `cp.async` copies (neighbouring threads on neighbouring addresses), one
//    commit group per 16-entry tile, and computes each tile's scores as it
//    lands while the later tiles and all of V are still in flight; then the
//    softmax of the split, then P V tile by tile as V lands;
//  * scores: 8 lanes an entry (4 at D = 16), each with D / 8 of the
//    dimensions, reduced by shuffles; P V: each thread 4 dimensions of one
//    entry group for every head, the groups summed through shared memory.
//    No warp idles at G = 3 or 5;
//  * the combine is folded in: each block writes its split's (max,
//    denominator, accumulator) per head, and the last block of a (b, kv
//    head) to finish, found by an atomic counter in the wrapper's workspace,
//    combines the splits (each split's weight computed once per head, the
//    loads of a thread's outputs in flight together), divides by
//    max(l, 1e-30) as the reference does, writes the output and resets the
//    counter for the next call.
// Invalid entries get probability exactly 0 (in the reference they are
// -1e30 and vanish the same way once a valid key is seen; every split
// visited here holds one).  With cache_len = 0 the output is 0, as the
// reference kernel's.
//
// A shard of a cache (both kernels): the caches may be a rank's entries
// [kv_start, kv_start + Smax) of a sequence-sharded cache, cache_len still
// the whole cache's count, so entry idx of the shard is valid where
// kv_start + idx is.  Where `lse` is given the kernels also write each
// head's log-sum-exp over the shard's valid scores (natural log, float32
// [B, H]), so that the shards' normalised outputs can be merged: with
// weights exp(lse_r - max lse) (flash-decoding's combine).  A shard with no
// valid entry writes o = 0 and lse = -1e30, the finite value the merge
// masks out (never -inf or NaN).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async8;
using repro::cp_async_mbar_arrive;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::allow_wide_clusters;
using repro::bulk_load;
using repro::ensure_smem;
using repro::from_f32;
using repro::kMaxDevices;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;
using repro::to_f32;

constexpr int kTile = 16;      // cache entries a commit group
constexpr int kMaxSplit = 64;  // cache entries a block at most
constexpr int kMaxG = 8;       // query heads a block at most
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNoEntry = -1e30f;  // lse of a shard with no valid entry

// The valid entries [lo, hi) of a shard of smax entries that starts at the
// cache's entry kv_start, for n valid entries in the whole cache.
__device__ __forceinline__ void valid_range(int n, int smax, int window, int kv_start, int* lo,
                                            int* hi) {
  *hi = min(max(n - kv_start, 0), smax);
  *lo = window > 0 ? max(0, n - window - kv_start) : 0;
}

// Four consecutive elements as floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// A piece of `bytes` bytes of a row (16, 8 or 4: cp.async; 2: one bfloat16
// copied by a plain load and store, which the same barrier publishes).
template <typename T>
__device__ __forceinline__ void copy_piece(T* dst, const T* src, int bytes) {
  switch (bytes) {
    case 16: cp_async16(dst, src); break;
    case 8: cp_async8(dst, src); break;
    case 4: cp_async4(dst, src); break;
    default: *dst = *src; break;
  }
}

// A piece of `bytes` bytes of a shared row set to zero.
__device__ __forceinline__ void zero_piece(void* dst, int bytes) {
  switch (bytes) {
    case 16: *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u); break;
    case 8: *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) = 0u; break;
    default: *reinterpret_cast<uint16_t*>(dst) = 0; break;
  }
}

// All of K, then all of V, of entries [c_lo, c_hi) into the W-wide shared
// rows, one commit group a kTile-entry tile: a row's pieces of the head dim
// copied, its pieces past it zeros.  kUnit: the bytes of a piece, or 0 for
// `unit` at run time.
template <typename T, int D, int kUnit>
__device__ __forceinline__ void copy_tiles(T* ks, T* vs, const T* kb, const T* vb,
                                           long long kss, int t_lo, int t_hi, int c_lo,
                                           int c_hi, int dim, int unit, int tid) {
  const int bytes = kUnit ? kUnit : unit;
  const int per = bytes / (int)sizeof(T);  // elements a piece
  const int pieces = D / per;              // pieces of a W-wide shared row
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass == 0 ? kb : vb;
    T* dst = pass == 0 ? ks : vs;
    for (int t = t_lo; t < t_hi; ++t) {
      const int e0 = max(t * kTile, c_lo), e1 = min(t * kTile + kTile, c_hi);
      for (int i = tid; i < (e1 - e0) * pieces; i += kThreads) {
        const int e = e0 + i / pieces, u = i % pieces;
        T* to = dst + e * D + u * per;
        if (u * per < dim)
          copy_piece(to, src + e * kss + u * per, bytes);
        else
          zero_piece(to, bytes);
      }
      cp_async_commit();
    }
  }
}

template <typename T, int D>
struct Geo {
  static constexpr int kLK = D / 4 < 8 ? D / 4 : 8;  // lanes an entry for the scores
  static constexpr int kDL = D / kLK;                // dimensions a lane (multiple of 4)
  static constexpr int kLD = D / 4;                  // lanes across D for P V
  static constexpr int kEG = kThreads / kLD;         // entry groups for P V
  static constexpr int kRed = kEG * kMaxG * D * 4;   // P V partial sums (bytes)
  // q [kMaxG][D] float, scores [kMaxG][kMaxSplit] float, stats (m, l, flag),
  // then K [split][D] (reused for the P V sums) and V [split][D] in T
  static constexpr int kQ = 0;
  static constexpr int kSc = kQ + kMaxG * D * 4;
  static constexpr int kStats = kSc + kMaxG * kMaxSplit * 4;
  static constexpr int kK = kStats + 16 * kMaxG + 16;
  __host__ __device__ static int k_bytes(int split) {
    const int k = split * D * (int)sizeof(T);
    return ((k > kRed ? k : kRed) + 15) & ~15;
  }
  static int bytes(int split) { return kK + k_bytes(split) + split * D * (int)sizeof(T); }
  static_assert(kK % 16 == 0, "K and V 16-byte aligned");
  static_assert(D <= 128, "head dim 256 runs decode_attention_d256_kernel");
  // the largest split's layout (D = 128, float32: 71,824 bytes) fits the
  // 227 KB a block can use; the launch raises the kernel's attribute to it
  static_assert(kK + (kMaxSplit * D * (int)sizeof(T) > kRed ? kMaxSplit * D * (int)sizeof(T)
                                                             : kRed) +
                        kMaxSplit * D * (int)sizeof(T) <= 232448,
                "fits the 227 KB a block can use");
};

// D: the geometry's width; dim (<= D): the head dim; unit: the bytes of a
// piece of a row's copy (copy_unit); kUnit: 16 where unit is (every served
// model's rows: the piece a compile-time size), else 0.
template <typename T, int D, int kUnit>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ cache_len,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int* __restrict__ counters,
                        T* __restrict__ o, float* __restrict__ lse, int H, int KVH, int Smax,
                        int split, int n_split, int kv_start, long long qsb, long long qsh,
                        long long ksb, long long kss, long long ksh, long long osb,
                        long long osh, int window, float scale, int dim, int unit) {
  using Gm = Geo<T, D>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem + Gm::kQ);      // [kMaxG][D]
  float* sc = reinterpret_cast<float*>(smem + Gm::kSc);     // [kMaxG][kMaxSplit]
  float* st_m = reinterpret_cast<float*>(smem + Gm::kStats);  // [kMaxG]
  float* st_l = st_m + kMaxG;                                 // [kMaxG]
  int* last = reinterpret_cast<int*>(st_l + kMaxG);
  T* ks = reinterpret_cast<T*>(smem + Gm::kK);               // [split][D]
  float* red = reinterpret_cast<float*>(smem + Gm::kK);      // [kEG][kMaxG][D], after K
  T* vs = reinterpret_cast<T*>(smem + Gm::kK + Gm::k_bytes(split));  // [split][D]

  const int G = H / KVH;
  const int n_gc = (G + kMaxG - 1) / kMaxG;
  const int sp = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / n_gc, gc = blockIdx.y - kvh * n_gc;
  const int g0 = gc * kMaxG, Gc = min(kMaxG, G - g0);  // this block's query heads
  const int h0 = kvh * G + g0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int lo, hi;
  valid_range(*cache_len, Smax, window, kv_start, &lo, &hi);
  const int s_lo = lo / split;
  const int s_hi = hi > lo ? (hi + split - 1) / split : s_lo;
  const int n_active = s_hi - s_lo;
  if (n_active == 0) {  // nothing valid: the output is 0 (lse -1e30), written by split 0
    if (sp == 0) {
      for (int i = tid; i < Gc * dim; i += kThreads)
        from_f32(o + b * osb + (h0 + i / dim) * osh + i % dim, 0.f);
      if (lse != nullptr && tid < Gc) lse[(long long)b * H + h0 + tid] = kNoEntry;
    }
    return;
  }
  if (sp < s_lo || sp >= s_hi) return;  // nothing valid here: read nothing
  const int k0 = sp * split;
  const int c_lo = max(lo, k0) - k0, c_hi = min(hi, k0 + split) - k0;  // [c_lo, c_hi)
  const int t_lo = c_lo / kTile, t_hi = (c_hi + kTile - 1) / kTile;
  const int nt = t_hi - t_lo;

  // all of K, then all of V, one commit group a tile
  const T* kb = kc + b * ksb + kvh * ksh + (long long)k0 * kss;
  const T* vb = vc + b * ksb + kvh * ksh + (long long)k0 * kss;
  copy_tiles<T, D, kUnit>(ks, vs, kb, vb, kss, t_lo, t_hi, c_lo, c_hi, dim, unit, tid);
  for (int i = tid; i < Gc * D; i += kThreads) {
    const int d = i % D;
    qs[i] = d < dim ? to_f32(q[b * qsb + (h0 + i / D) * qsh + d]) : 0.f;
  }

  // scores, tile by tile as K lands: kLK lanes an entry
  const int grp = lane % Gm::kLK;
  for (int t = t_lo; t < t_hi; ++t) {
    cp_async_wait(2 * nt - 1 - (t - t_lo));
    __syncthreads();  // every thread's copies of this tile (and q) are visible
    const int e = t * kTile + tid / Gm::kLK;
    const bool ok = tid / Gm::kLK < kTile && e >= c_lo && e < c_hi;
    float4 kv[Gm::kDL / 4];
#pragma unroll
    for (int j = 0; j < Gm::kDL / 4; ++j)
      kv[j] = ok ? load4(ks + e * D + 4 * (grp + Gm::kLK * j)) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= Gc) break;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < Gm::kDL / 4; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + 4 * (grp + Gm::kLK * j));
        dot = fmaf(qv.x, kv[j].x, dot);
        dot = fmaf(qv.y, kv[j].y, dot);
        dot = fmaf(qv.z, kv[j].z, dot);
        dot = fmaf(qv.w, kv[j].w, dot);
      }
#pragma unroll
      for (int off = Gm::kLK / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (ok && grp == 0) sc[g * kMaxSplit + e] = dot * scale;
    }
  }
  __syncthreads();

  // the split's softmax, a warp a head
  for (int g = warp; g < Gc; g += kWarps) {
    float mx = -INFINITY;
    for (int e = c_lo + lane; e < c_hi; e += 32) mx = fmaxf(mx, sc[g * kMaxSplit + e]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int e = c_lo + lane; e < c_hi; e += 32) {
      const float p = expf(sc[g * kMaxSplit + e] - mx);
      sc[g * kMaxSplit + e] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      st_m[g] = mx;
      st_l[g] = sum;
    }
  }

  // P V, tile by tile as V lands: 4 dimensions of an entry group a thread
  const int d4 = 4 * (tid % Gm::kLD), eg = tid / Gm::kLD;
  float acc[kMaxG][4];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  for (int t = t_lo; t < t_hi; ++t) {
    cp_async_wait(t_hi - 1 - t);
    __syncthreads();  // this V tile is visible (and, the first time, the softmax)
    const int e1 = min(t * kTile + kTile, c_hi);
    for (int e = max(t * kTile, c_lo) + eg; e < e1; e += Gm::kEG) {
      const float4 v = load4(vs + e * D + d4);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= Gc) break;
        const float p = sc[g * kMaxSplit + e];
        acc[g][0] = fmaf(p, v.x, acc[g][0]);
        acc[g][1] = fmaf(p, v.y, acc[g][1]);
        acc[g][2] = fmaf(p, v.z, acc[g][2]);
        acc[g][3] = fmaf(p, v.w, acc[g][3]);
      }
    }
  }
  // the entry groups' sums, through shared memory (over K, read by now)
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= Gc) break;
    *reinterpret_cast<float4*>(red + (eg * kMaxG + g) * D + d4) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  for (int i = tid; i < Gc * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float a = 0.f;
    for (int j = 0; j < Gm::kEG; ++j) a += red[(j * kMaxG + g) * D + d];
    const long long row = ((long long)b * H + h0 + g) * n_split + sp;
    part_acc[row * D + d] = a;
    if (d == 0) {
      part_m[row] = st_m[g];
      part_l[row] = st_l[g];
    }
  }

  // the last block of this (b, kv head, head group) to finish combines
  __threadfence();
  __syncthreads();
  int* counter = counters + (long long)b * gridDim.y + blockIdx.y;
  if (tid == 0) *last = atomicAdd(counter, 1) == n_active - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // Each head's largest split max and its denominator, a warp a head with
  // its lanes over the splits; then the splits' weights exp(m_s - m), up to
  // kMaxSplit splits at a time in shared memory (over the scores); then
  // each output the weighted sum of its splits' partial sums, the loads of
  // all a thread's outputs (and of four splits) in flight together.
  const long long head0 = (long long)b * H + h0;  // this block's first head, [B, H] index
  for (int g = warp; g < Gc; g += kWarps) {
    const float* pm = part_m + (head0 + g) * n_split;
    const float* pl = part_l + (head0 + g) * n_split;
    float mx = -INFINITY;
    for (int s = s_lo + lane; s < s_hi; s += 32) mx = fmaxf(mx, __ldcg(pm + s));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int s = s_lo + lane; s < s_hi; s += 32) l = fmaf(__ldcg(pl + s), expf(__ldcg(pm + s) - mx), l);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      st_m[g] = mx;
      st_l[g] = l;
    }
  }
  constexpr int kOut = (kMaxG * D + kThreads - 1) / kThreads;  // outputs a thread at most
  float out[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) out[j] = 0.f;
  for (int c0 = s_lo; c0 < s_hi; c0 += kMaxSplit) {
    const int nc = min(kMaxSplit, s_hi - c0);
    __syncthreads();  // the maxima are written, the last chunk's weights read
    for (int i = tid; i < Gc * nc; i += kThreads) {
      const int g = i / nc, s = i - g * nc;
      sc[g * kMaxSplit + s] = expf(__ldcg(part_m + (head0 + g) * n_split + c0 + s) - st_m[g]);
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < nc; ++s) {
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int i = tid + kThreads * j;
        if (i < Gc * D) {
          const int g = i / D, d = i - g * D;
          const float p = __ldcg(part_acc + ((head0 + g) * n_split + c0 + s) * D + d);
          out[j] = fmaf(p, sc[g * kMaxSplit + s], out[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int i = tid + kThreads * j;
    if (i < Gc * D) {
      const int g = i / D, d = i - g * D;
      if (d < dim) from_f32(o + b * osb + (h0 + g) * osh + d, out[j] / fmaxf(st_l[g], 1e-30f));
    }
  }
  if (lse != nullptr && tid < Gc)  // st_m, st_l: read above, after a barrier
    lse[head0 + tid] = st_m[tid] + logf(st_l[tid]);
  if (tid == 0) *counter = 0;  // every block of this call has counted
}

// Head dim `dim` on the geometry of width D >= dim.
template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* len, float* pm,
                   float* pl, float* pa, int* counters, void* o, float* lse, int B, int H,
                   int KVH, int Smax, int dim, int split, int kv_start, const long long* st,
                   int window, float scale, int unit, cudaStream_t stream) {
  using Gm = Geo<T, D>;
  const int G = H / KVH;
  const int n_gc = (G + kMaxG - 1) / kMaxG;
  const int n_split = (Smax + split - 1) / split;
  const int smem = Gm::bytes(split);
  auto kernel = unit == 16 ? decode_attention_kernel<T, D, 16> : decode_attention_kernel<T, D, 0>;
  static int smem_set[2][kMaxDevices] = {};  // smem grows with the split
  cudaError_t err = ensure_smem(kernel, smem, smem_set[unit == 16]);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_split, KVH * n_gc, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), len, pm,
      pl, pa, counters, static_cast<T*>(o), lse, H, KVH, Smax, split, n_split, kv_start, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], window, scale, dim, unit);
  return cudaGetLastError();
}

// The widest piece, 16, 8, 4 or (bfloat16) 2 bytes, that divides a row's
// dim sizeof(T) bytes, every base address in `ptrs` and every stride (in
// elements) in `strides` that is stepped over (its dimension longer than 1).
int copy_unit(const void* const* ptrs, int n_ptrs, const long long* strides,
              const int* extents, int n_strides, int dim, int es) {
  unsigned long long bits = (unsigned long long)dim * es;
  for (int i = 0; i < n_ptrs; ++i) bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
  for (int i = 0; i < n_strides; ++i)
    if (extents[i] > 1) bits |= (unsigned long long)(strides[i] * es);
  int unit = 16;
  while (unit > es && bits % unit != 0) unit /= 2;
  return unit;
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* kc, const void* vc, const int* len,
                     float* pm, float* pl, float* pa, int* cnt, void* o, float* lse, int B,
                     int H, int KVH, int Smax, int split, int k0, const long long* st,
                     int window, float scale, cudaStream_t s) {
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  const void* ptrs[2] = {kc, vc};
  const int extents[3] = {B, Smax, KVH};
  const int u = copy_unit(ptrs, 2, st + 2, extents, 3, D, (int)sizeof(T));
  // the next instantiated width: 8 at 16; 48 at 64; 72, 100 and 112 at 128
  if (D <= 16) return launch<T, 16>(q, kc, vc, len, pm, pl, pa, cnt, o, lse, B, H, KVH, Smax, D, split, k0, st, window, scale, u, s);
  if (D <= 32) return launch<T, 32>(q, kc, vc, len, pm, pl, pa, cnt, o, lse, B, H, KVH, Smax, D, split, k0, st, window, scale, u, s);
  if (D <= 64) return launch<T, 64>(q, kc, vc, len, pm, pl, pa, cnt, o, lse, B, H, KVH, Smax, D, split, k0, st, window, scale, u, s);
  return launch<T, 128>(q, kc, vc, len, pm, pl, pa, cnt, o, lse, B, H, KVH, Smax, D, split, k0, st, window, scale, u, s);
}

// ---------------------------------------------------------------- head dim 256
//
// decode_attention_d256_kernel.  At paligemma-3b's decode shape (B 4, 8 query
// heads on one kv head, a 544-entry cache, float32) there are only
// B KVH ceil(G / 8) = 4 (b, kv head, head group) pairs, each with 1.1 MB of
// K and V to read (4.5 MB a call: 1.3 us at 3.35 TB/s, 4 flops a byte, far
// below the float32 ridge).  The kernel above split the *allocated* cache
// into 16-entry blocks (136, those past cache_len idle), wrote every split's
// partial state to a global workspace (1.1 MB) and had one elected block a
// pair read it back on 4 SMs, behind fences and an atomic.  This kernel:
//  * one thread-block cluster a (b, kv head, group of up to 8 query
//    heads); the wrapper picks the cluster's size (1 to 16 blocks) from the
//    pairs and the SMs: 16 at paligemma's shape, 64 blocks (the card holds
//    7 clusters of 16 at once).  Clusters of 8 are 4-5% slower at 544
//    entries and 1.4-1.9x slower at 8,192-32,768 (up to 0.9 us faster
//    where a share holds a few entries); two clusters a pair, each with 4
//    of the 8 heads, are no faster on clusters of 8 and slower on 16 (8
//    clusters: two waves).  The blocks split the *valid* range [lo, hi),
//    which each computes from cache_len on the device, into shares that
//    differ by at most one entry, so every block works at every cache_len
//    and the bytes read follow the filled cache.  Shares are not rounded to
//    a 32-entry stage: at 544 entries on 16 blocks that would put 64
//    entries on 8 blocks and leave 7 idle;
//  * warp 0 issues bulk copies (cp.async.bulk, TMA's non-tensor form) of a
//    stage's K rows and V rows into a ring of kStages stages, each with an
//    mbarrier for K, one for V and one for its release, as soon as
//    cache_len is read: one copy for each where the rows are one run (KVH =
//    1), else one a row, spread over the warp's lanes.  q's rows come in
//    the first stage's K transaction, and each lane takes its 8 dimensions
//    of them from shared memory (64 scalar loads a lane from device memory
//    took 1.1 us in float32 and 4 us in bfloat16).  A 34-entry share is in
//    flight at once; a 32,768-entry cache cycles through the ring.  Bulk
//    copies beat warp 0's lanes issuing 16-byte cp.async by up to 0.5 us at
//    544 entries and by 1.6-2.1x at 32,768.  Asking for 116 KB of shared
//    memory or more, so that two bfloat16 blocks (111 KB) never share an
//    SM, measured the same;
//  * no block-wide barrier in the loop: each warp takes kWE entries of a
//    stage and keeps its own online softmax over the entries it sees.  A
//    lane holds 8 of the 256 dimensions of q and of the accumulator, for all
//    8 heads, in registers; the warp's kWE x 8 partial scores are summed by
//    a reduce-scatter over the lanes (31 shuffles at kWE = 4), after which
//    each lane holds one (entry, head) score and takes one exponential; the
//    probabilities and rescale factors reach every lane through 160 bytes of
//    shared memory a warp; a rescale whose factor is 1 is skipped.  Stages
//    of 32 entries (kWE = 4) in a ring of 2 (float32) or 3 (bfloat16) were
//    kept over 16-entry stages (kWE = 2) in a ring of 4: those tie at 544
//    entries and are up to 0.8 us faster where a share holds a few entries
//    (a window, a short cache), but slower at 8,192 and 32,768 entries,
//    where the loop's instructions bound the kernel (bfloat16 by 18-27%,
//    float32 by up to 23%, in two runs);
//  * the combine stays on chip: the block's warps are merged through shared
//    memory (over the spent ring); then each block stores its maxima and
//    denominators into every peer's shared memory, and each 256 / cluster
//    slice of its accumulators into the peer that combines that slice
//    (distributed shared memory: stores, which do not wait for a reply).
//    One cluster barrier (release, acquire) later each block combines its
//    slice from its own shared memory and writes it, divided by
//    max(l, 1e-30).  No workspace, no atomic, no fence.  The barrier's
//    first half, arrived at when the block starts and waited for before its
//    first remote store, ensures every peer has started;
//  * scores and P V are float32 FMA on the CUDA cores: at 4 flops a byte no
//    tensor-core route pays at paligemma's length.
// The choices above are scripts/decode_variants.py's measurements (NVIDIA
// H100 80GB HBM3, 700 W).
// A block whose share is empty (cache_len below the cluster's size, a
// window, cache_len 0, a shard past cache_len) copies nothing and still
// meets its cluster at both barriers; with no valid entry at all the output
// is 0 (and lse -1e30).
// Head dims from 129 to 255 run this kernel too: each row's D columns are
// copied into its 256-wide shared row (per-row bulk copies of D sizeof(T)
// bytes), whose columns past D every thread zeroes once before the first
// copy (no copy ever writes them); q's likewise; o's D columns are written.
// Where a row's bytes, the base addresses or the strides are not whole
// 16-byte units (copy_unit below 16), the bulk copies cannot take them:
// warp 0's lanes copy the rows in 8- or 4-byte cp.async pieces (plain loads
// for a bfloat16 at an odd D), and the K and V barriers count the 32 lanes'
// arrivals in place of the bytes.

constexpr int kD256 = 256;
constexpr int kWarps256 = 8;
constexpr int kThreads256 = 32 * kWarps256;
constexpr int kHeads256 = 8;        // query heads a lane's registers hold
constexpr int kGroupHeads = kHeads256;  // query heads a cluster serves
constexpr int kMaxCluster = 16;     // blocks a cluster at most (above 8: non-portable)

// Shared memory of one instance: the ring (a stage: the K rows, then the V
// rows, of kEntries = 8 kWE entries), reused after the loop for the warps'
// accumulators; the inbox where the cluster's blocks store their states'
// slices that this block combines (maxima and denominators apart); q's rows;
// the warps' maxima and denominators; the cluster's weights; each warp's
// probabilities and rescale factors; the ring's mbarriers.
template <typename T, int kWE_, int kStages_>
struct Geo256 {
  static constexpr int kWE = kWE_;  // entries a warp takes of a stage
  static constexpr int kStages = kStages_;
  static constexpr int kEntries = kWarps256 * kWE;
  static constexpr int kRow = kD256 * (int)sizeof(T);
  static constexpr int kTileBytes = kEntries * kRow;  // the K (or V) rows of a stage
  static constexpr int kRing = 2 * kStages * kTileBytes;
  static constexpr int kWAcc = kWarps256 * kHeads256 * kD256 * 4;
  static constexpr int kIn = kRing > kWAcc ? kRing : kWAcc;  // [cluster][kHeads256][256 / cluster]
  static constexpr int kInML = kIn + kHeads256 * kD256 * 4;  // [kMaxCluster][2][kHeads256]
  static constexpr int kQ = kInML + 2 * kMaxCluster * kHeads256 * 4;  // [kHeads256][256] T
  static constexpr int kWM = kQ + kHeads256 * kRow;                  // [2][kWarps256][kHeads256]
  static constexpr int kWt = kWM + 2 * kWarps256 * kHeads256 * 4;  // [kMaxCluster + 1][kHeads256]
  static constexpr int kScr = kWt + (kMaxCluster + 1) * kHeads256 * 4;
  static constexpr int kScrWarp = (kWE + 1) * kHeads256;      // floats: [kWE][8] p, [8] alpha
  static constexpr int kBars = kScr + kWarps256 * kScrWarp * 4;
  static constexpr int kSmem = kBars + 3 * kStages * 8;
  static_assert(kWE == 1 || kWE == 2 || kWE == 4, "kWE x 8 scores reduce-scatter over a warp");
  static_assert(kTileBytes % 16 == 0 && kIn % 16 == 0 && kScr % 16 == 0 && kBars % 16 == 0,
                "16-byte aligned");
  static_assert(kSmem <= 232448, "fits the 227 KB a block can use");
};

template <typename T>
struct Geo256Of;
template <>
struct Geo256Of<float> {  // 32 entries a stage, 2 stages: a 128 KB ring
  using G = Geo256<float, 4, 2>;
};
template <>
struct Geo256Of<__nv_bfloat16> {  // 32 entries a stage, 3 stages: a 96 KB ring
  using G = Geo256<__nv_bfloat16, 4, 3>;
};

// Lane `lane` holds 8 of a row's 256 dimensions: float32 the 16-byte chunks
// lane and lane + 32, bfloat16 the chunk lane (a warp's loads of a row
// are contiguous and conflict-free either way).
template <typename T>
__device__ __forceinline__ int lane_dim(int lane, int i) {
  if constexpr (sizeof(T) == 4) {
    return 4 * (lane + 32 * (i >> 2)) + (i & 3);
  } else {
    return 8 * lane + i;
  }
}

// The lane's 8 elements of a cache row in shared memory, as floats.
__device__ __forceinline__ void row8(const float* row, int lane, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * lane);
  const float4 c = *reinterpret_cast<const float4*>(row + 128 + 4 * lane);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = c.x, x[5] = c.y, x[6] = c.z, x[7] = c.w;
}
__device__ __forceinline__ void row8(const __nv_bfloat16* row, int lane, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * lane);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

// The lane's 8 values in a 256-float row of shared memory, at float32's
// lane positions (conflict-free whatever the values' dimensions).
__device__ __forceinline__ void load8f(const float* row, int lane, float (&x)[8]) {
  row8(row, lane, x);
}
__device__ __forceinline__ void store8f(float* row, int lane, const float (&x)[8]) {
  *reinterpret_cast<float4*>(row + 4 * lane) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(row + 128 + 4 * lane) = make_float4(x[4], x[5], x[6], x[7]);
}

// 8 consecutive floats of shared memory (16-byte aligned), the same in
// every lane.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = c.x, x[5] = c.y, x[6] = c.z, x[7] = c.w;
}

// Sums each of a warp's N partial values (N = 8, 16 or 32) over its 32
// lanes and returns to lane l the total of value l >> (5 - log2 N): halving
// exchanges (N - 1 shuffles), then plain sums over the lanes that hold the
// same value (5 - log2 N shuffles).
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  constexpr int kSteps = N == 32 ? 5 : (N == 16 ? 4 : (N == 8 ? 3 : -1));
  static_assert(kSteps > 0, "8, 16 or 32 values");
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int half = N >> (step + 1), o = 16 >> step;
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if (i < half) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
  }
  float x = v[0];
#pragma unroll
  for (int o = 16 >> kSteps; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The cluster barrier in two halves: arrive (relaxed: orders nothing; or
// release: this thread's earlier stores, remote ones included) and wait
// (acquire).  Every thread of every block of the cluster takes part.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, typename Gm>
__global__ void __launch_bounds__(kThreads256, 1)
decode_attention_d256_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                             const T* __restrict__ vc, const int* __restrict__ cache_len,
                             T* __restrict__ o, float* __restrict__ lse, int H, int KVH,
                             int Smax, int csize, int kv_start, long long qsb, long long qsh,
                             long long ksb, long long kss, long long ksh, long long osb,
                             long long osh, int window, float scale, int dim, int unit) {
  constexpr int kWE = Gm::kWE, kStages = Gm::kStages, kEntries = Gm::kEntries;
  constexpr int kN = kWE * kHeads256;  // a lane's partial scores a stage
  constexpr int kSteps = kN == 32 ? 5 : (kN == 16 ? 4 : 3);
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int G = H / KVH;
  const int g0 = (int)(blockIdx.x / csize) * kGroupHeads, Gc = min(kGroupHeads, G - g0);
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int h0 = kvh * G + g0;  // the cluster's first query head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* in = reinterpret_cast<float*>(smem + Gm::kIn);
  float* in_ml = reinterpret_cast<float*>(smem + Gm::kInML);
  const T* qs = reinterpret_cast<const T*>(smem + Gm::kQ);
  float* wm = reinterpret_cast<float*>(smem + Gm::kWM);
  float* wt = reinterpret_cast<float*>(smem + Gm::kWt);
  float* scr = reinterpret_cast<float*>(smem + Gm::kScr) + warp * Gm::kScrWarp;
  const uint32_t kfull = smem_u32(smem + Gm::kBars);  // K landed, V landed, stage freed
  const uint32_t vfull = kfull + 8 * kStages, freed = vfull + 8 * kStages;

  const bool bulk = unit == 16;  // bulk copies; else warp 0's lanes' pieces
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull + 8 * s, bulk ? 1 : 32);
      mbar_init(vfull + 8 * s, bulk ? 1 : 32);
      mbar_init(freed + 8 * s, kWarps256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (dim < kD256) {  // the columns past the head dim of every ring row and q row: zeros
    const int pad = kD256 - dim, rows = 2 * kStages * kEntries;
    T* ring = reinterpret_cast<T*>(smem);
    T* qrow = reinterpret_cast<T*>(smem + Gm::kQ);
    for (int i = tid; i < (rows + kHeads256) * pad; i += kThreads256) {
      const int r = i / pad, d = dim + i % pad;
      from_f32(r < rows ? ring + r * kD256 + d : qrow + (r - rows) * kD256 + d, 0.f);
    }
  }
  cluster_arrive_relaxed();  // this block has started (waited for before the first remote store)
  // this block's share [e0, e0 + n) of the valid entries [lo, hi)
  int lo, hi;
  valid_range(*cache_len, Smax, window, kv_start, &lo, &hi);
  const long long nv = hi > lo ? hi - lo : 0;
  const int e0 = lo + (int)(rank * nv / csize);
  const int n = lo + (int)((rank + 1) * nv / csize) - e0;
  const int nt = (n + kEntries - 1) / kEntries;  // stages' worth of entries
  __syncthreads();  // the barriers are initialised

  const T* kb = kc + b * ksb + kvh * ksh + (long long)e0 * kss;
  const T* vb = vc + b * ksb + kvh * ksh + (long long)e0 * kss;
  const T* qb = q + b * qsb + (long long)h0 * qsh;
  // warp 0: stage t % kStages <- the K rows and the V rows of tile t; with
  // tile 0, on its K barrier, q's Gc rows (a block with no entries needs
  // no q)
  const uint32_t row_bytes = (uint32_t)(dim * (int)sizeof(T));  // the bytes of a row copied
  const bool whole = dim == kD256;  // shared rows as packed as the head dim's
  auto issue = [&](int t) {
    const int s = t % kStages, r0 = t * kEntries, rows = min(kEntries, n - r0);
    const int qrows = t == 0 ? Gc : 0;
    uint8_t* kdst = smem + s * 2 * Gm::kTileBytes;
    uint8_t* vdst = kdst + Gm::kTileBytes;
    if (!bulk) {  // each lane its pieces of the rows, then its arrivals
      T* kt = reinterpret_cast<T*>(kdst);
      T* vt = reinterpret_cast<T*>(vdst);
      const int per = unit / (int)sizeof(T), pieces = dim / per;
      for (int i = lane; i < qrows * pieces; i += 32) {
        const int r = i / pieces, u = i - r * pieces;
        copy_piece(const_cast<T*>(qs) + r * kD256 + u * per, qb + r * qsh + u * per, unit);
      }
      for (int i = lane; i < rows * pieces; i += 32) {
        const int r = i / pieces, u = i - r * pieces;
        copy_piece(kt + r * kD256 + u * per, kb + (r0 + r) * kss + u * per, unit);
      }
      if (unit >= 4) cp_async_mbar_arrive(kfull + 8 * s); else mbar_arrive(kfull + 8 * s);
      for (int i = lane; i < rows * pieces; i += 32) {
        const int r = i / pieces, u = i - r * pieces;
        copy_piece(vt + r * kD256 + u * per, vb + (r0 + r) * kss + u * per, unit);
      }
      if (unit >= 4) cp_async_mbar_arrive(vfull + 8 * s); else mbar_arrive(vfull + 8 * s);
      return;
    }
    const uint32_t bytes = (uint32_t)rows * row_bytes;
    if (lane == 0) {
      mbar_expect_tx(kfull + 8 * s, bytes + (uint32_t)qrows * row_bytes);
      mbar_expect_tx(vfull + 8 * s, bytes);
    }
    __syncwarp();
    if (qrows > 0 && ((whole && qsh == kD256) || qrows == 1)) {  // q's rows are one run
      if (lane == 0)
        bulk_load(smem_u32(qs), qb, (uint32_t)qrows * row_bytes, kfull + 8 * s);
    } else if (lane < qrows) {
      bulk_load(smem_u32(qs + lane * kD256), qb + lane * qsh, row_bytes, kfull + 8 * s);
    }
    if (whole && kss == kD256) {  // the rows are one run
      if (lane == 0) {
        bulk_load(smem_u32(kdst), kb + r0 * kss, bytes, kfull + 8 * s);
        bulk_load(smem_u32(vdst), vb + r0 * kss, bytes, vfull + 8 * s);
      }
    } else {
      for (int r = lane; r < rows; r += 32) {
        bulk_load(smem_u32(kdst + r * Gm::kRow), kb + (r0 + r) * kss, row_bytes, kfull + 8 * s);
        bulk_load(smem_u32(vdst + r * Gm::kRow), vb + (r0 + r) * kss, row_bytes, vfull + 8 * s);
      }
    }
  };
  if (warp == 0)
    for (int t = 0; t < min(kStages, nt); ++t) issue(t);

  // q's rows in registers, once they land with tile 0: the lane's 8
  // dimensions of each of the cluster's heads (0 past Gc)
  float qr[kHeads256][8];
  if (nt > 0) mbar_wait(kfull, 0);
#pragma unroll
  for (int g = 0; g < kHeads256; ++g) {
    if (nt > 0 && g < Gc) {
      row8(qs + g * kD256, lane, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qr[g][i] = 0.f;
    }
  }

  // The lane's (entry, head) after the reduce-scatter, its head's running
  // max and denominator over this warp's entries, its 8 dimensions of every
  // head's accumulator.
  const int idx = lane >> (5 - kSteps);
  const int my_e = idx / kHeads256, my_g = idx % kHeads256;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[kHeads256][8];
#pragma unroll
  for (int g = 0; g < kHeads256; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int s = t % kStages;
    const uint32_t par = (uint32_t)(t / kStages) & 1u;
    const int ne = min(kWE, n - t * kEntries - warp * kWE);  // this warp's entries of the stage
    const T* ks = reinterpret_cast<const T*>(smem + s * 2 * Gm::kTileBytes) + warp * kWE * kD256;
    const T* vs = ks + kEntries * kD256;
    mbar_wait(kfull + 8 * s, par);
    if (ne > 0) {
      float v[kN];
#pragma unroll
      for (int e = 0; e < kWE; ++e) {
        float kx[8];
        if (e < ne) {
          row8(ks + e * kD256, lane, kx);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) kx[i] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < kHeads256; ++g) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) d = fmaf(qr[g][i], kx[i], d);
          v[e * kHeads256 + g] = d;
        }
      }
      const float dot = reduce_scatter<kN>(v, lane);
      const bool ok = my_e < ne;
      const float sc = ok ? dot * scale : -INFINITY;
      // the group's max and sum for the lane's head: over the lanes of its
      // other entries
      float mx = sc;
#pragma unroll
      for (int off = 16; off >= (1 << (8 - kSteps)); off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);  // finite: the group's first entry is valid
      const float alpha = expf(m_run - m_new);
      const float p = ok ? expf(sc - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 16; off >= (1 << (8 - kSteps)); off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run = fmaf(l_run, alpha, ps);
      m_run = m_new;
      __syncwarp();  // every lane has read the last group's probabilities
      scr[idx] = p;
      if (my_e == 0) scr[kWE * kHeads256 + my_g] = alpha;
      __syncwarp();
    }
    mbar_wait(vfull + 8 * s, par);
    if (ne > 0) {
      float a[8];
      load8(scr + kWE * kHeads256, a);  // the 8 heads' factors, in every lane
#pragma unroll
      for (int g = 0; g < kHeads256; ++g)
        if (a[g] != 1.f)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] *= a[g];
#pragma unroll
      for (int e = 0; e < kWE; ++e) {
        if (e < ne) {
          float vx[8], pe[8];
          row8(vs + e * kD256, lane, vx);
          load8(scr + e * kHeads256, pe);
#pragma unroll
          for (int g = 0; g < kHeads256; ++g)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(pe[g], vx[i], acc[g][i]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(freed + 8 * s);  // this warp is done with the stage
    if (warp == 0 && t + kStages < nt) {
      mbar_wait(freed + 8 * s, par);
      issue(t + kStages);
    }
  }
  __syncthreads();  // every warp is past the ring, and every copy has landed

  // the warps' states, merged into the block's: warp g for head g (the
  // accumulators in shared memory at the float32 lanes' positions, which
  // are conflict-free for either type)
  float* wacc = reinterpret_cast<float*>(smem);  // [kWarps256][kHeads256][256], over the ring
#pragma unroll
  for (int g = 0; g < kHeads256; ++g) store8f(wacc + (warp * kHeads256 + g) * kD256, lane, acc[g]);
  if (my_e == 0) {
    wm[warp * kHeads256 + my_g] = m_run;
    wm[(kWarps256 + warp) * kHeads256 + my_g] = l_run;
  }
  __syncthreads();
  const int dc = kD256 / csize;  // the dimensions each block of the cluster combines
  {
    const int g = warp;
    float mw[kWarps256], M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps256; ++w) {
      mw[w] = wm[w * kHeads256 + g];
      M = fmaxf(M, mw[w]);
    }
    float L = 0.f, x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kWarps256; ++w) {
      const float c = mw[w] == -INFINITY ? 0.f : expf(mw[w] - M);
      L = fmaf(wm[(kWarps256 + w) * kHeads256 + g], c, L);
      float y[8];
      load8f(wacc + (w * kHeads256 + g) * kD256, lane, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = fmaf(y[i], c, x[i]);
    }
    // the block's state, pushed into its peers' shared memory: each 4
    // dimensions to the block that combines them, the max and denominator
    // to all
    cluster_wait();  // every peer has started
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = lane_dim<T>(lane, 4 * j), r = d / dc;
      float* peer = cluster.map_shared_rank(in, r);
      *reinterpret_cast<float4*>(peer + (rank * kHeads256 + g) * dc + d - r * dc) =
          make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
    }
    if (lane < csize) {
      float* peer = cluster.map_shared_rank(in_ml, lane);
      peer[(2 * rank) * kHeads256 + g] = M;
      peer[(2 * rank + 1) * kHeads256 + g] = L;
    }
  }
  cluster_arrive();  // release: this block's stores to its peers
  cluster_wait();    // acquire: every peer's stores to this block
  // the cluster's combine of this block's dimensions, from its own shared
  // memory (no block touches another's after the barrier)
  if (tid < kHeads256) {  // a thread a head: the blocks' weights and the denominator
    const int g = tid;
    float M = -INFINITY;
    for (int r = 0; r < csize; ++r) M = fmaxf(M, in_ml[2 * r * kHeads256 + g]);
    float L = 0.f;
    for (int r = 0; r < csize; ++r) {
      const float m = in_ml[2 * r * kHeads256 + g];
      const float c = m == -INFINITY ? 0.f : expf(m - M);
      wt[r * kHeads256 + g] = c;
      L = fmaf(in_ml[(2 * r + 1) * kHeads256 + g], c, L);
    }
    wt[kMaxCluster * kHeads256 + g] = L;
    if (lse != nullptr && rank == 0 && g < Gc)  // M: -inf where no block saw an entry
      lse[(long long)b * H + h0 + g] = M == -INFINITY ? kNoEntry : M + logf(L);
  }
  __syncthreads();
  for (int i = tid; i < Gc * dc; i += kThreads256) {
    const int g = i / dc, j = i - g * dc;
    if (rank * dc + j >= dim) continue;  // o's columns past the head dim are never written
    float a = 0.f;
    for (int r = 0; r < csize; ++r) a = fmaf(in[(r * kHeads256 + g) * dc + j], wt[r * kHeads256 + g], a);
    from_f32(o + b * osb + (long long)(h0 + g) * osh + rank * dc + j,
             a / fmaxf(wt[kMaxCluster * kHeads256 + g], 1e-30f));
  }
}

// The launch of clusters of `csize` blocks over `grid` (the kernel's
// attributes raised as it needs), or an error code.
template <typename T>
cudaError_t configure256(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int csize,
                         dim3 grid) {
  using Gm = typename Geo256Of<T>::G;
  if (csize < 1 || csize > kMaxCluster || (csize & (csize - 1)) != 0) return cudaErrorInvalidValue;
  auto kernel = decode_attention_d256_kernel<T, Gm>;
  static int smem_set[kMaxDevices] = {};
  cudaError_t err = ensure_smem(kernel, Gm::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  static bool wide[kMaxDevices] = {};
  if (csize > 8 && (err = allow_wide_clusters(kernel, wide)) != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(kThreads256, 1, 1);
  cfg->dynamicSmemBytes = Gm::kSmem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Head dim `dim` from 129 to 256.
template <typename T>
cudaError_t launch256(const void* q, const void* kc, const void* vc, const int* len, void* o,
                      float* lse, int B, int H, int KVH, int Smax, int dim, int kv_start,
                      const long long* st, int window, float scale, int csize,
                      cudaStream_t stream) {
  if (dim <= 128 || dim > kD256) return cudaErrorInvalidValue;
  const int n_groups = (H / KVH + kGroupHeads - 1) / kGroupHeads;
  const void* ptrs[3] = {q, kc, vc};
  const long long strides[5] = {st[0], st[1], st[2], st[3], st[4]};  // q (b, h), caches (b, s, h)
  const int extents[5] = {B, H, B, Smax, KVH};
  const int unit = copy_unit(ptrs, 3, strides, extents, 5, dim, (int)sizeof(T));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure256<T>(&cfg, attr, csize, dim3(csize * n_groups, KVH, B));
  if (err != cudaSuccess) return err;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, decode_attention_d256_kernel<T, typename Geo256Of<T>::G>,
                           static_cast<const T*>(q), static_cast<const T*>(kc),
                           static_cast<const T*>(vc), len, static_cast<T*>(o), lse, H, KVH,
                           Smax, csize, kv_start, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                           window, scale, dim, unit);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t max_clusters256(int csize, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = configure256<T>(&cfg, attr, csize, dim3(csize, 1, 1));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      out, (void*)decode_attention_d256_kernel<T, typename Geo256Of<T>::G>, &cfg);
}

}  // namespace

// The kernels' geometry, for the wrapper's split, workspace and cluster:
// what = 0, cache entries a commit group (splits are multiples of it); 1, the
// largest split; 2, the query heads a block serves (a kv head with more takes
// ceil(G / this) blocks a split, each with its own counter); 3, the query
// heads a cluster of the head-dim-256 kernel serves; 4, that kernel's
// largest cluster.
extern "C" int repro_decode_attention_geometry(int what) {
  switch (what) {
    case 0: return kTile;
    case 1: return kMaxSplit;
    case 2: return kMaxG;
    case 3: return kGroupHeads;
    case 4: return kMaxCluster;
    default: return -1;
  }
}

// Head dims from 1 to 128 (any other returns cudaErrorInvalidValue).  q/o [B, 1, H, D] (strides of b and h), caches
// [B, Smax, KVH, D] (k and v share their strides), cache_len one int32 on the
// device.  The workspace:
// part_m and part_l [B, H, n_split], part_acc [B, H, n_split, W] float32 (W
// the instantiated width D runs at: the next of 16, 32, 64, 128),
// counters [B, KVH ceil(G / 8)] int32, zero before the first call (each call
// leaves them zero); n_split = ceil(Smax / split).  The caches are the
// entries [kv_start, kv_start + Smax) of a cache of which cache_len are
// valid; lse (NULL: not written) float32 [B, H], each head's log-sum-exp.
extern "C" int repro_decode_attention(const void* q, const void* kc, const void* vc,
                                      const void* cache_len, void* part_m, void* part_l,
                                      void* part_acc, void* counters, void* o, void* lse, int B,
                                      int H, int KVH, int Smax, int D, int split, int bf16,
                                      int kv_start, long long qsb, long long qsh, long long ksb,
                                      long long kss, long long ksh, long long osb,
                                      long long osh, int window, float scale, void* stream) {
  if (B < 1 || B > 65535 || Smax < 1 || KVH < 1 || H % KVH != 0 || kv_start < 0)
    return (int)cudaErrorInvalidValue;
  if (split < kTile || split > kMaxSplit || split % kTile != 0) return (int)cudaErrorInvalidValue;
  const long long st[7] = {qsb, qsh, ksb, kss, ksh, osb, osh};
  const int* len = static_cast<const int*>(cache_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(D, q, kc, vc, len, pm, pl, pa, cnt, o, ls, B,
                                                   H, KVH, Smax, split, kv_start, st, window,
                                                   scale, s)
                         : dispatch<float>(D, q, kc, vc, len, pm, pl, pa, cnt, o, ls, B, H, KVH,
                                           Smax, split, kv_start, st, window, scale, s);
  return (int)err;
}

// Head dims D from 129 to 256: q/o [B, 1, H, D] (strides of b and h), caches
// [B, Smax, KVH, D] (k and v share their strides), cache_len one int32 on
// the device; clusters of `cluster` blocks (1, 2, 4, 8 or 16), each serving
// up to 8 of a kv head's query heads.  kv_start and lse as above.
extern "C" int repro_decode_attention_d256(const void* q, const void* kc, const void* vc,
                                           const void* cache_len, void* o, void* lse, int B,
                                           int H, int KVH, int Smax, int D, int bf16, int kv_start,
                                           long long qsb, long long qsh, long long ksb,
                                           long long kss, long long ksh, long long osb,
                                           long long osh, int window, float scale, int cluster,
                                           void* stream) {
  if (B < 1 || B > 65535 || Smax < 1 || KVH < 1 || KVH > 65535 || H % KVH != 0 || kv_start < 0)
    return (int)cudaErrorInvalidValue;
  const long long st[7] = {qsb, qsh, ksb, kss, ksh, osb, osh};
  const int* len = static_cast<const int*>(cache_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  return (int)(bf16 ? launch256<__nv_bfloat16>(q, kc, vc, len, o, ls, B, H, KVH, Smax, D,
                                               kv_start, st, window, scale, cluster, s)
                    : launch256<float>(q, kc, vc, len, o, ls, B, H, KVH, Smax, D, kv_start, st,
                                       window, scale, cluster, s));
}

// How many clusters of `cluster` blocks of the head-dim-256 kernel the card
// holds at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int repro_decode_attention_d256_max_clusters(int bf16, int cluster, int* out) {
  return (int)(bf16 ? max_clusters256<__nv_bfloat16>(cluster, out)
                    : max_clusters256<float>(cluster, out));
}
