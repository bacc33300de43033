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
// their strides (the last dimension contiguous; the caches 16-byte aligned
// with strides of whole 16-byte units, as the wrapper checks).  float32 or
// bfloat16 in, float32 inside, out in the input type.  Head dims 16 to 256
// (paligemma-3b: D = 256 with all 8 query heads on one kv head, 141 KB of
// shared memory at the largest split).
//
// What bounds it on this card: bytes.  A call must read the valid K and V
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
//    loads of a thread's outputs in flight together: at paligemma-3b's 34
//    splits x 8 heads x 256 the combine is most of a call), divides by
//    max(l, 1e-30) as the reference does, writes the output and resets the
//    counter for the next call.
// Invalid entries get probability exactly 0 (in the reference they are
// -1e30 and vanish the same way once a valid key is seen; every split
// visited here holds one).  With cache_len = 0 the output is 0, as the
// reference kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ensure_smem;
using repro::from_f32;
using repro::kMaxDevices;
using repro::to_f32;

constexpr int kTile = 16;      // cache entries a commit group
constexpr int kMaxSplit = 64;  // cache entries a block at most
constexpr int kMaxG = 8;       // query heads a block at most
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;

// The valid entries [lo, hi) for a cache of smax entries.
__device__ __forceinline__ void valid_range(int n, int smax, int window, int* lo, int* hi) {
  *hi = min(max(n, 0), smax);
  *lo = window > 0 ? max(0, n - window) : 0;
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

template <typename T, int D>
struct Geo {
  static constexpr int kLK = D / 4 < 8 ? D / 4 : 8;  // lanes an entry for the scores
  static constexpr int kDL = D / kLK;                // dimensions a lane (multiple of 4)
  static constexpr int kLD = D / 4;                  // lanes across D for P V
  static constexpr int kEG = kThreads / kLD;         // entry groups for P V
  static constexpr int kUnits = D * (int)sizeof(T) / 16;  // 16-byte copies a row
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
  // the largest split's layout (D = 256, float32: 141,456 bytes) fits the
  // 227 KB a block can use; the launch raises the kernel's attribute to it
  static_assert(kK + (kMaxSplit * D * (int)sizeof(T) > kRed ? kMaxSplit * D * (int)sizeof(T)
                                                             : kRed) +
                        kMaxSplit * D * (int)sizeof(T) <= 232448,
                "fits the 227 KB a block can use");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ cache_len,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int* __restrict__ counters,
                        T* __restrict__ o, int H, int KVH, int Smax, int split, int n_split,
                        long long qsb, long long qsh, long long ksb, long long kss,
                        long long ksh, long long osb, long long osh, int window, float scale) {
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
  valid_range(*cache_len, Smax, window, &lo, &hi);
  const int s_lo = lo / split;
  const int s_hi = hi > lo ? (hi + split - 1) / split : s_lo;
  const int n_active = s_hi - s_lo;
  if (n_active == 0) {  // nothing valid: the output is 0, written by split 0
    if (sp == 0)
      for (int i = tid; i < Gc * D; i += kThreads)
        from_f32(o + b * osb + (h0 + i / D) * osh + i % D, 0.f);
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
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass == 0 ? kb : vb;
    T* dst = pass == 0 ? ks : vs;
    for (int t = t_lo; t < t_hi; ++t) {
      const int e0 = max(t * kTile, c_lo), e1 = min(t * kTile + kTile, c_hi);
      for (int i = tid; i < (e1 - e0) * Gm::kUnits; i += kThreads) {
        const int e = e0 + i / Gm::kUnits, u = i % Gm::kUnits;
        cp_async16(dst + e * D + u * (16 / (int)sizeof(T)), src + e * kss + u * (16 / (int)sizeof(T)));
      }
      cp_async_commit();
    }
  }
  for (int i = tid; i < Gc * D; i += kThreads)
    qs[i] = to_f32(q[b * qsb + (h0 + i / D) * qsh + i % D]);

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
      from_f32(o + b * osb + (h0 + g) * osh + d, out[j] / fmaxf(st_l[g], 1e-30f));
    }
  }
  if (tid == 0) *counter = 0;  // every block of this call has counted
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* len, float* pm,
                   float* pl, float* pa, int* counters, void* o, int B, int H, int KVH,
                   int Smax, int split, const long long* st, int window, float scale,
                   cudaStream_t stream) {
  using Gm = Geo<T, D>;
  const int G = H / KVH;
  const int n_gc = (G + kMaxG - 1) / kMaxG;
  const int n_split = (Smax + split - 1) / split;
  const int smem = Gm::bytes(split);
  auto kernel = decode_attention_kernel<T, D>;
  static int smem_set[kMaxDevices] = {};  // smem grows with the split
  cudaError_t err = ensure_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_split, KVH * n_gc, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), len, pm,
      pl, pa, counters, static_cast<T*>(o), H, KVH, Smax, split, n_split, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* kc, const void* vc, const int* len,
                     float* pm, float* pl, float* pa, int* cnt, void* o, int B, int H, int KVH,
                     int Smax, int split, const long long* st, int window, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kc, vc, len, pm, pl, pa, cnt, o, B, H, KVH, Smax, split, st, window, scale, s);
    case 32: return launch<T, 32>(q, kc, vc, len, pm, pl, pa, cnt, o, B, H, KVH, Smax, split, st, window, scale, s);
    case 64: return launch<T, 64>(q, kc, vc, len, pm, pl, pa, cnt, o, B, H, KVH, Smax, split, st, window, scale, s);
    case 128: return launch<T, 128>(q, kc, vc, len, pm, pl, pa, cnt, o, B, H, KVH, Smax, split, st, window, scale, s);
    case 256: return launch<T, 256>(q, kc, vc, len, pm, pl, pa, cnt, o, B, H, KVH, Smax, split, st, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The kernel's geometry, for the wrapper's workspace: what = 0, cache
// entries a commit group (splits are multiples of it); 1, the largest split;
// 2, the query heads a block serves (a kv head with more takes
// ceil(G / this) blocks a split, each with its own counter).
extern "C" int repro_decode_attention_geometry(int what) {
  switch (what) {
    case 0: return kTile;
    case 1: return kMaxSplit;
    case 2: return kMaxG;
    default: return -1;
  }
}

// q/o [B, 1, H, D] (strides of b and h), caches [B, Smax, KVH, D] (k and v
// share their strides), cache_len one int32 on the device.  The workspace:
// part_m and part_l [B, H, n_split], part_acc [B, H, n_split, D] float32,
// counters [B, KVH ceil(G / 8)] int32, zero before the first call (each call
// leaves them zero); n_split = ceil(Smax / split).
extern "C" int repro_decode_attention(const void* q, const void* kc, const void* vc,
                                      const void* cache_len, void* part_m, void* part_l,
                                      void* part_acc, void* counters, void* o, int B, int H,
                                      int KVH, int Smax, int D, int split, int bf16,
                                      long long qsb, long long qsh, long long ksb,
                                      long long kss, long long ksh, long long osb,
                                      long long osh, int window, float scale, void* stream) {
  if (B < 1 || B > 65535 || Smax < 1 || KVH < 1 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  if (split < kTile || split > kMaxSplit || split % kTile != 0) return (int)cudaErrorInvalidValue;
  const long long st[7] = {qsb, qsh, ksb, kss, ksh, osb, osh};
  const int* len = static_cast<const int*>(cache_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(D, q, kc, vc, len, pm, pl, pa, cnt, o, B, H,
                                                   KVH, Smax, split, st, window, scale, s)
                         : dispatch<float>(D, q, kc, vc, len, pm, pl, pa, cnt, o, B, H, KVH,
                                           Smax, split, st, window, scale, s);
  return (int)err;
}
