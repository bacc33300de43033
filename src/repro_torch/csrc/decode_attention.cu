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
// needs no host round trip (and can later be captured in a CUDA graph).
//
// Layout: q and out [B, 1, H, D], caches [B, Smax, KVH, D], read through
// their strides (the last dimension contiguous).  float32 or bfloat16 in,
// float32 inside, out in the input type.
//
// What bounds it on this card: bytes.  A call must read the valid K and V
// rows once (at the slice's shape, B = 4, KVH = 8, D = 128, 544 entries,
// float32: 17.8 MB, 5.3 us at 3.35 TB/s) and does 4 flops per element read,
// far below the card's ~20 flops per byte.  So the design is about reading
// the cache once, from many SMs at a time:
//  * split-KV (flash-decoding): pass 1 runs one block per (b, kv head,
//    64-entry chunk of the cache).  One block per (b, h) walking the whole
//    cache would give B * H = 96 blocks for 132 SMs, each with a serial
//    walk; the split gives B * KVH * ceil(Smax / 64) = 288 here.  A chunk
//    that holds no valid entry (past cache_len, or before the window) exits
//    before reading anything, so the work follows the filled cache, not the
//    allocated one;
//  * a block serves all H / KVH query heads of its kv head, so each K and V
//    row is read from device memory once, not once per query head;
//  * pass 2 combines the chunks' (max, denominator, accumulator) for each
//    (b, h) and divides by max(l, 1e-30), as the reference does.
// Invalid entries inside a valid chunk get probability exactly 0 (in the
// reference they are -1e30 and vanish the same way once a valid key is
// seen; every chunk visited here holds one).  With cache_len = 0 the output
// is 0, as the reference kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;    // cache entries per block of pass 1
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;

// cudaFuncSetAttribute is a driver call on every launch unless it is
// remembered: each launch<T, D> instance keeps, per device, the largest
// shared-memory size it has set (a race between two threads only sets it
// twice).
constexpr int kMaxDevices = 64;

template <typename K>
cudaError_t ensure_smem(K kernel, int smem, int* set_for_device) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= set_for_device[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set_for_device[dev] = smem;
  return err;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The valid entries [lo, hi) for a cache of smax entries.
__device__ __forceinline__ void valid_range(int n, int smax, int window, int* lo, int* hi) {
  *hi = min(max(n, 0), smax);
  *lo = window > 0 ? max(0, n - window) : 0;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ cache_len,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int H, int KVH, int Smax, int n_split,
                      long long qsb, long long qsh, long long ksb, long long kss,
                      long long ksh, int window, float scale) {
  constexpr int kKS = D + 1;  // lanes on consecutive entries hit distinct banks
  constexpr int kDW = (D + 31) / 32;
  extern __shared__ float smem[];
  const int G = H / KVH;
  float* qs = smem;             // [G][D]
  float* ks = qs + G * D;       // [kChunk][D+1]
  float* vs = ks + kChunk * kKS;  // [kChunk][D]
  float* pw = vs + kChunk * D;  // [kWarps][kChunk]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  valid_range(*cache_len, Smax, window, &lo, &hi);
  const int k0 = split * kChunk;
  const int c_lo = max(lo, k0) - k0;       // valid entries of this chunk:
  const int c_hi = min(hi, k0 + kChunk) - k0;  // [c_lo, c_hi)
  if (c_lo >= c_hi) return;                // nothing valid: read nothing

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* kb = kc + b * ksb + kvh * ksh;
  const T* vb = vc + b * ksb + kvh * ksh;
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    qs[idx] = to_f32(q[b * qsb + (kvh * G + g) * qsh + d]);
  }
  for (int idx = tid; idx < kChunk * D; idx += kThreads) {
    const int c = idx / D, d = idx - c * D;
    const bool ok = c >= c_lo && c < c_hi;
    ks[c * kKS + d] = ok ? to_f32(kb[(k0 + c) * kss + d]) : 0.f;
    vs[c * D + d] = ok ? to_f32(vb[(k0 + c) * kss + d]) : 0.f;
  }
  __syncthreads();

  for (int g = warp; g < G; g += kWarps) {
    float s[kChunk / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kChunk / 32; ++j) {
      const int c = lane + 32 * j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qs[g * D + d], ks[c * kKS + d], dot);
      s[j] = (c >= c_lo && c < c_hi) ? dot * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kChunk / 32; ++j) {
      const float p = expf(s[j] - mx);
      pw[warp * kChunk + lane + 32 * j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
    const long long row = ((long long)b * H + kvh * G + g) * n_split + split;
#pragma unroll
    for (int j = 0; j < kDW; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        float a = 0.f;
        for (int c = c_lo; c < c_hi; ++c) a = fmaf(pw[warp * kChunk + c], vs[c * D + d], a);
        part_acc[row * D + d] = a;
      }
    }
    if (lane == 0) {
      part_m[row] = mx;
      part_l[row] = sum;
    }
    __syncwarp();  // pw is rewritten by this warp's next head
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const int* __restrict__ cache_len, const float* __restrict__ part_m,
                      const float* __restrict__ part_l, const float* __restrict__ part_acc,
                      T* __restrict__ o, int H, int D, int Smax, int n_split,
                      long long osb, long long osh, int window) {
  const int h = blockIdx.x, b = blockIdx.y;
  int lo, hi;
  valid_range(*cache_len, Smax, window, &lo, &hi);
  // the chunks pass 1 filled: those holding an entry of [lo, hi)
  const int s_lo = lo / kChunk;
  const int s_hi = hi > lo ? (hi + kChunk - 1) / kChunk : s_lo;
  const long long base = ((long long)b * H + h) * n_split;
  float m = -INFINITY;
  for (int s = s_lo; s < s_hi; ++s) m = fmaxf(m, part_m[base + s]);
  T* orow = o + b * osb + h * osh;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int s = s_lo; s < s_hi; ++s) {
      const float w = expf(part_m[base + s] - m);
      l = fmaf(part_l[base + s], w, l);
      a = fmaf(part_acc[(base + s) * D + d], w, a);
    }
    from_f32(orow + d, a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* len, float* pm,
                   float* pl, float* pa, void* o, int B, int H, int KVH, int Smax,
                   const long long* st, int window, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const int n_split = (Smax + kChunk - 1) / kChunk;
  const int smem = (G * D + kChunk * (D + 1) + kChunk * D + kWarps * kChunk) * (int)sizeof(float);
  auto partial = decode_partial_kernel<T, D>;
  static int smem_set[kMaxDevices] = {};  // smem grows with G = H / KVH
  cudaError_t err = ensure_smem(partial, smem, smem_set);
  if (err != cudaSuccess) return err;
  partial<<<dim3(n_split, KVH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), len,
      pm, pl, pa, H, KVH, Smax, n_split, st[0], st[1], st[2], st[3], st[4], window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(H, B), kThreads, 0, stream>>>(
      len, pm, pl, pa, static_cast<T*>(o), H, D, Smax, n_split, st[5], st[6], window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* kc, const void* vc, const int* len,
                     float* pm, float* pl, float* pa, void* o, int B, int H, int KVH,
                     int Smax, const long long* st, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, kc, vc, len, pm, pl, pa, o, B, H, KVH, Smax, st, window, scale, stream);
    case 32: return launch<T, 32>(q, kc, vc, len, pm, pl, pa, o, B, H, KVH, Smax, st, window, scale, stream);
    case 64: return launch<T, 64>(q, kc, vc, len, pm, pl, pa, o, B, H, KVH, Smax, st, window, scale, stream);
    case 128: return launch<T, 128>(q, kc, vc, len, pm, pl, pa, o, B, H, KVH, Smax, st, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Cache entries per chunk of pass 1: the wrapper sizes the partial buffers
// ([B, H, ceil(Smax / chunk)] and [B, H, ceil(Smax / chunk), D], float32).
extern "C" int repro_decode_attention_chunk(void) { return kChunk; }

// q/o [B, 1, H, D] (strides of b and h), caches [B, Smax, KVH, D] (k and v
// share their strides), cache_len one int32 on the device.
extern "C" int repro_decode_attention(const void* q, const void* kc, const void* vc,
                                      const void* cache_len, void* part_m, void* part_l,
                                      void* part_acc, void* o, int B, int H, int KVH,
                                      int Smax, int D, int bf16, long long qsb, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long osb, long long osh, int window, float scale,
                                      void* stream) {
  if (B < 1 || Smax < 1 || KVH < 1 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  const long long st[7] = {qsb, qsh, ksb, kss, ksh, osb, osh};
  const int* len = static_cast<const int*>(cache_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(D, q, kc, vc, len, pm, pl, pa, o, B, H,
                                                   KVH, Smax, st, window, scale, s)
                         : dispatch<float>(D, q, kc, vc, len, pm, pl, pa, o, B, H, KVH,
                                           Smax, st, window, scale, s);
  return (int)err;
}
