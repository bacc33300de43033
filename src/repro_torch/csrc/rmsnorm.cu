// RMSNorm over the last dimension: out = x * rsqrt(mean(x^2) + eps) * w,
// per row, with float32 sums; x [R, D] float32 or bfloat16, w [D] float32,
// out [R, D] in x's type.
//
// Replaces the Pallas kernel `rmsnorm_kernel` / `rmsnorm_call` of
// src/repro/kernels/rmsnorm.py (pallas_call at :37).  There a grid step
// holds a [block_rows, D] tile in VMEM with the weight resident, and reduces
// each row of the tile at once.  Here the tile is the registers of the warps
// that own a row.
//
// What bounds it on this card: bytes.  A call must read x and w once and
// write out once (2 x 4 x R x D bytes in float32) and does ~4 operations
// per element, far below the ~20 operations per byte where the card's
// float32 rate would be the limit.  So every row is read from device memory
// once, with 16-byte loads, into registers, reduced there, and scaled and
// written from the same registers:
//  * a row of 16-byte-aligned vectors is held by 1, 2, 4 or 8 warps (the
//    fewest that fit), each lane holding NV vectors of it (NV <= 16 in
//    float32, <= 12 in bfloat16, where the unpacked elements and the weight
//    still fit the registers without spilling); NV and the warps a row are
//    template arguments chosen from D at run time, so every such width up to
//    16384 (float32) or 24576 (bfloat16) takes this path.  The warps of a row
//    meet once, in a shared-memory exchange of their partial sums behind a
//    named barrier of those warps alone;
//  * a block of 8 warps takes 8 / (warps a row) rows at a time and walks
//    over the rows with the grid's stride, one block per SM slot, so each
//    warp loads its slice of the weight into registers once for all its
//    rows;
//  * any other row (a width that is not a multiple of 16 bytes, rows or
//    pointers not 16-byte aligned, or a row wider than the registers hold)
//    takes a generic kernel: one block per row, the row read once into
//    shared memory as float32 (each thread reads back only what it wrote) and
//    reduced across the block; a row wider than kMaxSmemD is read a second
//    time (from L2) instead of being held.
// Ragged row counts need nothing; rows are read through their stride (the
// last dimension contiguous).
//
// The sum of squares is taken in another order than the plain version's
// (`torch.mean(x * x)`), so the two agree to float32 rounding, not bit for
// bit; the rest is the same arithmetic in the same order: (x * r) * w, one
// rounding to the output type (round to nearest even for bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemD = 32768;  // the widest row the generic kernel holds (128 KB)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// elements of T in one 16-byte load or store
template <typename T>
__host__ __device__ constexpr int vec_n() { return 16 / (int)sizeof(T); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A row of `vecs` 16-byte vectors: WPR warps own it, each lane NV vectors.
template <typename T, int NV, int WPR>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                    int rows, int D, long long x_row_stride, long long out_row_stride,
                    float eps) {
  constexpr int kN = vec_n<T>();
  constexpr int kLanes = 32 * WPR;       // threads a row
  constexpr int kGroups = kWarps / WPR;  // rows a block holds at a time
  __shared__ float partial[2][kWarps];
  const int vecs = D / kN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / WPR;
  const int tl = (warp % WPR) * 32 + lane;

  float wr[NV][kN];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = v * kLanes + tl;
#pragma unroll
    for (int j = 0; j < kN; j += 4) {
      const float4 f = i < vecs ? reinterpret_cast<const float4*>(w)[(i * kN + j) / 4]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      wr[v][j] = f.x;
      wr[v][j + 1] = f.y;
      wr[v][j + 2] = f.z;
      wr[v][j + 3] = f.w;
    }
  }

  int buf = 0;
  for (int row = blockIdx.x * kGroups + group; row < rows; row += gridDim.x * kGroups) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * x_row_stride);
    uint4 xr[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * kLanes + tl;
      xr[v] = i < vecs ? xv[i] : make_uint4(0u, 0u, 0u, 0u);
    }
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const T* e = reinterpret_cast<const T*>(&xr[v]);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float f = to_float(e[j]);
        acc = fmaf(f, f, acc);
      }
    }
    acc = warp_sum(acc);
    if (WPR > 1) {
      // the row's warps exchange their sums once, behind a barrier of their
      // own (ids 1..kGroups); the slot alternates so the next row's write
      // cannot overtake a slower warp's read
      if (lane == 0) partial[buf][warp] = acc;
      asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(kLanes) : "memory");
      acc = 0.0f;
#pragma unroll
      for (int i = 0; i < WPR; ++i) acc += partial[buf][group * WPR + i];
      buf ^= 1;
    }
    const float r = rsqrtf(acc / (float)D + eps);

    uint4* ov = reinterpret_cast<uint4*>(out + row * out_row_stride);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * kLanes + tl;
      if (i < vecs) {
        const T* e = reinterpret_cast<const T*>(&xr[v]);
        uint4 res;
        T* o = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int j = 0; j < kN; ++j) store(&o[j], (to_float(e[j]) * r) * wr[v][j]);
        ov[i] = res;
      }
    }
  }
}

// Any other row: one block per row, the row held in shared memory (kCached)
// or, past kMaxSmemD, read again from L2 for the second pass.
template <typename T, bool kVectorized, bool kCached>
__global__ void __launch_bounds__(kThreads)
rmsnorm_generic_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                       int D, long long x_row_stride, long long out_row_stride, float eps) {
  extern __shared__ float row_f32[];
  __shared__ float scratch[kWarps];
  const T* xr = x + (long long)blockIdx.x * x_row_stride;
  T* outr = out + (long long)blockIdx.x * out_row_stride;
  constexpr int kN = kVectorized ? vec_n<T>() : 1;
  const int n = D / kN;

  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (kVectorized) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float f = to_float(e[j]);
        if (kCached) row_f32[i * kN + j] = f;
        acc = fmaf(f, f, acc);
      }
    } else {
      const float f = to_float(xr[i]);
      if (kCached) row_f32[i] = f;
      acc = fmaf(f, f, acc);
    }
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = acc;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += scratch[i];  // the same order in every thread
  const float r = rsqrtf(total / (float)D + eps);

  // each thread reads back only the elements it read: no barrier
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (kVectorized) {
      float f[kN];
      if (kCached) {
#pragma unroll
        for (int j = 0; j < kN; ++j) f[j] = row_f32[i * kN + j];
      } else {
        const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < kN; ++j) f[j] = to_float(e[j]);
      }
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < kN; ++j) store(&o[j], (f[j] * r) * w[i * kN + j]);
      reinterpret_cast<uint4*>(outr)[i] = res;
    } else {
      const float f = kCached ? row_f32[i] : to_float(xr[i]);
      store(&outr[i], (f * r) * w[i]);
    }
  }
}

// Blocks of `kernel` that fit on the card at once (cached per device).
template <typename K>
int resident_blocks(K kernel, int smem, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess)
    return 0;
  cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  return cache[dev];
}

struct Args {
  const void* x;
  const float* w;
  void* out;
  int rows, D;
  long long x_row_stride, out_row_stride;
  float eps;
  cudaStream_t stream;
};

template <typename T, int NV, int WPR>
int launch_rows(const Args& a) {
  auto kernel = rmsnorm_rows_kernel<T, NV, WPR>;
  static int resident[kMaxDevices] = {};
  const int slots = resident_blocks(kernel, 0, resident);
  if (slots <= 0) return (int)cudaErrorInvalidDevice;
  constexpr int kGroups = kWarps / WPR;
  const int needed = (a.rows + kGroups - 1) / kGroups;
  const int grid = needed < slots ? needed : slots;
  kernel<<<grid, kThreads, 0, a.stream>>>(static_cast<const T*>(a.x), a.w,
                                          static_cast<T*>(a.out), a.rows, a.D, a.x_row_stride,
                                          a.out_row_stride, a.eps);
  return (int)cudaGetLastError();
}

// the instance of NV = nv, for NV in [NV, kMax]
template <typename T, int WPR, int NV, int kMax>
int launch_rows_nv(int nv, const Args& a) {
  if constexpr (NV > kMax) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (nv == NV) return launch_rows<T, NV, WPR>(a);
    return launch_rows_nv<T, WPR, NV + 1, kMax>(nv, a);
  }
}

template <typename T, bool kVectorized>
int launch_generic(const Args& a) {
  const bool cached = a.D <= kMaxSmemD;
  auto kernel = cached ? rmsnorm_generic_kernel<T, kVectorized, true>
                       : rmsnorm_generic_kernel<T, kVectorized, false>;
  const int smem = cached ? a.D * (int)sizeof(float) : 0;
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cached && smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemD * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = kMaxSmemD * (int)sizeof(float);
  }
  kernel<<<a.rows, kThreads, smem, a.stream>>>(static_cast<const T*>(a.x), a.w,
                                               static_cast<T*>(a.out), a.D, a.x_row_stride,
                                               a.out_row_stride, a.eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a) {
  constexpr int kN = vec_n<T>();
  // the most vectors a lane holds in registers without spilling
  constexpr int kMaxNV = sizeof(T) == 4 ? 16 : 12;
  const bool vectorized =
      a.D % kN == 0 && a.x_row_stride % kN == 0 && a.out_row_stride % kN == 0 &&
      reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.out) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  if (!vectorized) return launch_generic<T, false>(a);
  const int vecs = a.D / kN;
  int wpr = 1;  // the fewest warps a row whose lanes hold at most kMaxNV vectors
  while (wpr < kWarps && vecs > 32 * wpr * kMaxNV) wpr *= 2;
  const int nv = (vecs + 32 * wpr - 1) / (32 * wpr);
  if (nv > kMaxNV) return launch_generic<T, true>(a);
  // with more than one warp a row, the fewer warps held more than kMaxNV
  // vectors a lane, so nv > kMaxNV / 2: only those instances exist
  switch (wpr) {
    case 1: return launch_rows_nv<T, 1, 1, kMaxNV>(nv, a);
    case 2: return launch_rows_nv<T, 2, kMaxNV / 2 + 1, kMaxNV>(nv, a);
    case 4: return launch_rows_nv<T, 4, kMaxNV / 2 + 1, kMaxNV>(nv, a);
    default: return launch_rows_nv<T, 8, kMaxNV / 2 + 1, kMaxNV>(nv, a);
  }
}

}  // namespace

// x [rows, D] (row stride x_row_stride elements, the last dimension
// contiguous), w [D] float32, out [rows, D] (row stride out_row_stride).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_rms_norm(const void* x, const float* w, void* out, int rows, int D,
                              long long x_row_stride, long long out_row_stride, int bf16,
                              float eps, cudaStream_t stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const Args a{x, w, out, rows, D, x_row_stride, out_row_stride, eps, stream};
  return bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}
