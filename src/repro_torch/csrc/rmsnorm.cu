// RMSNorm over the last dimension: out = x * rsqrt(mean(x^2) + eps) * w,
// per row, with float32 sums; x [R, D] float32 or bfloat16, w [D] float32,
// out [R, D] in x's type.
//
// Replaces the Pallas kernel `rmsnorm_kernel` / `rmsnorm_call` of
// src/repro/kernels/rmsnorm.py (pallas_call at :37).  There a grid step
// holds a [block_rows, D] tile in VMEM with the weight resident, and reduces
// each row of the tile at once.  Here one block owns one row: 132 SMs need
// many blocks in flight, and a row (at most 5120 float32 values, 20 KB, at
// the models' widths) is the natural unit of independent work.
//
// What bounds it on this card: bytes.  A call must read x and w once and
// write out once (2 x 4 x R x D bytes in float32) and does ~4 operations
// per element, far below the ~20 operations per byte where the card's
// float32 rate would be the limit.  So the design is about streaming each
// row through once, from many SMs at a time:
//  * pass 1: each thread accumulates the squares of a strided slice of the
//    row in float32 (16-byte loads where the row and D allow them,
//    neighbouring threads on neighbouring addresses), the warp reduces with
//    shuffles, and the warps' partial sums meet in shared memory;
//  * pass 2: the block scales its row by rsqrt(mean + eps) and w and writes
//    it.  The second read of the row comes from L2 (a block's row was read
//    a moment before), not from device memory.
// Ragged row counts need nothing: the grid has one block per row.  Rows are
// read through their stride (the last dimension contiguous).
//
// The sum of squares is taken in another order than the plain version's
// (`torch.mean(x * x)`), so the two agree to float32 rounding, not bit for
// bit; the rest is the same arithmetic in the same order: (x * r) * w, one
// rounding to the output type (round to nearest even for bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // 8 warps
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// elements of T in one 16-byte load or store
template <typename T>
__host__ __device__ constexpr int vec_n() { return 16 / (int)sizeof(T); }

// Sum of a float over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int i = 0; i < n_warps; ++i) total += scratch[i];  // the same order in every thread
  return total;
}

template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
               int D, long long x_row_stride, long long out_row_stride, float eps) {
  __shared__ float scratch[kMaxWarps];
  const T* xr = x + (long long)blockIdx.x * x_row_stride;
  T* outr = out + (long long)blockIdx.x * out_row_stride;

  float acc = 0.0f;
  if (kVectorized) {
    constexpr int kN = vec_n<T>();
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < D / kN; i += blockDim.x) {
      const uint4 raw = xv[i];
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float f = to_float(v[j]);
        acc = fmaf(f, f, acc);
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float f = to_float(xr[i]);
      acc = fmaf(f, f, acc);
    }
  }
  const float ss = block_sum(acc, scratch);
  const float r = rsqrtf(ss / (float)D + eps);

  if (kVectorized) {
    constexpr int kN = vec_n<T>();
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(outr);
    for (int i = threadIdx.x; i < D / kN; i += blockDim.x) {
      const uint4 raw = xv[i];
      const T* v = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < kN; ++j) store(&o[j], (to_float(v[j]) * r) * w[i * kN + j]);
      ov[i] = res;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      store(&outr[i], (to_float(xr[i]) * r) * w[i]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* w, void* out, int rows, int D, long long x_row_stride,
           long long out_row_stride, float eps, cudaStream_t stream) {
  constexpr int kN = vec_n<T>();
  const bool vectorized =
      D % kN == 0 && x_row_stride % kN == 0 && out_row_stride % kN == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_row = vectorized ? D / kN : D;
  // one warp for short rows, up to 8 for long ones: every thread gets work
  int threads = ((per_row + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vectorized) {
    rmsnorm_kernel<T, true><<<rows, threads, 0, stream>>>(xt, w, ot, D, x_row_stride,
                                                          out_row_stride, eps);
  } else {
    rmsnorm_kernel<T, false><<<rows, threads, 0, stream>>>(xt, w, ot, D, x_row_stride,
                                                           out_row_stride, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, D] (row stride x_row_stride elements, the last dimension
// contiguous), w [D] float32, out [rows, D] (row stride out_row_stride).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_rms_norm(const void* x, const float* w, void* out, int rows, int D,
                              long long x_row_stride, long long out_row_stride, int bf16,
                              float eps, cudaStream_t stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (bf16) {
    return launch<__nv_bfloat16>(x, w, out, rows, D, x_row_stride, out_row_stride, eps,
                                 stream);
  }
  return launch<float>(x, w, out, rows, D, x_row_stride, out_row_stride, eps, stream);
}
