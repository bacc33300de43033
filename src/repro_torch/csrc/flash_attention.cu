// Prefill attention: causal or sliding-window masked softmax(q k^T / sqrt(D)) v
// with grouped-query heads, by an online softmax over kv tiles.
//
// Replaces the Pallas kernel `flash_attention_kernel` / `flash_attention_call`
// of src/repro/kernels/flash_attention.py (pallas_call at :106).  On the TPU
// the kv axis is a sequential grid dimension that carries the running max,
// denominator and accumulator in VMEM scratch from one grid step to the next.
// Here blocks run in parallel and in no order, so the kv loop lives inside
// the block and the running state lives in registers.
//
// Layout: q and out are [B, Sq, H, D], k and v [B, Sk, KVH, D], read through
// their strides (the last dimension contiguous), so the model's projections
// need no transposes.  Query head h reads kv head h / (H / KVH).  float32 or
// bfloat16 in, float32 everywhere inside, out in the input type.
//
// Semantics kept from the reference kernel: masked scores are the finite
// -1e30 (so a row whose first visited tile holds no visible key is wiped by
// alpha = exp(-1e30 - m) once one arrives), and the final division is by
// max(l, 1e-30).  Keys past Sk (the ragged last tile) are not part of the
// function at all: their probability is exactly 0.  Neither Sq nor Sk has
// to divide the tile size.
//
// What bounds it on this card: at the slice's shape (B = 4, S = 512, H = 24,
// D = 128, causal) the function needs 2 * 2 * B * H * D * (S(S+1)/2) = 6.5
// GFLOP and moves 67 MB; in float32, on the CUDA cores (67 TFLOP/s), that is
// ~0.1 ms of operations against ~0.02 ms of bytes, so it is bound by
// operations (in bfloat16 with tensor cores it would be bound by bytes).
// This first version runs both products on the CUDA cores in float32:
//  * one block of 128 threads per (b, h, 64-row q tile); heavy causal tiles
//    (the last q tiles) are launched first;
//  * kv tiles that are fully masked (above the causal diagonal, before the
//    window) are never visited, which halves the causal work;
//  * each thread owns an 8 x 4 patch of the 64 x 64 score tile and 8 rows x
//    D/16 columns of the accumulator in registers; q, the current K (then V)
//    tile and the probabilities are staged in shared memory, padded so the
//    inner loops are free of bank conflicts (83 KB at D = 128: two blocks
//    per SM);
//  * every product-sum is an explicit fmaf (the library is built with
//    -fmad=false).
// wgmma, TMA and a pipelined K/V ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 128;  // 8 row groups x 16 lanes
constexpr int kRows = 8;       // query rows per thread: kBQ / (kThreads / 16)
constexpr int kCols = 4;       // keys per thread in a score tile: kBK / 16
constexpr int kPStride = kBK + 2;  // 8 * 66 = 16 (mod 32): the two half-warps
                                   // of a warp fall on disjoint banks
constexpr float kNegInf = -1e30f;

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

template <int D>
constexpr int smem_floats() {
  // q tile [kBQ][D+2], K or V tile [kBK][D+1], probabilities [kBQ][kPStride]
  return kBQ * (D + 2) + kBK * (D + 1) + kBQ * kPStride;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int H, int KVH, int Sq, int Sk,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long osb, long long oss, long long osh,
                       int causal, int window, float scale) {
  constexpr int kQS = D + 2;   // q row stride: 8 * (D + 2) = 16 (mod 32)
  constexpr int kKS = D + 1;   // K row stride: lanes on consecutive keys hit
                               // distinct banks
  constexpr int kDC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* kv = qs + kBQ * kQS;
  float* ps = kv + kBK * kKS;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBQ;
  const int q_end = min(q0 + kBQ, Sq);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int r0 = ty * kRows;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * ksb + kvh * ksh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    qs[r * kQS + d] = qi < Sq ? to_f32(qb[qi * qss + d]) : 0.f;
  }

  // the keys some row of this tile can see
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q_end);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    const int nk = min(kBK, Sk - k0);  // keys of this tile inside [0, Sk)
    __syncthreads();                   // the previous tile's V is consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      kv[c * kKS + d] = c < nk ? to_f32(kb[(k0 + c) * kss + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(r0 + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kk[j] = kv[(tx + 16 * j) * kKS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        bool ok = true;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        s[i][j] = c >= nk ? -INFINITY : (ok ? s[i][j] * scale : kNegInf);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(r0 + i) * kPStride + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();  // K consumed, probabilities written
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      kv[c * kKS + d] = c < nk ? to_f32(vb[(k0 + c) * kss + d]) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < nk; ++c) {
      float pv[kRows], vv[kDC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(r0 + i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) vv[j] = kv[c * kKS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + b * osb + qi * oss + h * osh;
#pragma unroll
    for (int j = 0; j < kDC; ++j) from_f32(orow + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int KVH, int Sq, int Sk, const long long* st, int causal, int window,
                   float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  static int smem_set[kMaxDevices] = {};
  cudaError_t err = ensure_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KVH, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* o, int B,
                     int H, int KVH, int Sq, int Sk, const long long* st, int causal,
                     int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KVH, Sq, Sk, st, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KVH, Sq, Sk, st, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KVH, Sq, Sk, st, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KVH, Sq, Sk, st, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o [B, Sq, H, D], k/v [B, Sk, KVH, D]; strides in elements, last dim 1;
// k and v share their strides.  bf16 != 0: bfloat16 tensors, else float32.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int H, int KVH, int Sq, int Sk, int D, int bf16,
                                     long long qsb, long long qss, long long qsh,
                                     long long ksb, long long kss, long long ksh,
                                     long long osb, long long oss, long long osh,
                                     int causal, int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, B, H, KVH, Sq, Sk, st,
                                                   causal, window, scale, s)
                         : dispatch<float>(D, q, k, v, o, B, H, KVH, Sq, Sk, st, causal,
                                           window, scale, s);
  return (int)err;
}
