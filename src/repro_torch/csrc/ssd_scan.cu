// Mamba-2 SSD chunked scan: per (b, h), with a [P, N] state s,
//   s_t = exp(dt_t A_h) s_{t-1} + (dt_t x_t) B_t^T,   y_t = s_t C_t + D_h x_t,
// evaluated in the chunked dual form: quadratic within a chunk of L steps,
// and the state carried from one chunk to the next.
//
// Replaces the Pallas kernel `ssd_scan_kernel` / `ssd_scan_call` of
// src/repro/kernels/ssd_scan.py (pallas_call at :90).  There the chunks are
// the innermost, sequential grid axis, the state lives in VMEM scratch
// across grid steps, and each step holds one [L, L] score tile.  Here blocks
// run in parallel and in no order, so one block per (b, h) loops over the
// chunks itself and keeps the state in shared memory.  At L = 256 the
// [L, L] score tile alone would be 256 KB, more than a block's 227 KB, so
// the chunk is cut into 64 x 64 sub-tiles and the tiles above the diagonal
// are never computed.
//
// Per chunk (rows l, columns s of the chunk; xbar = x * dt):
//   cum_l   = sum_{k <= l} dt_k A                (float64, see below)
//   y_l     = exp(cum_l) (C_l . s)                            carried state
//           + sum_{s <= l} (C_l . B_s) exp(cum_l - cum_s) xbar_s  intra-chunk
//           + D x_l
//   s'      = s exp(cum_{L-1}) + sum_l exp(cum_{L-1} - cum_l) xbar_l B_l^T
// The carried term is skipped in the first chunk (the state entering it is
// zero) and the update after the last chunk (nothing reads it), as in
// `ssd_scan_plain`, which defines the function.
//
// The cumulative log-decay is summed in float64, and every decay factor
// (exp of cum_l - cum_s, cum_l, cum_{L-1} - cum_l, cum_{L-1}) is evaluated in
// float64 and rounded once to float32.  At the model's widths cum reaches
// about -3,400 within a chunk, where a float32 ulp is 2.4e-4: a float32
// cumsum would put errors of that size into the exponents, and two float32
// sums in different orders (a sequential one and a parallel scan) differ by
// up to 2e-3.  In float64 the order of the sum changes a factor by ~1e-13,
// which shows in float32 only where it straddles a rounding boundary (one
// ulp), so this kernel and the plain version (torch.cumsum and torch.exp in
// float64) take the same factors to within one rounding.  The float64 work is
// O(L^2 / 2) exps per chunk, small beside the O(L^2 (N + P)) products.
//
// Layout: x [B, S, H, P], B and C [B, S, G, N] (head h reads group
// h / (H / G); B and C are never repeated across heads), dt [B, S, H]
// float32, all read through their strides (the last dimension of x, B and C
// contiguous), so the model's slices of one conv output need no copies.
// A and D [H] float32.  x, B, C float32 or bfloat16; float32 inside; y
// [B, S, H, P] in x's type.
//
// What bounds it on this card: operations.  At mamba2-2.7b's prefill
// (B = 4, S = 512, H = 80, P = 64, G = 1, N = 128, L = 256) the products over
// the visible pairs and the state are ~11 GFLOP per call, 0.16 ms at the
// float32 rate outside the tensor cores (67 TFLOP/s), against 87 MB of inputs
// and outputs (0.026 ms at 3.35 TB/s).  This first version keeps to float32
// FMAs on the CUDA cores (every product-sum an explicit fmaf; the library is
// built with -fmad=false):
//  * one block of 256 threads per (b, h);
//  * the state, one 64-row tile of C, one 64-row tile of B and of xbar, and
//    the decayed 64 x 64 score tile in shared memory, padded so the inner
//    loops are free of bank conflicts (about 140 KB at P = 64, N = 128: one
//    block per SM);
//  * each thread holds a 4 x 4 patch of a score tile, 4 rows x P/16 columns
//    of the output tile, and (P N / 256) state entries in registers.
// Tensor cores (wgmma on bf16 or tf32 tiles), several blocks per (b, h) and
// a pipelined tile ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows (and columns) of a sub-tile of a chunk
constexpr int kThreads = 256;   // 16 row groups x 16 lanes
constexpr int kScanLanes = 32;  // threads of the float64 cumsum
constexpr int kPS = kT + 4;     // score tile row stride: 4 * 68 = 16 (mod 32)
constexpr int kMaxSmem = 232448;

// cudaFuncSetAttribute is a driver call on every launch unless it is
// remembered: each launch<T, P, N> instance keeps, per device, the largest
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

template <int P, int N>
struct Smem {
  static constexpr int kCS = N + 4;  // C tile row stride: 4 * (N + 4) = 16 (mod 32)
  static constexpr int kBS = N + 1;  // B tile row stride: lanes on consecutive rows
                                     // hit distinct banks
  static constexpr int kXS = P;      // xbar tile row stride (read along p)
  static constexpr int kSS = N + 1;  // state row stride (read along p by lane)
  static constexpr int kFloats = kT * kCS + kT * kBS + kT * kXS + kT * kPS + P * kSS;
  // float64 cum [L] and scan partials first (8-byte aligned), then dt [L]
  // and the float tiles
  static int bytes(int L) {
    return 8 * (L + kScanLanes) + 4 * (L + kFloats);
  }
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv, T* __restrict__ y,
                int H, int G, int S, int L,
                long long xsb, long long xss, long long xsh,
                long long dsb, long long dss, long long dsh,
                long long bsb, long long bss, long long bsg,
                long long csb, long long css, long long csg,
                long long ysb, long long yss, long long ysh) {
  using SM = Smem<P, N>;
  constexpr int kPC = P / 16;  // output columns per thread
  // state update: a kTP x kTN thread grid over [P, N]
  constexpr int kTN = N < 32 ? N : 32;
  constexpr int kTP = kThreads / kTN;
  constexpr int kRP = P / kTP;
  constexpr int kRN = N / kTN;
  static_assert(kRP >= 1 && kRP * kTP == P, "P must be a multiple of the thread rows");

  extern __shared__ double smem_d[];
  double* cum = smem_d;            // [L]
  double* part = cum + L;          // [kScanLanes]
  float* dts = reinterpret_cast<float*>(part + kScanLanes);  // [L]
  float* cs = dts + L;             // C tile [kT][kCS]
  float* bs = cs + kT * SM::kCS;   // B tile [kT][kBS]
  float* xs = bs + kT * SM::kBS;   // xbar tile [kT][kXS]
  float* ps = xs + kT * SM::kXS;   // decayed scores [kT][kPS]
  float* st = ps + kT * kPS;       // state [P][kSS]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float a = A[h];
  const float dcoef = Dv[h];
  const T* xb = x + b * xsb + h * xsh;
  const float* db = dt + b * dsb + h * dsh;
  const T* bb = Bm + b * bsb + g * bsg;
  const T* cb = Cm + b * csb + g * csg;
  T* yb = y + b * ysb + h * ysh;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: rows ty * 4 .. ty * 4 + 3 of a tile
  const int tx = tid & 15;  // lane: columns tx + 16 j
  const int tp = tid / kTN;
  const int tn = tid % kTN;

  for (int i = tid; i < P * SM::kSS; i += kThreads) st[i] = 0.f;

  const int nc = S / L;
  const int ntiles = (L + kT - 1) / kT;
  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * L;
    __syncthreads();  // the previous chunk's state update and readers are done
    for (int l = tid; l < L; l += kThreads) dts[l] = db[(t0 + l) * dss];
    __syncthreads();

    // cum in float64: 32 threads sum contiguous runs, one thread scans the
    // runs' totals, then each run adds its offset
    const int per = (L + kScanLanes - 1) / kScanLanes;
    if (tid < kScanLanes) {
      const int lo = tid * per, hi = min(L, lo + per);
      double run = 0.0;
      for (int l = lo; l < hi; ++l) {
        run += (double)(dts[l] * a);
        cum[l] = run;
      }
      part[tid] = run;
    }
    __syncthreads();
    if (tid == 0) {
      double run = 0.0;
      for (int i = 0; i < kScanLanes; ++i) {
        const double v = part[i];
        part[i] = run;
        run += v;
      }
    }
    __syncthreads();
    if (tid < kScanLanes) {
      const int lo = tid * per, hi = min(L, lo + per);
      const double off = part[tid];
      for (int l = lo; l < hi; ++l) cum[l] += off;
    }
    __syncthreads();
    const double total = cum[L - 1];

    for (int rt = 0; rt < ntiles; ++rt) {
      const int r0 = rt * kT;
      const int nr = min(kT, L - r0);
      for (int idx = tid; idx < kT * N; idx += kThreads) {
        const int r = idx / N, n = idx - r * N;
        cs[r * SM::kCS + n] = r < nr ? to_f32(cb[(t0 + r0 + r) * css + n]) : 0.f;
      }
      __syncthreads();

      float acc[4][kPC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kPC; ++j) acc[i][j] = 0.f;

      if (c > 0) {  // the carried state through C, decayed from the chunk's start
        float dot[4][kPC];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kPC; ++j) dot[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], sv[kPC];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(ty * 4 + i) * SM::kCS + n];
#pragma unroll
          for (int j = 0; j < kPC; ++j) sv[j] = st[(tx + 16 * j) * SM::kSS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < kPC; ++j) dot[i][j] = fmaf(cv[i], sv[j], dot[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          const float e = r < nr ? (float)exp(cum[r0 + r]) : 0.f;
#pragma unroll
          for (int j = 0; j < kPC; ++j) acc[i][j] = e * dot[i][j];
        }
      }

      for (int ct = 0; ct <= rt; ++ct) {  // column tiles on or below the diagonal
        const int s0 = ct * kT;
        const int ns = min(kT, L - s0);
        __syncthreads();  // the previous tile's B, xbar and scores are consumed
        for (int idx = tid; idx < kT * N; idx += kThreads) {
          const int r = idx / N, n = idx - r * N;
          bs[r * SM::kBS + n] = r < ns ? to_f32(bb[(t0 + s0 + r) * bss + n]) : 0.f;
        }
        for (int idx = tid; idx < kT * P; idx += kThreads) {
          const int r = idx / P, p = idx - r * P;
          xs[r * SM::kXS + p] = r < ns ? to_f32(xb[(t0 + s0 + r) * xss + p]) * dts[s0 + r] : 0.f;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(ty * 4 + i) * SM::kCS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * SM::kBS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          const int l = r0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = tx + 16 * j;
            const int sl = s0 + s;
            float v = 0.f;
            if (r < nr && s < ns && sl <= l) v = sc[i][j] * (float)exp(cum[l] - cum[sl]);
            ps[r * kPS + s] = v;
          }
        }
        __syncthreads();

        for (int s = 0; s < ns; ++s) {
          float pv[4], xv[kPC];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kPS + s];
#pragma unroll
          for (int j = 0; j < kPC; ++j) xv[j] = xs[s * SM::kXS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < kPC; ++j) acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= nr) continue;
        const long long l = t0 + r0 + r;
#pragma unroll
        for (int j = 0; j < kPC; ++j) {
          const int p = tx + 16 * j;
          const float xv = to_f32(xb[l * xss + p]);
          from_f32(yb + l * yss + p, acc[i][j] + xv * dcoef);
        }
      }
    }

    if (c == nc - 1) break;  // nothing reads the state after the last chunk

    // s' = s exp(total) + sum_l exp(total - cum_l) xbar_l B_l^T
    float sacc[kRP][kRN];
#pragma unroll
    for (int i = 0; i < kRP; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) sacc[i][j] = 0.f;
    for (int ct = 0; ct < ntiles; ++ct) {
      const int s0 = ct * kT;
      const int ns = min(kT, L - s0);
      __syncthreads();  // the previous readers of the B and xbar tiles are done
      for (int idx = tid; idx < kT * N; idx += kThreads) {
        const int r = idx / N, n = idx - r * N;
        bs[r * SM::kBS + n] = r < ns ? to_f32(bb[(t0 + s0 + r) * bss + n]) : 0.f;
      }
      for (int idx = tid; idx < kT * P; idx += kThreads) {
        const int r = idx / P, p = idx - r * P;
        float v = 0.f;
        if (r < ns) {
          const float w = (float)exp(total - cum[s0 + r]);
          v = (to_f32(xb[(t0 + s0 + r) * xss + p]) * dts[s0 + r]) * w;
        }
        xs[r * SM::kXS + p] = v;
      }
      __syncthreads();
      for (int r = 0; r < ns; ++r) {
        float xv[kRP], bv[kRN];
#pragma unroll
        for (int i = 0; i < kRP; ++i) xv[i] = xs[r * SM::kXS + tp + kTP * i];
#pragma unroll
        for (int j = 0; j < kRN; ++j) bv[j] = bs[r * SM::kBS + tn + kTN * j];
#pragma unroll
        for (int i = 0; i < kRP; ++i)
#pragma unroll
          for (int j = 0; j < kRN; ++j) sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
      }
    }
    const float et = (float)exp(total);
    // every reader of the old state (the carried term of each row tile) has
    // passed at least one barrier since; each thread rewrites its own entries
#pragma unroll
    for (int i = 0; i < kRP; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        float* e = st + (tp + kTP * i) * SM::kSS + tn + kTN * j;
        *e = *e * et + sacc[i][j];
      }
  }
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* Dv, void* y, int B, int S, int H, int G, int L,
                   const long long* st, cudaStream_t stream) {
  const int smem = Smem<P, N>::bytes(L);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<T, P, N>;
  static int smem_set[kMaxDevices] = {};
  cudaError_t err = ensure_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      Dv, static_cast<T*>(y), H, G, S, L, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(int N, const void* x, const float* dt, const float* A, const void* Bm,
                       const void* Cm, const float* Dv, void* y, int B, int S, int H, int G,
                       int L, const long long* st, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, A, Bm, Cm, Dv, y, B, S, H, G, L, st, s);
    case 32: return launch<T, P, 32>(x, dt, A, Bm, Cm, Dv, y, B, S, H, G, L, st, s);
    case 64: return launch<T, P, 64>(x, dt, A, Bm, Cm, Dv, y, B, S, H, G, L, st, s);
    case 128: return launch<T, P, 128>(x, dt, A, Bm, Cm, Dv, y, B, S, H, G, L, st, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int P, int N, const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* Dv, void* y, int B, int S,
                     int H, int G, int L, const long long* st, cudaStream_t s) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(N, x, dt, A, Bm, Cm, Dv, y, B, S, H, G, L, st, s);
    case 32: return dispatch_n<T, 32>(N, x, dt, A, Bm, Cm, Dv, y, B, S, H, G, L, st, s);
    case 64: return dispatch_n<T, 64>(N, x, dt, A, Bm, Cm, Dv, y, B, S, H, G, L, st, s);
    case 128: return dispatch_n<T, 128>(N, x, dt, A, Bm, Cm, Dv, y, B, S, H, G, L, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, S, H, P], dt [B, S, H] float32, A and D [H] float32 (contiguous),
// B and C [B, S, G, N], y [B, S, H, P]; strides in elements, the last
// dimension of x, B, C and y contiguous.  bf16 != 0: x, B, C and y bfloat16,
// else float32.  L divides S; G divides H.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* Dv, void* y,
                              int B, int S, int H, int G, int P, int N, int L, int bf16,
                              long long xsb, long long xss, long long xsh,
                              long long dsb, long long dss, long long dsh,
                              long long bsb, long long bss, long long bsg,
                              long long csb, long long css, long long csg,
                              long long ysb, long long yss, long long ysh, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || L < 1 || S % L != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const long long st[15] = {xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg,
                            csb, css, csg, ysb, yss, ysh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(Dv);
  cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(P, N, x, dtf, Af, Bm, Cm, Df, y, B, S, H,
                                                   G, L, st, s)
                         : dispatch<float>(P, N, x, dtf, Af, Bm, Cm, Df, y, B, S, H, G, L,
                                           st, s);
  return (int)err;
}
