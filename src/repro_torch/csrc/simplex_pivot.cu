// Fused masked simplex pivots over a [B, R, C] float64 tableau stack.
//
// Replaces the Pallas kernel `simplex_pivot_kernel` / `simplex_pivot_call`
// (body `_one_pivot`) of src/repro/kernels/simplex_pivot.py.  Each launch
// runs up to K rounds of: Dantzig pricing over the first `ncols_price`
// columns of the objective row (Bland's first-negative rule once
// `it >= bland_after`), the ratio test over the entering column (ties within
// 1e-12 go to the smallest basis id), and the one-pass rank-1 update
// T -= outer(pcol', prow) with pcol'[row] = piv - 1 and prow = T[row] / piv.
// A lane that is not running, or is out of iteration budget, is left as it
// is; the active mask is evaluated again at the start of every round, so K
// fused rounds equal K single launches bit for bit.
//
// Design: one block per lane (LP); the K rounds loop inside the block.  The
// tableau stays in device memory (15.8 MB per lane at the m=10, 5-load,
// q=5 chain shape; far beyond 227 KB of shared memory) and is updated in
// place.  Pricing and the ratio test are block reductions; the entering
// column, the scaled pivot row and the ratios are staged in shared memory
// before any element of T is written, so the in-place update reads only
// values of the round's starting tableau.  The update is
// fma(-pcol'[r], prow[c], T[r, c]): one rounding, the same value the
// reference's `T - pcol[:, None] * prow[None, :]` gets once XLA contracts
// it into a fused multiply-add.  The library is built with -fmad=false so
// that no other product-sum is contracted behind the source's back.
//
// Bound on this card: the rank-1 update reads and writes every element,
// 2 * R * C * 8 bytes per pivot of an active lane (31.6 MB at the chain
// shape above), and does one fma per 16 bytes, so it is bound by device
// memory bandwidth.  Each thread keeps four independent loads in flight to
// cover memory latency.  Finished lanes cost a block that reads two ints
// and exits; the epoch driver passes only the still-active lanes through
// `lanes`, so they are not even launched.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kEps = 1e-9;
constexpr double kTieTol = 1e-12;
constexpr int kRunning = -1;
constexpr int kOptimal = 0;
constexpr int kUnbounded = 2;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

// jnp.argmin's order: NaN first, then the smaller value, then the smaller
// index.  It is a total order on (value, index) pairs, so any reduction
// tree gives the first index of the minimum.
__device__ __forceinline__ bool precedes(double av, int ai, double bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return (an && bn) ? ai < bi : an;
  if (av != bv) return av < bv;
  return ai < bi;
}

// jnp.min: NaN propagates.
__device__ __forceinline__ double min_nan(double a, double b) {
  if (isnan(a) || isnan(b)) return nan("");
  return a < b ? a : b;
}

struct ArgMin {
  double v;
  int i;
};

__device__ __forceinline__ ArgMin pick(ArgMin a, ArgMin b) {
  return precedes(b.v, b.i, a.v, a.i) ? b : a;
}

__device__ ArgMin block_argmin(ArgMin x, double* sv, int* si) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMin y;
    y.v = __shfl_down_sync(0xffffffffu, x.v, off);
    y.i = __shfl_down_sync(0xffffffffu, x.i, off);
    x = pick(x, y);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sv[warp] = x.v;
    si[warp] = x.i;
  }
  __syncthreads();
  if (warp == 0) {
    x.v = lane < kWarps ? sv[lane] : INFINITY;
    x.i = lane < kWarps ? si[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      ArgMin y;
      y.v = __shfl_down_sync(0xffffffffu, x.v, off);
      y.i = __shfl_down_sync(0xffffffffu, x.i, off);
      x = pick(x, y);
    }
    if (lane == 0) {
      sv[0] = x.v;
      si[0] = x.i;
    }
  }
  __syncthreads();
  ArgMin out{sv[0], si[0]};
  __syncthreads();  // the scratch is reused by the next reduction
  return out;
}

__device__ int block_min_int(int x, int* si) {
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_down_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) si[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? si[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) si[0] = x;
  }
  __syncthreads();
  const int out = si[0];
  __syncthreads();
  return out;
}

__device__ double block_min_nan(double x, double* sv) {
  for (int off = 16; off > 0; off >>= 1) x = min_nan(x, __shfl_down_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sv[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? sv[lane] : INFINITY;
    for (int off = 16; off > 0; off >>= 1) x = min_nan(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) sv[0] = x;
  }
  __syncthreads();
  const double out = sv[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
simplex_pivot_kernel(double* __restrict__ T, int32_t* __restrict__ basis,
                     int32_t* __restrict__ iters, int32_t* __restrict__ status,
                     const int32_t* __restrict__ lanes, int R, int C,
                     int ncols_price, int bland_after, int max_iter, int k_pivots) {
  extern __shared__ double smem[];
  double* pcol = smem;          // [R]   entering column, then pcol'
  double* ratio = smem + R;     // [R-1] ratio test
  double* prow = smem + 2 * R;  // [C]   pivot row / piv
  __shared__ double red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int lane_id = lanes ? lanes[blockIdx.x] : blockIdx.x;
  double* Tb = T + (size_t)lane_id * R * C;
  int32_t* bb = basis + (size_t)lane_id * (R - 1);
  const int m_rows = R - 1;
  const int tid = threadIdx.x;
  int it = iters[lane_id];
  int st = status[lane_id];

  for (int k = 0; k < k_pivots; ++k) {
    if (!(st == kRunning && it < max_iter)) break;  // uniform over the block

    // ---- pricing: Dantzig, Bland after the anti-cycling threshold ----
    const double* obj = Tb + (size_t)m_rows * C;
    ArgMin dz{INFINITY, INT32_MAX};
    int first_neg = INT32_MAX;
    for (int c = tid; c < ncols_price; c += kThreads) {
      const double v = obj[c];
      dz = pick(dz, ArgMin{v, c});
      if (v < -kEps) first_neg = min(first_neg, c);
    }
    dz = block_argmin(dz, red_v, red_i);
    first_neg = block_min_int(first_neg, red_i);
    const bool any_neg = first_neg < ncols_price;
    const int col = it < bland_after ? dz.i : first_neg;
    if (!any_neg) {
      st = kOptimal;
      break;
    }

    // ---- ratio test over the entering column ----
    double best = INFINITY;
    for (int r = tid; r < R; r += kThreads) {
      const double cv = Tb[(size_t)r * C + col];
      pcol[r] = cv;
      if (r < m_rows) {
        const double q = cv > kEps ? Tb[(size_t)r * C + (C - 1)] / cv : INFINITY;
        ratio[r] = q;
        best = min_nan(best, q);
      }
    }
    best = block_min_nan(best, red_v);  // its syncs publish pcol and ratio
    if (!isfinite(best)) {
      st = kUnbounded;
      break;
    }
    ArgMin rw{INFINITY, INT32_MAX};
    for (int r = tid; r < m_rows; r += kThreads) {
      // |inf - inf| is NaN, which compares false: never a tie
      const double key = fabs(ratio[r] - best) <= kTieTol ? (double)bb[r] : (double)INT32_MAX;
      rw = pick(rw, ArgMin{key, r});
    }
    const int row = block_argmin(rw, red_v, red_i).i;

    // ---- fused rank-1 update, in place ----
    const double piv = pcol[row];
    for (int c = tid; c < C; c += kThreads) prow[c] = Tb[(size_t)row * C + c] / piv;
    __syncthreads();  // every read of the pivot row precedes the first write
    if (tid == 0) {
      pcol[row] = piv - 1.0;
      bb[row] = col;
    }
    __syncthreads();
    const int total = R * C;
    for (int base = tid; base < total; base += kUnroll * kThreads) {
      double v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = base + u * kThreads;
        if (idx < total) v[u] = Tb[idx];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = base + u * kThreads;
        if (idx < total) {
          const int r = idx / C;
          Tb[idx] = fma(-pcol[r], prow[idx - r * C], v[u]);
        }
      }
    }
    ++it;
    __syncthreads();  // the next round reads the updated tableau and restages
  }
  if (tid == 0) {
    iters[lane_id] = it;
    status[lane_id] = st;
  }
}

}  // namespace

extern "C" int repro_simplex_pivot(double* T, int32_t* basis, int32_t* iters, int32_t* status,
                                   const int32_t* lanes, int n_lanes, int R, int C,
                                   int ncols_price, int bland_after, int max_iter,
                                   int k_pivots, void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(2 * R + C) * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        simplex_pivot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  simplex_pivot_kernel<<<n_lanes, kThreads, smem, (cudaStream_t)stream>>>(
      T, basis, iters, status, lanes, R, C, ncols_price, bland_after, max_iter, k_pivots);
  return (int)cudaGetLastError();
}
