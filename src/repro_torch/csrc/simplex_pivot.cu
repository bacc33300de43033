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
// Design.  A lane (one LP) runs on a thread-block cluster of S blocks of
// 1,024 threads, one block an SM (S = 1, 2, 4, 8 or 16, chosen per launch by
// the wrapper: the largest with lanes x S within the SMs and every cluster
// resident at once, so that the few lanes left at the end of a solve still
// stream on most of the card).  The K rounds loop inside the cluster.  The
// tableau stays in device memory (15.8 MB per lane at the m=10, 5-load, q=5
// chain shape) and is updated in place.  Every block of the cluster prices
// the objective row and runs the ratio test over the whole entering column
// itself: the reductions order (value, index) pairs totally (`precedes`),
// so every block, and any reduction tree, picks the same pivot, and the
// blocks need no shared memory of each other.  Block b owns columns
// [c0, c1) of every row: it stages its slice of the scaled pivot row and
// writes only there.  Two cluster barriers a round (barrier.cluster:
// release/acquire at cluster scope, covering global memory; tableau reads
// go through L2 with ld.cg) order the round: every block's reads of the
// round's tableau come before any block's first write, and every write
// before the next round's reads.  With S = 1 a __syncthreads does both.
//
// Row skipping.  While the entering column is staged for the ratio test,
// the block lists the rows whose pcol' is nonzero (a warp ballot and one
// shared-memory atomic a warp; pcol'[row] = piv - 1, and NaN counts as
// nonzero) and updates only those.  This is exact: for a finite prow[c] and
// p = +-0, fma(-p, prow[c], v) is v when v != 0 and a zero of some sign when
// v is a zero, so only the sign of a zero can differ from the dense update,
// which equality, the ratio test and pricing all ignore, and a zero never
// turns nonzero through it.  A non-finite prow[c] (an inf or NaN in the
// pivot row) would make the dense update write 0 * inf = NaN into every
// row; when a block's slice of the pivot row holds one, that block updates
// every row of its slice in the same round, so the result stays the
// function's.  The list may hold all R rows (the returns + release lanes
// fill it): nothing assumes it is short.  A lane that does not pivot in a
// round is not written at all, where the function's masked update
// multiplies its candidate pivot row by 0: the same bits while that row is
// finite, NaN where it is not (kernels/simplex_pivot.py says more).
//
// Update.  Each listed row's slice is streamed by one warp (or, when fewer
// rows than warps are listed, by up to 32 warps, each a segment), with
// 16-byte loads and stores: C is odd at the §6 shapes, so every other row
// starts 8 bytes off 16 and takes a scalar head, and an odd remainder a
// scalar tail.  Each lane keeps four 16-byte loads in flight (64 KB an SM).
// The update is fma(-pcol'[r], prow[c], T[r, c]): one rounding, the same
// value the reference's `T - pcol[:, None] * prow[None, :]` gets once XLA
// contracts it into a fused multiply-add.  The library is built with
// -fmad=false so that no other product-sum is contracted behind the
// source's back.
//
// Bound on this card: the update reads and writes 16 bytes per element of
// the listed rows, plus the staging reads (objective row, entering and rhs
// columns, pivot row) once per round; one fma per 16 bytes, so bytes bound
// it.  Early in a solve 3-15 rows of ~1,000 change per pivot, a round is
// short, and its time is the chain of dependent steps (three staging loads,
// three block reductions, two barriers, the update).  The lanes that run
// long fill in: on the returns + release lanes ~93% of the rows change, and
// a round streams the tableau; with few lanes left the cluster spreads each
// over up to 16 SMs.  Where the time goes at each stack is in PERF.md.
// `updated` (optional) accumulates the elements each block updated (rows x
// slice width), one atomic a block a launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr double kEps = 1e-9;
constexpr double kTieTol = 1e-12;
constexpr int kRunning = -1;
constexpr int kOptimal = 0;
constexpr int kUnbounded = 2;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;       // 16-byte loads in flight per lane in the update
constexpr int kStage = 4;     // loads in flight per thread while staging
constexpr int kMinSeg = 128;  // fewest elements a warp's segment of a row gets

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

// Dantzig's candidate (v, i) and Bland's first negative column j, reduced
// together.  The identity is (inf, INT32_MAX, INT32_MAX).
struct Cand {
  double v;
  int i;
  int j;
};

__device__ __forceinline__ Cand merge(Cand a, Cand b) {
  Cand o = precedes(b.v, b.i, a.v, a.i) ? b : a;
  o.j = min(a.j, b.j);
  return o;
}

__device__ __forceinline__ Cand warp_merge(Cand x) {
  for (int off = 16; off > 0; off >>= 1) {
    Cand y;
    y.v = __shfl_xor_sync(0xffffffffu, x.v, off);
    y.i = __shfl_xor_sync(0xffffffffu, x.i, off);
    y.j = __shfl_xor_sync(0xffffffffu, x.j, off);
    x = merge(x, y);
  }
  return x;
}

// Per-warp partials, double-buffered: a reduction writes one buffer, meets
// one __syncthreads, and every warp then reduces the partials itself, so a
// reduction costs one barrier.  The buffer a reduction reads is written
// again two reductions later, after every thread has passed the barrier of
// the reduction in between.
struct Scratch {
  double v[2][kWarps];
  int i[2][kWarps];
  int j[2][kWarps];
};

// The block's reduction of `x` under merge (min, argmin and Bland's column
// are all cases of it); every thread gets the result.
__device__ __forceinline__ Cand block_merge(Cand x, Scratch& s, int& buf) {
  x = warp_merge(x);
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  if (ln == 0) {
    s.v[buf][warp] = x.v;
    s.i[buf][warp] = x.i;
    s.j[buf][warp] = x.j;
  }
  __syncthreads();
  Cand y{INFINITY, INT32_MAX, INT32_MAX};
  if (ln < kWarps) {
    y.v = s.v[buf][ln];
    y.i = s.i[buf][ln];
    y.j = s.j[buf][ln];
  }
  buf ^= 1;
  return warp_merge(y);
}

__device__ __forceinline__ double block_min_nan(double x, Scratch& s, int& buf) {
  for (int off = 16; off > 0; off >>= 1) x = min_nan(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  if (ln == 0) s.v[buf][warp] = x;
  __syncthreads();
  double y = ln < kWarps ? s.v[buf][ln] : INFINITY;
  buf ^= 1;
  for (int off = 16; off > 0; off >>= 1) y = min_nan(y, __shfl_xor_sync(0xffffffffu, y, off));
  return y;
}

// One warp updates elements [cs, ce) of a row: rp[c] = fma(np, pr[c - c0], rp[c]).
// 16-byte loads and stores where the row's address allows, a scalar head
// (lane 0) and tail (lane 31) around them, all loads of a batch issued
// before any store.
__device__ __forceinline__ void update_span(double* __restrict__ rp, double np,
                                            const double* __restrict__ pr, int c0, int cs, int ce,
                                            int ln) {
  if (cs >= ce) return;
  const bool has_head = (reinterpret_cast<uintptr_t>(rp + cs) & 15) != 0;
  const int a = cs + (has_head ? 1 : 0);
  const int npairs = ce > a ? (ce - a) >> 1 : 0;
  const bool has_tail = ce > a && ((ce - a) & 1);
  double head = 0.0, tail = 0.0;
  if (has_head && ln == 0) head = __ldcg(rp + cs);
  if (has_tail && ln == 31) tail = __ldcg(rp + ce - 1);
  double2* v = reinterpret_cast<double2*>(rp + a);
  const double* pa = pr + (a - c0);
  for (int j0 = 0; j0 < npairs; j0 += 32 * kVec) {
    double2 x[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int j = j0 + u * 32 + ln;
      if (j < npairs) x[u] = __ldcg(v + j);
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int j = j0 + u * 32 + ln;
      if (j < npairs) {
        x[u].x = fma(np, pa[2 * j], x[u].x);
        x[u].y = fma(np, pa[2 * j + 1], x[u].y);
        v[j] = x[u];
      }
    }
  }
  if (has_head && ln == 0) rp[cs] = fma(np, pr[cs - c0], head);
  if (has_tail && ln == 31) rp[ce - 1] = fma(np, pr[ce - 1 - c0], tail);
}

__global__ void __launch_bounds__(kThreads, 1)
simplex_pivot_kernel(double* __restrict__ T, int32_t* __restrict__ basis,
                     int32_t* __restrict__ iters, int32_t* __restrict__ status,
                     const int32_t* __restrict__ lanes, int n_total, int R, int C,
                     int ncols_price, int bland_after, int max_iter, int k_pivots, int csize,
                     int slice, unsigned long long* __restrict__ updated) {
  extern __shared__ __align__(16) double smem[];
  double* pcol = smem;          // [R]      the entering column
  double* aux = smem + R;       // [R]      ratios, then the listed rows' pcol'
  double* prow = smem + 2 * R;  // [slice]  this block's slice of the pivot row / piv
  int* listed = reinterpret_cast<int*>(prow + slice);  // [R] the rows to update
  __shared__ Scratch red;
  __shared__ int n_listed;

  const int rank = blockIdx.x % csize;  // 1-D clusters tile the grid in order
  const int lane_id = lanes ? lanes[blockIdx.x / csize] : blockIdx.x / csize;
  if (lane_id < 0 || lane_id >= n_total) return;  // uniform over the cluster
  double* Tb = T + (size_t)lane_id * R * C;
  int32_t* bb = basis + (size_t)lane_id * (R - 1);
  const int m_rows = R - 1;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int c0 = min(C, rank * slice), c1 = min(C, c0 + slice);
  int it = iters[lane_id];
  int st = status[lane_id];
  int buf = 0;
  unsigned long long done = 0;

  for (int k = 0; k < k_pivots; ++k) {
    if (!(st == kRunning && it < max_iter)) break;  // uniform over the cluster
    if (tid == 0) n_listed = 0;  // published by the pricing reduction's barrier

    // ---- pricing: Dantzig, Bland after the anti-cycling threshold ----
    const double* obj = Tb + (size_t)m_rows * C;
    Cand cand{INFINITY, INT32_MAX, INT32_MAX};
    for (int base = 0; base < ncols_price; base += kStage * kThreads) {
      double v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int c = base + u * kThreads + tid;
        v[u] = c < ncols_price ? __ldcg(obj + c) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int c = base + u * kThreads + tid;
        if (c < ncols_price) cand = merge(cand, Cand{v[u], c, v[u] < -kEps ? c : INT32_MAX});
      }
    }
    cand = block_merge(cand, red, buf);
    if (cand.j >= ncols_price) {  // no negative reduced cost
      st = kOptimal;
      break;
    }
    const int col = it < bland_after ? cand.i : cand.j;

    // ---- ratio test over the entering column ----
    double best = INFINITY;
    for (int base = 0; base < R; base += kStage * kThreads) {
      double cv[kStage], rh[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int r = base + u * kThreads + tid;
        cv[u] = r < R ? __ldcg(Tb + (size_t)r * C + col) : 0.0;
        rh[u] = r < m_rows ? __ldcg(Tb + (size_t)r * C + (C - 1)) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int r = base + u * kThreads + tid;
        if (r < R) pcol[r] = cv[u];
        if (r < m_rows) {
          const double q = cv[u] > kEps ? rh[u] / cv[u] : INFINITY;
          aux[r] = q;
          best = min_nan(best, q);
        }
      }
    }
    best = block_min_nan(best, red, buf);  // its barrier publishes pcol and aux
    if (!isfinite(best)) {
      st = kUnbounded;
      break;
    }
    Cand rw{INFINITY, INT32_MAX, INT32_MAX};
    for (int r = tid; r < m_rows; r += kThreads) {
      // |inf - inf| is NaN, which compares false: never a tie
      const double key =
          fabs(aux[r] - best) <= kTieTol ? (double)__ldcg(bb + r) : (double)INT32_MAX;
      rw = merge(rw, Cand{key, r, INT32_MAX});
    }
    const int row = block_merge(rw, red, buf).i;  // every read of aux precedes its barrier
    const double piv = pcol[row];

    // ---- the rows the update changes: pcol' != 0 ----
    for (int base = 0; base < R; base += kThreads) {
      const int r = base + tid;
      const double p = r < R ? (r == row ? piv - 1.0 : pcol[r]) : 0.0;
      const bool take = p != 0.0;  // NaN counts as nonzero
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      int at = 0;
      if (ln == 0 && mask) at = atomicAdd(&n_listed, __popc(mask));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (take) {
        const int pos = at + __popc(mask & ((1u << ln) - 1u));
        listed[pos] = r;
        aux[pos] = p;
      }
    }

    // ---- this block's slice of the scaled pivot row ----
    const double* prw = Tb + (size_t)row * C;
    bool bad = false;
    for (int base = c0; base < c1; base += kStage * kThreads) {
      double v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int c = base + u * kThreads + tid;
        v[u] = c < c1 ? __ldcg(prw + c) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int c = base + u * kThreads + tid;
        if (c < c1) {
          const double x = v[u] / piv;
          prow[c - c0] = x;
          bad |= !isfinite(x);
        }
      }
    }
    // publishes the list and prow; a non-finite prow in this slice means
    // the dense update writes NaN into rows whose pcol' is 0: update them all
    const bool dense = __syncthreads_or(bad);
    const int n_rows = dense ? R : n_listed;
    if (csize > 1) cg::this_cluster().sync();  // every read of the round precedes any write

    // ---- the update, in place, of the listed rows' slices ----
    if (rank == 0 && tid == 0) bb[row] = col;
    const int width = c1 - c0;
    int G = 1;  // warps a row, while rows are fewer than warps
    while (G < kWarps && n_rows * G < kWarps && width >= 2 * kMinSeg * G) G <<= 1;
    const int seg = ((width + G - 1) / G + 1) & ~1;
    for (int item = warp; item < n_rows * G; item += kWarps) {
      const int i = item / G, g = item % G;
      int r;
      double p;
      if (dense) {
        r = i;
        p = r == row ? piv - 1.0 : pcol[r];
      } else {
        r = listed[i];
        p = aux[i];
      }
      const int cs = min(c1, c0 + g * seg), ce = min(c1, cs + seg);
      update_span(Tb + (size_t)r * C, -p, prow, c0, cs, ce, ln);
    }
    done += (unsigned long long)n_rows * width;
    ++it;
    // the next round reads the updated tableau and restages
    if (csize > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
  if (rank == 0 && tid == 0) {
    iters[lane_id] = it;
    status[lane_id] = st;
  }
  if (updated && tid == 0 && done) atomicAdd(updated, done);
}

// The launch configuration of `n_lanes` lanes on clusters of `cluster`
// blocks (the kernel's attributes raised as it needs, once per device), or
// an error code.
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int n_lanes, int R,
                      int C, int cluster, int* slice) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16)
    return cudaErrorInvalidValue;
  *slice = ((C + cluster - 1) / cluster + 1) & ~1;
  const size_t smem = (size_t)(2 * R + *slice) * sizeof(double) + (size_t)R * sizeof(int);
  static int smem_set[repro::kMaxDevices] = {};
  cudaError_t e = repro::ensure_smem(simplex_pivot_kernel, (int)smem, smem_set);
  if (e != cudaSuccess) return e;
  static bool wide[repro::kMaxDevices] = {};
  if (cluster > 8 && (e = repro::allow_wide_clusters(simplex_pivot_kernel, wide)) != cudaSuccess)
    return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)n_lanes * cluster, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" int repro_simplex_pivot(double* T, int32_t* basis, int32_t* iters, int32_t* status,
                                   const int32_t* lanes, int n_lanes, int n_total, int R, int C,
                                   int ncols_price, int bland_after, int max_iter, int k_pivots,
                                   int cluster, unsigned long long* updated, void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int slice = 0;
  cudaError_t e = configure(&cfg, attr, n_lanes, R, C, cluster, &slice);
  if (e != cudaSuccess) return (int)e;
  cfg.stream = (cudaStream_t)stream;
  e = cudaLaunchKernelEx(&cfg, simplex_pivot_kernel, T, basis, iters, status, lanes, n_total, R,
                         C, ncols_price, bland_after, max_iter, k_pivots, cluster, slice, updated);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks the card holds at once for an R x C
// tableau (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int repro_simplex_pivot_max_clusters(int R, int C, int cluster, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int slice = 0;
  const cudaError_t e = configure(&cfg, attr, 1, R, C, cluster, &slice);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(out, simplex_pivot_kernel, &cfg);
}
