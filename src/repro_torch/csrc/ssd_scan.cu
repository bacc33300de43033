// Mamba-2 SSD chunked scan: per (b, h), with a [P, N] state s,
//   s_t = exp(dt_t A_h) s_{t-1} + (dt_t x_t) B_t^T,   y_t = s_t C_t + D_h x_t,
// evaluated in the chunked dual form: quadratic within a chunk of L steps,
// and the state carried from one chunk to the next.
//
// Replaces the Pallas kernel `ssd_scan_kernel` / `ssd_scan_call` of
// src/repro/kernels/ssd_scan.py (pallas_call at :90).  There the chunks are
// the innermost, sequential grid axis and the state lives in VMEM scratch
// across grid steps.  Here blocks run in parallel and in no order, so the
// work is cut where it does not depend on the carried state, as in the
// Mamba-2 paper's chunk_state / state_passing / chunk_scan split.  Per chunk
// (rows l, columns s of the chunk; xbar = x * dt; cum_l = sum_{k <= l} dt_k A):
//   scores  = C B^T                                      per (b, chunk, group)
//   contrib = sum_l exp(cum_{L-1} - cum_l) xbar_l B_l^T     per (b, chunk, head)
//   s_c     = s_{c-1} exp(cum_{L-1} of chunk c-1) + contrib_{c-1}   (sequential)
//   y_l     = exp(cum_l) (C_l . s_c)                             carried state
//           + sum_{s <= l} scores_ls exp(cum_l - cum_s) xbar_s     intra-chunk
//           + D x_l
// The carried term is skipped in the first chunk (the state entering it is
// zero) and no contribution is formed for the last chunk (nothing reads
// it), as in `ssd_scan_plain`, which defines the function.  One wrapper call
// enqueues three kernels (after `ssd_chunk_cumsum_kernel` where the chunk is
// longer than kSmemChunk, below):
//  1. `ssd_chunk_state_kernel`: one block per (b, chunk, head, half of N)
//     for each chunk's own state contribution, and one per (b, chunk,
//     group, 64 x 64 tile on or below the diagonal) for C B^T, computed once
//     for all the heads of the group and written to the workspace;
//  2. `ssd_state_pass_kernel`: the [P, N] recurrence across chunks, one
//     thread per state element (only with three or more chunks);
//  3. `ssd_chunk_scan_kernel`: one block per (b, chunk, 64-row tile, head),
//     the heaviest row tiles first: the carried term, then for each column
//     tile on or below the diagonal the stored scores times the head's decay
//     times xbar, then D x.
// At mamba2-2.7b's prefill (B 4, S 512, H 80, G 1, L 256) that is 640 + 80
// blocks, then 2,560 blocks, each several times the card's 132 SMs.
//
// Products on the tensor cores: `mma.sync` m16n8k8 in TF32 with float32
// accumulation.  float32 takes the split: x = hi + lo (hi = cvt.rna.tf32(x),
// lo = cvt.rna.tf32(x - hi)) and each product is lo*hi + hi*lo + hi*hi,
// lo*lo (2^-22 relative) dropped.  bfloat16 values are exact in TF32 (8
// mantissa bits of 10), so in bfloat16 C B^T takes one pass, C s and
// xbar B^T two (their other operand is float32), and the decayed scores
// times xbar, both float32, three.  `ssd_scan_tolerance` adds the split's
// error term.  Why mma.sync and not wgmma: the operands come in every
// orientation (xbar is the B operand N-major in one product and the A
// operand M-major in another; the state is read transposed), TF32 wgmma
// takes B only K-major from shared memory, and a split operand needs its
// hi and lo halves in registers anyway; mma.sync loads each fragment from
// padded shared memory in whatever order the product needs, conflict-free,
// and splits it in registers.  wgmma, with the operands split once into
// shared memory, is later work.
//
// The cumulative log-decay is summed in float64, and every decay factor is
// evaluated in float64 and rounded once to float32.  At the model's widths
// cum reaches about -3,400 within a chunk, where a float32 ulp is 2.4e-4: a
// float32 cumsum would put errors of that size into the exponents.  In
// float64 the order of the sum changes a factor by ~1e-13, which shows in
// float32 only where it straddles a rounding boundary (one ulp), so these
// kernels and the plain version take the same factors to within one
// rounding.  Off the diagonal tile, exp(cum_l - cum_s) is evaluated as the
// float64 product exp(cum_l - cum_r0) exp(cum_r0 - cum_s) (r0 the row tile's
// first row, s < r0 <= l): both factors are <= 1 (dt A <= 0), so nothing
// overflows, and a factor that underflows in float64 makes the product
// underflow in float32 too; the product is off by ~2e-16 relative, inside
// the same one rounding.  That is 128 exps a tile in place of 4,096.
//
// Sizes: the kernels are instantiated at P and N of 16, 32, 64, 128 and
// 256; any head dim p and state size n up to 256 runs at the next of them
// (48 at 64, 80 at 128, 200 at 256).  Columns of x, B and C past p or n are
// staged as zeros, which change neither C B^T nor the first p rows and n
// columns of a state; y's columns past p are never written.  The states in
// the workspace are P x N (the padded rows and columns zeros), and the state
// pass runs P N threads a head.
//
// Chunks: a chunk of up to kSmemChunk (2,048) steps keeps its float64
// cumsum, dt and decay weights in each block's shared memory; a longer one
// (any length: the reference's chunk is any divisor of S) has them
// computed once per (b, chunk, head) by `ssd_chunk_cumsum_kernel` into the
// workspace, where both kernels read them.  The output kernel's grid holds
// B nc on its z dimension up to 65,535 and loops over the rest (at S 4,099,
// a prime, the chunk is 1 and B 16 gives 65,584).  These three cases run the
// kernels' general instantiations (kGen); a call at an instantiated P and N
// with a chunk of up to kSmemChunk and B nc up to 65,535 (every served
// model's) runs the others, with compile-time sizes and the cumsum in
// shared memory, as fast as before the general ones existed.
//
// Layout: x [B, S, H, P], B and C [B, S, G, N] (head h reads group
// h / (H / G)), dt [B, S, H] float32, all read through their strides (the
// last dimension of x, B and C contiguous), so the model's slices of one
// conv output need no copies.  A and D [H] float32.  x, B, C float32 or
// bfloat16; y [B, S, H, P] in x's type.  The workspace (float32, sized by
// `repro_ssd_scan_workspace`) holds the scores [B, nc, G, tile pairs, 64,
// 64], each chunk's exp(cum_{L-1}) [B, nc - 1, H] and the states [B, nc - 1,
// H, P, N]; the wrapper allocates it.
//
// Staging: each block copies its tiles from global to padded shared memory
// four elements at a time (one 16-byte load in float32, 8 bytes in
// bfloat16) where the rows of x, B and C start on such units, else element
// by element; C B^T and C s stage N in slices of 64, so a block needs at
// most ~40 KB at the served shapes and several blocks share an SM.
//
// What bounds it on this card: at mamba2-2.7b's prefill the group-shared
// form needs ~5.4 GFLOP of products, ~16 GFLOP as split TF32 (0.033 ms at
// 495 TFLOP/s), against 87 MB of inputs and outputs (0.026 ms at 3.35
// TB/s): operations, on the tensor cores.  Each fragment is loaded from
// shared memory and split on the CUDA cores, about four instructions per
// mma, and each output block copies its score and x tiles from L2 (each
// score tile once per head, each x tile once per row tile at or below it),
// so the staging and instruction issue, not the tensor cores, are the
// limits of this design (scripts/ssd_stages.py times them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::ensure_smem;
using repro::from_f32;
using repro::kMaxDevices;
using repro::mma_tf32;
using repro::split_tf32;
using repro::to_f32;

constexpr int kT = 64;          // rows (and columns) of a tile of a chunk
constexpr int kTile = kT * kT;  // elements of a score tile
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kScanLanes = 32;  // threads of the float64 cumsum
constexpr int kPS = kT + 4;     // decayed score tile row stride: 4 (mod 32)
constexpr int kNChunk = 64;     // state columns staged at a time for C B^T and C s
constexpr int kMaxSmem = 232448;
constexpr int kSmemChunk = 2048;  // longer chunks keep cum, dt and w in the workspace
constexpr int kMaxGridZ = 65535;

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// The shared-memory head every block starts with: cum [n] and the scan's
// partials in float64, dt [n] in float32; the tiles follow at `tiles`
// (n = 0 for a chunk whose cum lives in the workspace).
struct Head {
  int cum, part, dts, tiles;
  __host__ __device__ explicit Head(int n)
      : cum(0), part(align16(8 * n)), dts(part + 8 * kScanLanes),
        tiles(align16(part + 8 * kScanLanes + 4 * n)) {}
};

// The warps of a block over an [M x NN] product: kWM x kWN warps, each with
// kTM x kTN tiles of 16 x 8; warps from kBusy on hold no tile.
template <int M, int NN>
struct WarpGrid {
  static constexpr int kMT = M / 16, kNT = NN / 8;
  static constexpr int kWM = kMT < kWarps ? kMT : kWarps;
  static constexpr int kWN0 = kWarps / kWM;
  static constexpr int kWN = kNT < kWN0 ? kNT : kWN0;
  static constexpr int kTM = kMT / kWM, kTN = kNT / kWN;
  static constexpr int kBusy = kWM * kWN;
  static_assert(kTM * kWM == kMT && kTN * kWN == kNT, "tiles divide among the warps");
};

// acc += A[M x K] B[K x NN] over this warp's tiles (rows m0.., columns n0..),
// K a multiple of 8, A(r, k) and B(k, c) read by the functors from shared
// memory.  SA / SB: split the operand into TF32 hi + lo (float32 values);
// otherwise it is exact in TF32 (a bfloat16 value) and goes in as it is.
template <int TM, int TN, bool SA, bool SB, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[TM][TN][4], int m0, int n0, int K,
                                         FA fa, FB fb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[TM][4], al[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + 16 * i + g;
      const float v[4] = {fa(r, k + t), fa(r + 8, k + t), fa(r, k + t + 4), fa(r + 8, k + t + 4)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (SA) {
          split_tf32(v[e], ah[i][e], al[i][e]);
        } else {
          ah[i][e] = __float_as_uint(v[e]);
          al[i][e] = 0u;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + 8 * j + g;
      const float w0 = fb(k + t, c), w1 = fb(k + t + 4, c);
      uint32_t bh0, bl0, bh1, bl1;
      if (SB) {
        split_tf32(w0, bh0, bl0);
        split_tf32(w1, bh1, bl1);
      } else {
        bh0 = __float_as_uint(w0);
        bh1 = __float_as_uint(w1);
        bl0 = bl1 = 0u;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (SA) mma_tf32(acc[i][j], al[i], bh0, bh1);
        if (SB) mma_tf32(acc[i][j], ah[i], bl0, bl1);
        mma_tf32(acc[i][j], ah[i], bh0, bh1);
      }
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// cum[l] = sum_{k <= l} (double)(dts[k] * a) for l < n, in float64: 32
// threads sum contiguous runs, one thread scans the runs' totals, then each
// run adds its offset.  Every thread of the block calls it; it ends on a
// barrier.  Inlined, so that the callers' shared-memory arrays are read as
// shared memory (the workspace's, for a long chunk, as global).
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a, int n, double* cum, double* part) {
  const int tid = threadIdx.x;
  const int per = (n + kScanLanes - 1) / kScanLanes;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  if (tid < kScanLanes) {
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
    const double off = part[tid];
    for (int l = lo; l < hi; ++l) cum[l] += off;
  }
  __syncthreads();
}

struct Strides {
  long long xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg, ysb, yss, ysh;
  int vec;  // x, B and C rows start on whole 4-element units: loads go 4 elements at a time
  int p, n;  // the true head dim and state size (<= the instance's P, N)
};

// A long chunk's float64 cumsum, dt and decay weights w_l = exp(cum_{L-1} -
// cum_l), each [B, nc, H, L] in the workspace (ssd_chunk_cumsum_kernel);
// all null for chunks of up to kSmemChunk, whose blocks keep them in shared
// memory.
struct Scratch {
  double* cum;
  float* dts;
  float* w;
};

// Four consecutive elements of a row as floats: one 16-byte (float32) or
// 8-byte (bfloat16) load where the row is so aligned (`vec`), else four.
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
}
// Elements col .. col + 3 of a row (p points at col) where they lie below
// `lim`, zeros past it: the padded columns of a head dim or state size that
// is not an instantiated one (kGen; else every column is below `lim`).
template <bool kGen, typename T>
__device__ __forceinline__ float4 load4(const T* p, int col, int lim, bool vec) {
  if (!kGen || col + 4 <= lim) return load4(p, vec);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = col + e < lim ? to_f32(p[e]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 scale4(float4 v, float a) {
  return make_float4(v.x * a, v.y * a, v.z * a, v.w * a);
}
__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// ---------------------------------------------------------------- 1. states and scores

template <int P, int N>
struct StateGeo {
  // blocks a head's state is split over (by N): 64 columns a block from N 128 on
  static constexpr int kNS = N <= 32 ? 1 : (N == 64 ? 2 : N / 64);
  static constexpr int kNB = N / kNS;          // state columns a block computes
  static constexpr int kXS = P + 8;    // weighted xbar slab [64][P]: read down a column
  static constexpr int kBS = kNB + 8;  // B slab [64][kNB]: read down a column
  static constexpr int kNC = N < kNChunk ? N : kNChunk;  // score role: N staged kNC at a time
  static constexpr int kCS = kNC + 4;  // score role, C and B tiles [64][kNC]: read along a row
  static int state_bytes(int L) {  // + w [L]
    return Head(L).tiles + align16(4 * L) + 4 * (kT * kXS + kT * kBS);
  }
  static int score_bytes() { return 4 * 2 * kT * kCS; }
  static int bytes(int L) {
    const int a = state_bytes(L), b = score_bytes();
    return a > b ? a : b;
  }
};

template <typename T, int P, int N, bool kGen>
__device__ __forceinline__ void chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ A, const T* __restrict__ Bm,
                            float* __restrict__ states, float* __restrict__ decay,
                            const Scratch& ws, int idx, int H, int G, int nc, int L,
                            const Strides& s, uint8_t* smem) {
  using SG = StateGeo<P, N>;
  using WG = WarpGrid<P, SG::kNB>;
  constexpr bool kSplitB = sizeof(T) == 4;
  const int nb = idx % SG::kNS;
  idx /= SG::kNS;
  const int h = idx % H;
  idx /= H;
  const int c = idx % (nc - 1), b = idx / (nc - 1);
  const int grp = h / (H / G);
  const bool long_chunk = kGen && ws.cum != nullptr;  // cum, dt and w in the workspace
  const Head hd(long_chunk ? 0 : L);
  const float* dts;
  const float* w;
  float* xs;
  const int tid = threadIdx.x;
  const long long t0 = (long long)c * L;
  const T* xb = x + b * s.xsb + h * s.xsh + t0 * s.xss;
  const T* bb = Bm + b * s.bsb + grp * s.bsg + t0 * s.bss + nb * SG::kNB;
  if (long_chunk) {
    const long long o = (((long long)b * nc + c) * H + h) * L;
    dts = ws.dts + o;
    w = ws.w + o;
    xs = reinterpret_cast<float*>(smem + hd.tiles);
    if (tid == 0 && nb == 0)
      decay[((long long)b * (nc - 1) + c) * H + h] = (float)exp(ws.cum[o + L - 1]);
  } else {
    double* scum = reinterpret_cast<double*>(smem + hd.cum);
    double* part = reinterpret_cast<double*>(smem + hd.part);
    float* sdts = reinterpret_cast<float*>(smem + hd.dts);
    float* sw = reinterpret_cast<float*>(smem + hd.tiles);
    const float* db = dt + b * s.dsb + h * s.dsh + t0 * s.dss;
    for (int l = tid; l < L; l += kThreads) sdts[l] = db[l * s.dss];
    __syncthreads();
    chunk_cumsum(sdts, A[h], L, scum, part);
    const double total = scum[L - 1];
    if (tid == 0 && nb == 0) decay[((long long)b * (nc - 1) + c) * H + h] = (float)exp(total);
    for (int l = tid; l < L; l += kThreads) sw[l] = (float)exp(total - scum[l]);
    dts = sdts;
    w = sw;
    xs = sw + align16(4 * L) / 4;
  }
  float* bs = xs + kT * SG::kXS;

  float acc[WG::kTM][WG::kTN][4];
  zero(acc);
  const int warp = tid >> 5;
  const int m0 = (warp % WG::kWM) * WG::kTM * 16, n0 = (warp / WG::kWM) * WG::kTN * 8;
  for (int s0 = 0; s0 < L; s0 += kT) {
    const int ns = min(kT, L - s0);
    __syncthreads();  // w is written; the previous slab is consumed
    for (int i = tid; i < kT * P / 4; i += kThreads) {
      const int r = i / (P / 4), col = 4 * (i - r * (P / 4));
      store4(xs + r * SG::kXS + col,
             r < ns ? scale4(scale4(load4<kGen>(xb + (s0 + r) * s.xss + col, col, s.p, s.vec),
                                    dts[s0 + r]),
                             w[s0 + r])
                    : zero4());
    }
    for (int i = tid; i < kT * SG::kNB / 4; i += kThreads) {
      const int r = i / (SG::kNB / 4), col = 4 * (i - r * (SG::kNB / 4));
      store4(bs + r * SG::kBS + col,
             r < ns ? load4<kGen>(bb + (s0 + r) * s.bss + col, nb * SG::kNB + col, s.n, s.vec)
                    : zero4());
    }
    __syncthreads();
    if (warp < WG::kBusy)
      warp_mma<WG::kTM, WG::kTN, true, kSplitB>(
          acc, m0, n0, kT, [&](int r, int k) { return xs[k * SG::kXS + r]; },
          [&](int k, int col) { return bs[k * SG::kBS + col]; });
  }
  if (warp >= WG::kBusy) return;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* out = states + (((long long)b * (nc - 1) + c) * H + h) * (P * N) + nb * SG::kNB;
#pragma unroll
  for (int i = 0; i < WG::kTM; ++i)
#pragma unroll
    for (int j = 0; j < WG::kTN; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + 16 * i + g + 8 * half, n = n0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(out + p * N + n) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
}

template <typename T, int P, int N, bool kGen>
__device__ __forceinline__ void chunk_scores(const T* __restrict__ Bm, const T* __restrict__ Cm,
                             float* __restrict__ scores, int idx, int G, int nc, int L,
                             const Strides& s, uint8_t* smem) {
  using WG = WarpGrid<kT, kT>;
  constexpr int kNC = StateGeo<P, N>::kNC, kCS = StateGeo<P, N>::kCS;
  constexpr bool kSplit = sizeof(T) == 4;
  const int nt = (L + kT - 1) / kT, npairs = nt * (nt + 1) / 2;
  const int q = idx % npairs;
  idx /= npairs;
  const int grp = idx % G;
  idx /= G;
  const int c = idx % nc, b = idx / nc;
  int rt = 0, ct = q;
  while (ct > rt) ct -= ++rt;  // q = rt (rt + 1) / 2 + ct, ct <= rt
  const int r0 = rt * kT, nr = min(kT, L - r0);
  const int s0 = ct * kT, ns = min(kT, L - s0);
  float* cs = reinterpret_cast<float*>(smem);
  float* bs = cs + kT * kCS;
  const long long t0 = (long long)c * L;
  const T* cb = Cm + b * s.csb + grp * s.csg + (t0 + r0) * s.css;
  const T* bb = Bm + b * s.bsb + grp * s.bsg + (t0 + s0) * s.bss;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = (warp % WG::kWM) * WG::kTM * 16, n0 = (warp / WG::kWM) * WG::kTN * 8;
  float acc[WG::kTM][WG::kTN][4];
  zero(acc);
  const int n_cols = kGen ? s.n : N;
  for (int k0 = 0; k0 < n_cols; k0 += kNC) {  // slices wholly past n are zeros: skipped
    if (k0 > 0) __syncthreads();  // the previous columns are consumed
    for (int i = tid; i < kT * kNC / 4; i += kThreads) {
      const int r = i / (kNC / 4), col = k0 + 4 * (i - r * (kNC / 4));
      store4(cs + r * kCS + col - k0,
             r < nr ? load4<kGen>(cb + r * s.css + col, col, s.n, s.vec) : zero4());
      store4(bs + r * kCS + col - k0,
             r < ns ? load4<kGen>(bb + r * s.bss + col, col, s.n, s.vec) : zero4());
    }
    __syncthreads();
    if (warp < WG::kBusy)
      warp_mma<WG::kTM, WG::kTN, kSplit, kSplit>(
          acc, m0, n0, kNC, [&](int r, int k) { return cs[r * kCS + k]; },
          [&](int k, int col) { return bs[col * kCS + k]; });
  }
  if (warp >= WG::kBusy) return;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* out = scores + (((long long)b * nc + c) * G + grp) * npairs * kTile + (long long)q * kTile;
#pragma unroll
  for (int i = 0; i < WG::kTM; ++i)
#pragma unroll
    for (int j = 0; j < WG::kTN; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + 16 * i + g + 8 * half, col = n0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(out + r * kT + col) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
}

// Blocks [0, n_state) form chunk contributions, the rest score tiles.
// kGen: a head dim or state size below the instance's, or a chunk past
// kSmemChunk (the host picks; every served model's calls run !kGen, whose
// sizes are compile-time and whose cumsum is in shared memory).
template <typename T, int P, int N, bool kGen>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, float* __restrict__ states,
                       float* __restrict__ decay, float* __restrict__ scores, Scratch ws,
                       int n_state, int H, int G, int nc, int L, Strides s) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int idx = blockIdx.x;
  if (idx < n_state)
    chunk_state<T, P, N, kGen>(x, dt, A, Bm, states, decay, ws, idx, H, G, nc, L, s, smem);
  else
    chunk_scores<T, P, N, kGen>(Bm, Cm, scores, idx - n_state, G, nc, L, s, smem);
}

// A chunk longer than kSmemChunk: its cumsum, dt and decay weights, once per
// (b, chunk, head) = blockIdx.x, into the workspace (see Scratch).
__global__ void __launch_bounds__(kThreads)
ssd_chunk_cumsum_kernel(const float* __restrict__ dt, const float* __restrict__ A, Scratch ws,
                        int H, int nc, int L, Strides s) {
  __shared__ double part[kScanLanes];
  const int h = blockIdx.x % H, c = blockIdx.x / H % nc, b = blockIdx.x / H / nc;
  const long long o = (long long)blockIdx.x * L;
  const float* db = dt + b * s.dsb + h * s.dsh + (long long)c * L * s.dss;
  float* dts = ws.dts + o;
  double* cum = ws.cum + o;
  for (int l = threadIdx.x; l < L; l += kThreads) dts[l] = db[l * s.dss];
  __syncthreads();
  chunk_cumsum(dts, A[h], L, cum, part);
  const double total = cum[L - 1];
  for (int l = threadIdx.x; l < L; l += kThreads) ws.w[o + l] = (float)exp(total - cum[l]);
}

// ---------------------------------------------------------------- 2. passing the state

// states[b, c] holds chunk c's own contribution; afterwards the state
// leaving chunk c: s = s * exp(total_c) + contribution_c (two roundings, as
// the plain version's), for c = 1 .. nc - 2.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay, int H,
                      int nc, int PN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long slot = (long long)H * PN;
  float* st = states + ((long long)b * (nc - 1) * H + h) * PN + e;
  const float* dc = decay + (long long)b * (nc - 1) * H + h;
  float run = st[0];
  for (int c = 1; c < nc - 1; ++c) {
    run = run * dc[c * H] + st[c * slot];
    st[c * slot] = run;
  }
}

// ---------------------------------------------------------------- 3. the output

template <int P, int N>
struct ScanGeo {
  static constexpr int kNC = N < kNChunk ? N : kNChunk;  // N staged kNC at a time
  static constexpr int kCS = kNC + 4;  // C tile [64][kNC] and state [P][kNC]: read along a row
  static constexpr int kXS = P + 8;  // xbar tile [64][P]: read down a column
  static constexpr int kCarried = 4 * (kT + P) * kCS;
  static constexpr int kIntra = 4 * (kT * kPS + kT * kXS);
  static constexpr int kRegion = kCarried > kIntra ? kCarried : kIntra;
  static int bytes(int L) { return Head(L).tiles + 2 * 8 * kT + kRegion; }  // + ul, vs
};

// One output block: row tile blockIdx.x (heaviest first) of head blockIdx.y
// in chunk c of batch row b (z = b nc + c).  Inlined, as the two roles of
// the states kernel are: a call would take `smem` as a generic pointer and
// every tile access with it.
template <typename T, int P, int N, bool kGen>
__device__ __forceinline__ void chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A, const T* __restrict__ Cm,
                           const float* __restrict__ Dv, const float* __restrict__ states,
                           const float* __restrict__ scores, T* __restrict__ y,
                           const Scratch& ws, int z, int H, int G, int nc, int L,
                           const Strides& s, uint8_t* smem) {
  using SG = ScanGeo<P, N>;
  using WG = WarpGrid<kT, P>;
  constexpr bool kSplitC = sizeof(T) == 4;
  const int nt = gridDim.x, npairs = nt * (nt + 1) / 2;
  const int rt = nt - 1 - blockIdx.x;  // heavy row tiles first
  const int h = blockIdx.y;
  const int c = z % nc, b = z / nc;
  const int grp = h / (H / G);
  const int r0 = rt * kT, nr = min(kT, L - r0), rend = r0 + nr;

  const bool long_chunk = kGen && ws.cum != nullptr;  // cum and dt in the workspace
  const Head hd(long_chunk ? 0 : L);
  double* ul = reinterpret_cast<double*>(smem + hd.tiles);  // exp(cum_l - cum_r0), l in the row tile
  double* vs = ul + kT;                                     // exp(cum_r0 - cum_s), s in a column tile
  float* region = reinterpret_cast<float*>(vs + kT);
  float* cs = region;            // carried: C tile [64][kCS]
  float* ss = cs + kT * SG::kCS;  //          state [P][kCS]
  float* ps = region;            // intra: decayed scores [64][kPS]
  float* xs = ps + kT * kPS;     //        xbar [64][kXS]

  const int tid = threadIdx.x, warp = tid >> 5;
  const long long t0 = (long long)c * L;
  const T* xb = x + b * s.xsb + h * s.xsh + t0 * s.xss;
  const double* cum;
  const float* dts;
  if (long_chunk) {
    const long long o = (((long long)b * nc + c) * H + h) * L;
    cum = ws.cum + o;
    dts = ws.dts + o;
  } else {
    double* scum = reinterpret_cast<double*>(smem + hd.cum);
    float* sdts = reinterpret_cast<float*>(smem + hd.dts);
    const float* db = dt + b * s.dsb + h * s.dsh + t0 * s.dss;
    for (int l = tid; l < rend; l += kThreads) sdts[l] = db[l * s.dss];
    __syncthreads();
    chunk_cumsum(sdts, A[h], rend, scum, reinterpret_cast<double*>(smem + hd.part));
    cum = scum;
    dts = sdts;
  }

  const bool busy = warp < WG::kBusy;
  const int m0 = (warp % WG::kWM) * WG::kTM * 16, n0 = (warp / WG::kWM) * WG::kTN * 8;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float acc[WG::kTM][WG::kTN][4];
  zero(acc);

  const float* sc0 = scores + (((long long)b * nc + c) * G + grp) * npairs * kTile +
                     (long long)(rt * (rt + 1) / 2) * kTile;
  if (c > 0) {  // the state entering this chunk, through C, decayed from the chunk's start
    const T* cb = Cm + b * s.csb + grp * s.csg + (t0 + r0) * s.css;
    const float* sb = states + (((long long)b * (nc - 1) + c - 1) * H + h) * (P * N);
    const int n_cols = kGen ? s.n : N;
    for (int k0 = 0; k0 < n_cols; k0 += SG::kNC) {  // slices wholly past n are zeros: skipped
      if (k0 > 0) __syncthreads();  // the previous columns are consumed
      for (int i = tid; i < kT * SG::kNC / 4; i += kThreads) {
        const int r = i / (SG::kNC / 4), col = k0 + 4 * (i - r * (SG::kNC / 4));
        store4(cs + r * SG::kCS + col - k0,
               r < nr ? load4<kGen>(cb + r * s.css + col, col, s.n, s.vec) : zero4());
      }
      for (int i = tid; i < P * SG::kNC / 4; i += kThreads) {
        const int p = i / (SG::kNC / 4), n = 4 * (i - p * (SG::kNC / 4));
        store4(ss + p * SG::kCS + n, load4(sb + p * N + k0 + n, true));
      }
      __syncthreads();
      if (busy)
        warp_mma<WG::kTM, WG::kTN, kSplitC, true>(
            acc, m0, n0, SG::kNC, [&](int r, int k) { return cs[r * SG::kCS + k]; },
            [&](int k, int col) { return ss[col * SG::kCS + k]; });
    }
    if (busy) {
#pragma unroll
      for (int i = 0; i < WG::kTM; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + 16 * i + g + 8 * half;
          const float e = r < nr ? (float)exp(cum[r0 + r]) : 0.f;
#pragma unroll
          for (int j = 0; j < WG::kTN; ++j) {
            acc[i][j][2 * half] = e * acc[i][j][2 * half];
            acc[i][j][2 * half + 1] = e * acc[i][j][2 * half + 1];
          }
        }
    }
  }

  for (int ct = 0; ct <= rt; ++ct) {
    const int s0 = ct * kT, ns = min(kT, L - s0);
    const bool diag = ct == rt;
    if (!diag && tid < 2 * kT) {  // off the diagonal, the decay factors in two halves
      const int i = tid & (kT - 1);
      if (tid < kT) {
        if (i < nr) ul[i] = exp(cum[r0 + i] - cum[r0]);
      } else {
        vs[i] = exp(cum[r0] - cum[s0 + i]);  // a column tile below the diagonal is full
      }
    }
    __syncthreads();  // ul / vs written; the region's previous readers are done
    const float* sc = sc0 + (long long)ct * kTile;
    for (int i = tid; i < kTile / 4; i += kThreads) {
      const int r = i >> 4, col = 4 * (i & 15);
      const int l = r0 + r;
      const float4 v4 = load4(sc + 4 * i, true);
      float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c2 = col + e, sl = s0 + c2;
        if (r < nr && c2 < ns && sl <= l) {
          const double f = diag ? exp(cum[l] - cum[sl]) : ul[r] * vs[c2];
          v[e] = v[e] * (float)f;
        } else {
          v[e] = 0.f;
        }
      }
      store4(ps + r * kPS + col, make_float4(v[0], v[1], v[2], v[3]));
    }
    for (int i = tid; i < kT * P / 4; i += kThreads) {
      const int r = i / (P / 4), col = 4 * (i - r * (P / 4));
      store4(xs + r * SG::kXS + col,
             r < ns ? scale4(load4<kGen>(xb + (s0 + r) * s.xss + col, col, s.p, s.vec),
                             dts[s0 + r])
                    : zero4());
    }
    __syncthreads();
    if (busy)
      warp_mma<WG::kTM, WG::kTN, true, true>(
          acc, m0, n0, kT, [&](int r, int k) { return ps[r * kPS + k]; },
          [&](int k, int col) { return xs[k * SG::kXS + col]; });
  }

  if (!busy) return;
  const float dcoef = Dv[h];
  T* yb = y + b * s.ysb + h * s.ysh + (t0 + r0) * s.yss;
#pragma unroll
  for (int i = 0; i < WG::kTM; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + 16 * i + g + 8 * half;
      if (r >= nr) continue;
#pragma unroll
      for (int j = 0; j < WG::kTN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = n0 + 8 * j + 2 * t + e;
          if (kGen && p >= s.p) continue;  // y's columns past the head dim are never written
          const float xv = to_f32(xb[(r0 + r) * s.xss + p]);
          from_f32(yb + r * s.yss + p, acc[i][j][2 * half + e] + xv * dcoef);
        }
    }
}

// Blocks (row tile, head, z = blockIdx.z); under kGen (as above, or B nc
// past 65,535) z = blockIdx.z, then z + gridDim.z, ... up to B nc: the
// grid's z dimension holds at most 65,535.
template <typename T, int P, int N, bool kGen>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Cm,
                      const float* __restrict__ Dv, const float* __restrict__ states,
                      const float* __restrict__ scores, T* __restrict__ y, Scratch ws, int H,
                      int G, int nc, int L, int n_z, Strides s) {
  extern __shared__ __align__(16) uint8_t smem[];
  if constexpr (!kGen) {
    chunk_scan<T, P, N, false>(x, dt, A, Cm, Dv, states, scores, y, ws, blockIdx.z, H, G, nc,
                               L, s, smem);
  } else {
    for (int z = blockIdx.z; z < n_z; z += gridDim.z) {
      if (z != (int)blockIdx.z) __syncthreads();  // the last block's shared memory is consumed
      chunk_scan<T, P, N, true>(x, dt, A, Cm, Dv, states, scores, y, ws, z, H, G, nc, L, s,
                                smem);
    }
  }
}

// ---------------------------------------------------------------- host side

// The instantiated size a head dim or state size runs at, or 0 above 256.
int instance_size(int n) {
  for (int w = 16; w <= 256; w *= 2)
    if (n <= w) return w;
  return 0;
}

// Float32 elements: the scores, the per-chunk decays, the states at the
// instance's P x N, and for a chunk past kSmemChunk its cum (float64), dt
// and w, B S H of each.
long long workspace_floats(int B, int S, int H, int G, int P, int N, int L) {
  const long long nc = S / L, nt = (L + kT - 1) / kT;
  const long long scores = (long long)B * nc * G * (nt * (nt + 1) / 2) * kTile;
  const long long decay = ((long long)B * (nc - 1) * H + 3) / 4 * 4;
  const long long scratch = L > kSmemChunk ? 4LL * B * S * H : 0;
  return scores + decay + (long long)B * (nc - 1) * H * P * N + scratch;
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* Dv, void* y, float* ws, int B, int S, int H,
                   int G, int L, const Strides& st, cudaStream_t stream) {
  const int nc = S / L, nt = (L + kT - 1) / kT, npairs = nt * (nt + 1) / 2;
  float* scores = ws;
  float* decay = scores + (long long)B * nc * G * npairs * kTile;
  float* states = decay + ((long long)B * (nc - 1) * H + 3) / 4 * 4;
  Scratch scratch{nullptr, nullptr, nullptr};
  const int Ls = L > kSmemChunk ? 0 : L;  // the chunk's length in shared memory
  if (L > kSmemChunk) {
    const long long n = (long long)B * S * H;  // states end on an even float: cum aligned
    scratch.cum = reinterpret_cast<double*>(states + (long long)B * (nc - 1) * H * P * N);
    scratch.dts = reinterpret_cast<float*>(scratch.cum + n);
    scratch.w = scratch.dts + n;
  }
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);

  const long long n_state = (long long)B * (nc - 1) * H * StateGeo<P, N>::kNS;
  const long long n_blocks = n_state + (long long)B * nc * G * npairs;
  if (n_blocks > 0x7fffffffLL || (long long)B * nc * H > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem1 = StateGeo<P, N>::bytes(Ls);
  const int smem3 = ScanGeo<P, N>::bytes(Ls);
  if (smem1 > kMaxSmem || smem3 > kMaxSmem) return cudaErrorInvalidValue;

  cudaError_t err;
  if (scratch.cum != nullptr) {
    ssd_chunk_cumsum_kernel<<<(unsigned)(B * nc * H), kThreads, 0, stream>>>(dt, A, scratch, H,
                                                                            nc, L, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  // the general instantiations only where the call needs them
  const bool gen = st.p != P || st.n != N || L > kSmemChunk || (long long)B * nc > kMaxGridZ;
  auto k1 = gen ? ssd_chunk_state_kernel<T, P, N, true> : ssd_chunk_state_kernel<T, P, N, false>;
  static int set1[2][kMaxDevices] = {};
  err = ensure_smem(k1, smem1, set1[gen]);
  if (err != cudaSuccess) return err;
  k1<<<(unsigned)n_blocks, kThreads, smem1, stream>>>(xt, dt, A, bt, ct, states, decay, scores,
                                                      scratch, (int)n_state, H, G, nc, L, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (nc >= 3) {
    ssd_state_pass_kernel<<<dim3((P * N + kThreads - 1) / kThreads, H, B), kThreads, 0,
                            stream>>>(states, decay, H, nc, P * N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  auto k3 = gen ? ssd_chunk_scan_kernel<T, P, N, true> : ssd_chunk_scan_kernel<T, P, N, false>;
  static int set3[2][kMaxDevices] = {};
  err = ensure_smem(k3, smem3, set3[gen]);
  if (err != cudaSuccess) return err;
  const int n_z = B * nc;
  k3<<<dim3(nt, H, n_z < kMaxGridZ ? n_z : kMaxGridZ), kThreads, smem3, stream>>>(
      xt, dt, A, ct, Dv, states, scores, static_cast<T*>(y), scratch, H, G, nc, L, n_z, st);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(int N, const void* x, const float* dt, const float* A, const void* Bm,
                       const void* Cm, const float* Dv, void* y, float* ws, int B, int S, int H,
                       int G, int L, const Strides& st, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, A, Bm, Cm, Dv, y, ws, B, S, H, G, L, st, s);
    case 32: return launch<T, P, 32>(x, dt, A, Bm, Cm, Dv, y, ws, B, S, H, G, L, st, s);
    case 64: return launch<T, P, 64>(x, dt, A, Bm, Cm, Dv, y, ws, B, S, H, G, L, st, s);
    case 128: return launch<T, P, 128>(x, dt, A, Bm, Cm, Dv, y, ws, B, S, H, G, L, st, s);
    case 256: return launch<T, P, 256>(x, dt, A, Bm, Cm, Dv, y, ws, B, S, H, G, L, st, s);
    default: return cudaErrorInvalidValue;
  }
}

// P and N: the instantiated sizes (instance_size of the true ones, in st)
template <typename T>
cudaError_t dispatch(int P, int N, const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* Dv, void* y, float* ws, int B,
                     int S, int H, int G, int L, const Strides& st, cudaStream_t s) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(N, x, dt, A, Bm, Cm, Dv, y, ws, B, S, H, G, L, st, s);
    case 32: return dispatch_n<T, 32>(N, x, dt, A, Bm, Cm, Dv, y, ws, B, S, H, G, L, st, s);
    case 64: return dispatch_n<T, 64>(N, x, dt, A, Bm, Cm, Dv, y, ws, B, S, H, G, L, st, s);
    case 128: return dispatch_n<T, 128>(N, x, dt, A, Bm, Cm, Dv, y, ws, B, S, H, G, L, st, s);
    case 256: return dispatch_n<T, 256>(N, x, dt, A, Bm, Cm, Dv, y, ws, B, S, H, G, L, st, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_shape(int B, int S, int H, int G, int P, int N, int L) {
  return B >= 1 && B <= 65535 && S >= 1 && H >= 1 && G >= 1 && H % G == 0 && L >= 1 &&
         S % L == 0 && H <= 65535 && instance_size(P) > 0 && instance_size(N) > 0 && P >= 1 &&
         N >= 1;
}

}  // namespace

// Float32 elements of the workspace a call needs (scores, per-chunk decays,
// states and a long chunk's cumsum), or -1 for a shape the kernels do not
// take (P or N above 256).
extern "C" long long repro_ssd_scan_workspace(int B, int S, int H, int G, int P, int N, int L) {
  if (!valid_shape(B, S, H, G, P, N, L)) return -1;
  return workspace_floats(B, S, H, G, instance_size(P), instance_size(N), L);
}

// x [B, S, H, P], dt [B, S, H] float32, A and D [H] float32 (contiguous),
// B and C [B, S, G, N], y [B, S, H, P]; strides in elements, the last
// dimension of x, B, C and y contiguous.  bf16 != 0: x, B, C and y bfloat16,
// else float32.  L divides S; G divides H; P and N from 1 to 256.  ws:
// repro_ssd_scan_workspace float32 elements, 16-byte aligned.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* Dv, void* y, void* ws,
                              int B, int S, int H, int G, int P, int N, int L, int bf16,
                              long long xsb, long long xss, long long xsh,
                              long long dsb, long long dss, long long dsh,
                              long long bsb, long long bss, long long bsg,
                              long long csb, long long css, long long csg,
                              long long ysb, long long yss, long long ysh, void* stream) {
  if (!valid_shape(B, S, H, G, P, N, L)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(ws) % 16 != 0) return (int)cudaErrorInvalidValue;
  // rows of x, B and C start on 4-element units: base addresses and strides
  const uintptr_t unit = bf16 ? 8 : 16;
  const bool vec = reinterpret_cast<uintptr_t>(x) % unit == 0 &&
                   reinterpret_cast<uintptr_t>(Bm) % unit == 0 &&
                   reinterpret_cast<uintptr_t>(Cm) % unit == 0 &&
                   (xsb | xss | xsh | bsb | bss | bsg | csb | css | csg) % 4 == 0;
  const Strides st{xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg, ysb, yss, ysh,
                   (int)vec, P, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(Dv);
  float* wf = static_cast<float*>(ws);
  const int Pi = instance_size(P), Ni = instance_size(N);
  cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(Pi, Ni, x, dtf, Af, Bm, Cm, Df, y, wf, B, S,
                                                   H, G, L, st, s)
                         : dispatch<float>(Pi, Ni, x, dtf, Af, Bm, Cm, Df, y, wf, B, S, H, G, L,
                                           st, s);
  return (int)err;
}
