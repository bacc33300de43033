// ASAP replay of a packed bucket: the chain or star recurrence of the
// serial simulator for every instance of a batch, in one launch.
//
// Replaces the Pallas kernel `make_asap_replay_kernel` / `asap_replay_call`
// of src/repro/kernels/asap_replay.py.  Per instance: the per-cell
// durations (the chain's link volume is the suffix of gamma still to
// forward, summed from the last processor up; the star's is the worker's
// own fraction; padded cells are masked by `valid`, latency included), the
// send chain (chain store-and-forward or the star's one-port master), the
// compute fronts, the optional result-return chain (chain backward
// store-and-forward, or the star's serialized receive port) and the
// makespan.  m == 1 (no links) runs here too.
//
// What bounds it on this card.  The whole bucket is a few MB at most (each
// instance reads 2mT + 5T + 3m doubles and writes (4(m-1) + 2m) T + 1), so
// neither bytes nor operations bound a launch: the dependent chain of one
// instance does, T cells of L = m - 1 forward links, a compute front and L
// return links, each step a max and an add.  The design keeps everything
// off that chain and keeps the chain out of memory:
//
// - One warp a block, one instance at a time (a grid-stride loop over the
//   batch, at most 16 blocks an SM): a bucket of 256 instances runs on 256
//   blocks, spread over all SMs.
// - The instance's inputs are staged in shared memory, T_c cells at a time
//   (the whole of T when it fits in 48 KB), with 8-byte cp.async copies,
//   neighbouring lanes on neighbouring addresses.  A chunk is a few KB:
//   TMA would buy nothing over these copies, and 16-byte copies would need
//   16-byte alignment that the packed bucket does not promise.
// - The durations are computed by all lanes before the recurrence, a lane a
//   cell; each chain volume once per cell, summed sequentially in the
//   reference's order (O(m) per cell, not O(m^2)).
// - Lane 0 runs the recurrence.  For m <= 16 the kernel is instantiated for
//   exactly m processors: the carries (the previous cell's ends of every
//   link, compute front and return link) live in registers, every loop over
//   processors is unrolled with compile-time indices, and a cell is
//   straight-line code (the max is a select, not a branch).  A cell's
//   durations are read into registers at the top of its iteration, since a
//   load after a store to shared memory cannot be moved above it.  The
//   returns of cell t - 1 share an iteration with the sends of cell t: the
//   two chains are independent and the compiler interleaves them.  Above
//   m = 16 one instantiation for any m keeps the carries in shared memory.
// - The outputs are written into shared memory in place of the inputs the
//   recurrence no longer needs (gamma -> ps, w -> dcomp -> pe, dcomm -> ce,
//   dret -> re) and copied out coalesced after each chunk.
//
// The function is the reference's, bit for bit.  Sums and products keep its
// association (durations (z * vcomm) * vol + lat, then * valid; volumes
// from the last processor up; links walked in order, downstream forward and
// upstream on return, the star's carries crossing cells); the library is
// built with -fmad=false, so no product-sum is contracted.  Only the order
// of the maxima inside a step changes: the floor at 0 is taken before the
// chained operand instead of after it, max(max(r, u), 0) as max(max(r, 0),
// u).  Maxima are exact, so the two agree in value; they agree in bits too,
// because the chained operand u is an end time (lo + d with lo >= +0), never
// -0, or the return chain's -inf start.  That leaves one max and one add of
// each step on the chain.  `mx` propagates NaN as jnp.maximum does: the
// certify pass replays the NaN gammas of failed LPs, and their NaN
// makespans must fail certification.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 32;            // one warp a block
constexpr int kMmax = 16;               // exact-m instantiations, carries in registers
constexpr int kBlocksPerSm = 16;        // grid cap, in blocks an SM
constexpr int kChunkBytes = 48 * 1024;  // shared memory a chunk aims for

// max(a, b), NaN when either is NaN, as one select: a branch here would cut
// the straight-line code of a cell into blocks the compiler cannot schedule
// across.
__device__ __forceinline__ double mx(double a, double b) { return (a > b || isnan(a)) ? a : b; }

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// Stage rows x tc doubles (row stride `ld` in global memory) into a dense
// [rows][tc] array in shared memory, all lanes, consecutive lanes on
// consecutive cells.
__device__ __forceinline__ void stage(double* dst, const double* src, int rows, int tc, int ld,
                                      int lane) {
  for (int i = 0; i < rows; ++i)
    for (int t = lane; t < tc; t += kThreads) cp_async8(dst + i * tc + t, src + (size_t)i * ld + t);
}

// The inverse: a dense [rows][tc] array in shared memory out to global rows.
__device__ __forceinline__ void unstage(double* dst, const double* src, int rows, int tc, int ld,
                                        int lane) {
  for (int i = 0; i < rows; ++i)
    for (int t = lane; t < tc; t += kThreads) dst[(size_t)i * ld + t] = src[i * tc + t];
}

// N values in registers: every index must be a compile-time constant after
// unrolling, or the array goes to local memory.
template <int N>
struct Regs {
  double v[N];
  __device__ __forceinline__ double& operator[](int i) { return v[i]; }
};

// N values in shared memory, every `stride` doubles apart.
struct Smem {
  double* p;
  int stride;
  __device__ __forceinline__ double& operator[](int i) { return p[(size_t)i * stride]; }
};

// The shared-memory layout of one block, in doubles, for a chunk of tc
// cells: per instance z, lat, tau (and the carries when they do not fit in
// registers), then per chunk gamma/ps and w/dcomp/pe [m][tc], cs and
// dcomm/ce [L][tc], rs and dret/re [L][tc] with the return phase, and the
// cells' vcomm, vcomp, rel, valid (and ret).
struct Layout {
  int fixed, per_cell;
  __host__ __device__ Layout(int m, bool ret, bool carries_in_smem) {
    const int L = m - 1;
    fixed = 2 * L + m + (carries_in_smem ? 2 * L + m : 0);
    per_cell = 2 * m + (ret ? 4 * L + 5 : 2 * L + 4);
  }
  __host__ __device__ size_t bytes(int tc) const {
    return sizeof(double) * ((size_t)fixed + (size_t)per_cell * tc);
  }
};

// M > 0: exactly M processors, carries in registers, every loop over
// processors and links unrolled with compile-time indices.  M == 0: any m,
// carries in shared memory.
template <bool STAR, bool RET, int M>
__global__ void __launch_bounds__(kThreads)
asap_replay_kernel(const double* __restrict__ w, const double* __restrict__ z,
                   const double* __restrict__ lat, const double* __restrict__ tau,
                   const double* __restrict__ vcomm, const double* __restrict__ vcomp,
                   const double* __restrict__ rel, const double* __restrict__ retr,
                   const double* __restrict__ valid, const double* __restrict__ gamma,
                   double* __restrict__ cs, double* __restrict__ ce,
                   double* __restrict__ ps, double* __restrict__ pe,
                   double* __restrict__ rs, double* __restrict__ re,
                   double* __restrict__ mk, int B, int m_arg, int T, int TC) {
  extern __shared__ double smem[];
  constexpr bool kRegs = M > 0;
  const int m = kRegs ? M : m_arg;
  const int L = m - 1;
  const int lane = threadIdx.x;
  const Layout lay(m, RET, !kRegs);
  double* s_z = smem;
  double* s_lat = s_z + L;
  double* s_tau = s_lat + L;
  double* s_chunk = smem + lay.fixed;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    // per instance: link parameters and availability dates
    __syncwarp();  // the previous instance's write-back has read its chunk
    stage(s_z, z + (size_t)b * L, 1, L, 0, lane);
    stage(s_lat, lat + (size_t)b * L, 1, L, 0, lane);
    stage(s_tau, tau + (size_t)b * m, 1, m, 0, lane);

    // lane 0's carries across cells: the previous cell's send ends ce,
    // compute ends pe and return ends re, the star's port carries and the
    // running maximum of the return ends
    using Carry = std::conditional_t<kRegs, Regs<kRegs ? M : 1>, Smem>;
    Carry c_ce, c_pe, c_re;
    if constexpr (!kRegs) {
      c_ce = Smem{s_tau + m, 1};
      c_pe = Smem{s_tau + m + L, 1};
      c_re = Smem{s_tau + 2 * m + L, 1};
    }
    double last_send = 0.0, last_ret = 0.0, mk_ret = 0.0;

    for (int t0 = 0; t0 < T; t0 += TC) {
      const int tc = min(TC, T - t0);
      double* s_ps = s_chunk;          // gamma, then ps   [m][tc]
      double* s_pe = s_ps + m * tc;    // w, dcomp, pe     [m][tc]
      double* s_cs = s_pe + m * tc;    // cs               [L][tc]
      double* s_ce = s_cs + L * tc;    // dcomm, then ce   [L][tc]
      double* s_rs = s_ce + L * tc;    // rs               [L][tc] (RET)
      double* s_re = s_rs + (RET ? L * tc : 0);  // dret, then re [L][tc] (RET)
      double* s_vcomm = s_re + (RET ? L * tc : 0);
      double* s_vcomp = s_vcomm + tc;
      double* s_rel = s_vcomp + tc;
      double* s_valid = s_rel + tc;
      double* s_ret = s_valid + tc;  // (RET)

      const size_t bT = (size_t)b * T + t0;
      stage(s_ps, gamma + (size_t)b * m * T + t0, m, tc, T, lane);
      stage(s_pe, w + (size_t)b * m * T + t0, m, tc, T, lane);
      stage(s_vcomm, vcomm + bT, 1, tc, 0, lane);
      stage(s_vcomp, vcomp + bT, 1, tc, 0, lane);
      stage(s_rel, rel + bT, 1, tc, 0, lane);
      stage(s_valid, valid + t0, 1, tc, 0, lane);
      if (RET) stage(s_ret, retr + bT, 1, tc, 0, lane);
      repro::cp_async_commit();
      repro::cp_async_wait(0);
      __syncwarp();

      // ---- durations, a lane a cell, off the chain ----
      for (int tt = lane; tt < tc; tt += kThreads) {
        const double val = s_valid[tt], zv = s_vcomm[tt], vp = s_vcomp[tt];
        const double rv = RET ? s_ret[tt] * zv : 0.0;
        // links from the last up: the chain's volume is the suffix still to
        // forward, summed from the last processor up like the reference's
        // reversed cumsum
        double vol = STAR ? 0.0 : s_ps[L * tc + tt];
        for (int i = L - 1; i >= 0; --i) {
          if (STAR)
            vol = s_ps[(i + 1) * tc + tt];
          else if (i < L - 1)
            vol = vol + s_ps[(i + 1) * tc + tt];
          s_ce[i * tc + tt] = (s_z[i] * zv * vol + s_lat[i]) * val;
          if (RET) s_re[i * tc + tt] = (s_z[i] * rv * vol + s_lat[i]) * val;
        }
        for (int i = 0; i < m; ++i)
          s_pe[i * tc + tt] = s_pe[i * tc + tt] * vp * s_ps[i * tc + tt];
      }
      __syncwarp();

      // ---- the recurrence, lane 0 ----
      if (lane == 0) {
        if (t0 == 0) {
#pragma unroll
          for (int i = 0; i < m; ++i) {
            c_pe[i] = s_tau[i];
            if (i < L) c_ce[i] = c_re[i] = 0.0;
          }
        }
        // the sends of cell tt: (1) store-and-forward within the cell,
        // (2)/(3) receive-after-forward and (2b)/(3b) own port from the
        // previous cell; the star's one-port master carries across cells
        auto sends = [&](int tt, double rel_t, auto&& dcomm) {
          const double rel0 = mx(rel_t, 0.0);
          double up = 0.0;
#pragma unroll
          for (int i = 0; i < L; ++i) {
            double lo;
            if (STAR) {
              lo = mx(rel0, last_send);
            } else {
              double ready = c_ce[i];
              if (i + 1 < L) ready = mx(ready, c_ce[i + 1]);
              if (i == 0) ready = mx(ready, rel_t);
              lo = mx(mx(ready, 0.0), up);
            }
            const double end = lo + dcomm[i];
            s_cs[i * tc + tt] = lo;
            s_ce[i * tc + tt] = end;
            c_ce[i] = end;
            up = last_send = end;
          }
        };
        // the computations of cell tt: (8)/(9)+(10) and (6)
        auto fronts = [&](int tt, double rel_t, auto&& dcomp) {
#pragma unroll
          for (int i = 0; i < m; ++i) {
            const double s = mx(c_pe[i], i == 0 ? rel_t : c_ce[i - 1]);
            const double end = s + dcomp[i];
            s_ps[i * tc + tt] = s;
            s_pe[i * tc + tt] = end;
            c_pe[i] = end;
          }
        };
        // the result returns of cell tt: the chain upstream, (R6), (R2b),
        // (R1); the star's serialized receive port, (R1*), (R6)
        auto returns = [&](int tt, auto&& dret) {
          double down = -INFINITY;
#pragma unroll
          for (int k = 0; k < L; ++k) {
            const int i = STAR ? k : L - 1 - k;
            double lo;
            if (STAR)
              lo = mx(mx(c_pe[i + 1], 0.0), last_ret);
            else
              lo = mx(mx(mx(c_pe[i + 1], c_re[i]), 0.0), down);
            const double end = lo + dret[i];
            s_rs[i * tc + tt] = lo;
            s_re[i * tc + tt] = end;
            c_re[i] = end;
            down = last_ret = end;
            mk_ret = mx(mk_ret, end);
          }
        };
        // rows durations of cell tt: into registers, all at once and ahead
        // of the stores that follow them, or where they lie
        auto column = [&](double* base, int tt, int rows) {
          if constexpr (kRegs) {
            Regs<M> r;
#pragma unroll
            for (int i = 0; i < M; ++i)
              if (i < rows) r[i] = base[i * tc + tt];
            return r;
          } else {
            return Smem{base + tt, tc};
          }
        };
        // The returns of a cell need only its compute ends, and the next
        // cell's sends only its send ends, so the returns of cell tt - 1
        // share an iteration with the sends and computations of cell tt:
        // two independent chains the compiler interleaves.  Everything an
        // iteration reads from shared memory is read at its top: a load
        // after a store to shared memory cannot be moved above it.
        {
          const double rel_t = s_rel[0];
          auto dcomm = column(s_ce, 0, L);
          auto dcomp = column(s_pe, 0, m);
          sends(0, rel_t, dcomm);
          fronts(0, rel_t, dcomp);
        }
        for (int tt = 1; tt < tc; ++tt) {
          const double rel_t = s_rel[tt];
          auto dret = column(s_re, tt - 1, RET ? L : 0);
          auto dcomm = column(s_ce, tt, L);
          auto dcomp = column(s_pe, tt, m);
          if (RET) returns(tt - 1, dret);
          sends(tt, rel_t, dcomm);
          fronts(tt, rel_t, dcomp);
        }
        if (RET) returns(tc - 1, column(s_re, tc - 1, L));
      }
      __syncwarp();

      // ---- write-back, coalesced ----
      unstage(cs + (size_t)b * L * T + t0, s_cs, L, tc, T, lane);
      unstage(ce + (size_t)b * L * T + t0, s_ce, L, tc, T, lane);
      unstage(ps + (size_t)b * m * T + t0, s_ps, m, tc, T, lane);
      unstage(pe + (size_t)b * m * T + t0, s_pe, m, tc, T, lane);
      if (RET) {
        unstage(rs + (size_t)b * L * T + t0, s_rs, L, tc, T, lane);
        unstage(re + (size_t)b * L * T + t0, s_re, L, tc, T, lane);
      }
      __syncwarp();  // the next chunk's staging overwrites this one
    }

    if (lane == 0) {
      double out = c_pe[0];
#pragma unroll
      for (int i = 1; i < m; ++i) out = mx(out, c_pe[i]);
      if (RET) out = mx(out, mk_ret);
      mk[b] = out;
    }
  }
}

// Launch one instantiation: the chunk of cells that fits kChunkBytes (at
// least one cell, with the opt-in to more shared memory where a single cell
// needs it), the grid capped at kBlocksPerSm blocks an SM.
template <bool STAR, bool RET, int M>
cudaError_t launch(const double* w, const double* z, const double* lat, const double* tau,
                   const double* vcomm, const double* vcomp, const double* rel,
                   const double* retr, const double* valid, const double* gamma, double* cs,
                   double* ce, double* ps, double* pe, double* rs, double* re, double* mk, int B,
                   int m, int T, cudaStream_t s) {
  static int smem_set[repro::kMaxDevices] = {0};
  const Layout lay(m, RET, M == 0);
  const long long fit = ((long long)kChunkBytes / 8 - lay.fixed) / lay.per_cell;
  const int tc = fit >= T ? T : fit < 1 ? 1 : (int)fit;
  const size_t smem = lay.bytes(tc);
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;  // one cell of m > ~4,000
  auto kernel = asap_replay_kernel<STAR, RET, M>;
  if (smem > 48 * 1024) {
    err = repro::ensure_smem(kernel, (int)smem, smem_set);
    if (err != cudaSuccess) return err;
  }
  const int grid = B < sms * kBlocksPerSm ? B : sms * kBlocksPerSm;
  kernel<<<grid, kThreads, smem, s>>>(w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs,
                                       ce, ps, pe, rs, re, mk, B, m, T, tc);
  return cudaGetLastError();
}

// m = M .. kMmax: the instantiation for exactly m processors; above kMmax
// the one with its carries in shared memory.
template <bool STAR, bool RET, int M = 1>
cudaError_t dispatch(const double* w, const double* z, const double* lat, const double* tau,
                     const double* vcomm, const double* vcomp, const double* rel,
                     const double* retr, const double* valid, const double* gamma, double* cs,
                     double* ce, double* ps, double* pe, double* rs, double* re, double* mk,
                     int B, int m, int T, cudaStream_t s) {
  if constexpr (M > kMmax) {
    return launch<STAR, RET, 0>(w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs, ce,
                                ps, pe, rs, re, mk, B, m, T, s);
  } else {
    if (m == M)
      return launch<STAR, RET, M>(w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs, ce,
                                  ps, pe, rs, re, mk, B, m, T, s);
    return dispatch<STAR, RET, M + 1>(w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs,
                                      ce, ps, pe, rs, re, mk, B, m, T, s);
  }
}

// The floor of any schedule of the recurrence that keeps its association:
// one thread, `steps` dependent steps of one max and one add in registers.
__global__ void chain_floor_kernel(double* x, double y, double d, int steps) {
  double v = x[0];
#pragma unroll 16
  for (int k = 0; k < steps; ++k) v = mx(v, y) + d;
  x[0] = v;
}

}  // namespace

extern "C" int repro_asap_replay(const double* w, const double* z, const double* lat,
                                 const double* tau, const double* vcomm, const double* vcomp,
                                 const double* rel, const double* retr, const double* valid,
                                 const double* gamma, double* cs, double* ce, double* ps,
                                 double* pe, double* rs, double* re, double* mk, int B, int m,
                                 int T, int star, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool ret = retr != nullptr;
  if (star && ret)
    return (int)dispatch<true, true>(w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs,
                                     ce, ps, pe, rs, re, mk, B, m, T, s);
  if (star)
    return (int)dispatch<true, false>(w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs,
                                      ce, ps, pe, rs, re, mk, B, m, T, s);
  if (ret)
    return (int)dispatch<false, true>(w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs,
                                      ce, ps, pe, rs, re, mk, B, m, T, s);
  return (int)dispatch<false, false>(w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs,
                                     ce, ps, pe, rs, re, mk, B, m, T, s);
}

extern "C" int repro_asap_replay_chain_floor(double* x, double y, double d, int steps,
                                             void* stream) {
  chain_floor_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(x, y, d, steps);
  return (int)cudaGetLastError();
}
