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
// makespan.
//
// Design: the recurrence is sequential inside an instance and independent
// across instances, so each thread replays one instance, with the cell and
// link loops inside the thread.  The previous cell's ends are read back from
// the outputs this thread has just written, so a thread needs no scratch
// arrays.  m == 1 (no links) runs here too.  Topology and the return phase
// are template parameters, as they were static variants of the TPU kernel.
// Sums and products follow the reference's association; the library is
// built with -fmad=false, so no product-sum is contracted.  `max` propagates
// NaN as jnp.maximum does: the certify pass replays the NaN gammas of
// failed LPs, and their NaN makespans must fail certification.
//
// Bound on this card: each instance reads (2m + 3T + 2(m-1)) doubles and
// writes (2(m-1) + 2m [+ 2(m-1)]) T + 1 doubles; the whole bucket is a few
// MB at most, so a launch is bound by the length of one thread's
// dependent chain (T cells of m links), not by bytes or operations.  The
// grid is one thread per instance; nothing is gained by more threads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ double mx(double a, double b) {
  if (isnan(a) || isnan(b)) return nan("");
  return a > b ? a : b;
}

template <bool STAR, bool RET>
__global__ void __launch_bounds__(kThreads)
asap_replay_kernel(const double* __restrict__ w, const double* __restrict__ z,
                   const double* __restrict__ lat, const double* __restrict__ tau,
                   const double* __restrict__ vcomm, const double* __restrict__ vcomp,
                   const double* __restrict__ rel, const double* __restrict__ retr,
                   const double* __restrict__ valid, const double* __restrict__ gamma,
                   double* __restrict__ cs, double* __restrict__ ce,
                   double* __restrict__ ps, double* __restrict__ pe,
                   double* __restrict__ rs, double* __restrict__ re,
                   double* __restrict__ mk, int B, int m, int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int L = m - 1;
  const double* wb = w + (size_t)b * m * T;
  const double* gb = gamma + (size_t)b * m * T;
  const double* zb = z + (size_t)b * L;
  const double* lb = lat + (size_t)b * L;
  const double* taub = tau + (size_t)b * m;
  const double* vcm = vcomm + (size_t)b * T;
  const double* vcp = vcomp + (size_t)b * T;
  const double* rlb = rel + (size_t)b * T;
  double* csb = cs + (size_t)b * L * T;
  double* ceb = ce + (size_t)b * L * T;
  double* psb = ps + (size_t)b * m * T;
  double* peb = pe + (size_t)b * m * T;
  double* rsb = RET ? rs + (size_t)b * L * T : nullptr;
  double* reb = RET ? re + (size_t)b * L * T : nullptr;

  double last_send = 0.0, last_ret = 0.0, mk_ret = 0.0;
  for (int t = 0; t < T; ++t) {
    const double rel_t = rlb[t];
    const double val_t = valid[t];
    const double zv = vcm[t];
    const double rv = RET ? retr[(size_t)b * T + t] * vcm[t] : 0.0;

    // ---- forward: the send chain ----
    // vol(i) is gamma[i+1] (star) or sum_{k > i} gamma[k] (chain), summed
    // from the last processor up like the reference's reversed cumsum;
    // the chain walks links downstream, so the suffix is built first
    double up_ce = 0.0;
    for (int i = 0; i < L; ++i) {
      double vol;
      if (STAR) {
        vol = gb[(size_t)(i + 1) * T + t];
      } else {
        vol = gb[(size_t)(m - 1) * T + t];
        for (int k = m - 2; k > i; --k) vol = vol + gb[(size_t)k * T + t];
      }
      const double d = (zb[i] * zv * vol + lb[i]) * val_t;
      double lo;
      if (STAR) {
        lo = mx(mx(last_send, rel_t), 0.0);
      } else {
        // (2b)/(3b) own port and (2)/(3) receive-after-forward from the
        // previous cell, (1) store-and-forward within the cell
        double ready = t > 0 ? ceb[(size_t)i * T + t - 1] : 0.0;
        if (t > 0 && i + 1 < L) ready = mx(ready, ceb[(size_t)(i + 1) * T + t - 1]);
        if (i == 0) ready = mx(ready, rel_t);
        lo = mx(mx(ready, i == 0 ? 0.0 : up_ce), 0.0);
      }
      const double end = lo + d;
      csb[(size_t)i * T + t] = lo;
      ceb[(size_t)i * T + t] = end;
      if (STAR) last_send = end;
      up_ce = end;
    }

    // ---- computations: (8)/(9)+(10) and (6) ----
    for (int i = 0; i < m; ++i) {
      const double prev = t > 0 ? peb[(size_t)i * T + t - 1] : taub[i];
      const double recv = i == 0 ? rel_t : ceb[(size_t)(i - 1) * T + t];
      const double s = mx(prev, recv);
      psb[(size_t)i * T + t] = s;
      peb[(size_t)i * T + t] = s + wb[(size_t)i * T + t] * vcp[t] * gb[(size_t)i * T + t];
    }

    if (!RET) continue;
    // ---- result return ----
    double down_re = -INFINITY;
    for (int j = 0; j < L; ++j) {
      const int i = STAR ? j : L - 1 - j;
      double vol;
      if (STAR) {
        vol = gb[(size_t)(i + 1) * T + t];
      } else {
        vol = gb[(size_t)(m - 1) * T + t];
        for (int k = m - 2; k > i; --k) vol = vol + gb[(size_t)k * T + t];
      }
      const double d = (zb[i] * rv * vol + lb[i]) * val_t;
      const double pe_next = peb[(size_t)(i + 1) * T + t];
      double lo;
      if (STAR) {
        lo = mx(mx(last_ret, pe_next), 0.0);  // (R1*), (R6)
      } else {
        const double prev_re = t > 0 ? reb[(size_t)i * T + t - 1] : 0.0;
        lo = mx(mx(mx(pe_next, prev_re), down_re), 0.0);  // (R6), (R2b), (R1)
      }
      const double end = lo + d;
      rsb[(size_t)i * T + t] = lo;
      reb[(size_t)i * T + t] = end;
      if (STAR) last_ret = end;
      down_re = end;
      mk_ret = mx(mk_ret, end);
    }
  }

  double out = peb[T - 1];
  for (int i = 1; i < m; ++i) out = mx(out, peb[(size_t)i * T + T - 1]);
  if (RET) out = mx(out, mk_ret);
  mk[b] = out;
}

}  // namespace

extern "C" int repro_asap_replay(const double* w, const double* z, const double* lat,
                                 const double* tau, const double* vcomm, const double* vcomp,
                                 const double* rel, const double* retr, const double* valid,
                                 const double* gamma, double* cs, double* ce, double* ps,
                                 double* pe, double* rs, double* re, double* mk, int B, int m,
                                 int T, int star, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const dim3 grid((B + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool ret = retr != nullptr;
  if (star && ret)
    asap_replay_kernel<true, true><<<grid, kThreads, 0, s>>>(
        w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs, ce, ps, pe, rs, re, mk, B, m, T);
  else if (star)
    asap_replay_kernel<true, false><<<grid, kThreads, 0, s>>>(
        w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs, ce, ps, pe, rs, re, mk, B, m, T);
  else if (ret)
    asap_replay_kernel<false, true><<<grid, kThreads, 0, s>>>(
        w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs, ce, ps, pe, rs, re, mk, B, m, T);
  else
    asap_replay_kernel<false, false><<<grid, kThreads, 0, s>>>(
        w, z, lat, tau, vcomm, vcomp, rel, retr, valid, gamma, cs, ce, ps, pe, rs, re, mk, B, m, T);
  return (int)cudaGetLastError();
}
