"""Serial schedule-LP builder — the sparse consumer of the shared IR.

The constraint families themselves (Fig. 6 (1)-(10) for the chain, the
star's one-port master families, the (2b)/(3b) own-port rows, the
result-return phase, and the §5 extensions) are emitted exactly once, in
:mod:`repro_torch.lpir.ir`, dispatched on the instance's topology; this module
lowers that row stream to the sparse triplet form the serial simplex /
HiGHS path consumes and keeps the historical :class:`ScheduleLP` container
+ :func:`extract_schedule` API.

Variables (end-times substituted out via constraints (5)/(7), which halves the
variable count without changing the feasible set):

  comm_start[i, t]   i in 0..m-2, t in 0..T-1   (T = total installments)
  comp_start[i, t]   i in 0..m-1
  gamma[i, t]        i in 0..m-1
  makespan
  completion[n]      (optional, for affine objectives over completion times)

with  comm_end(i,t) = comm_start[i,t] + K_i + z_i * V_comm(n_t) * sum_{k>i} gamma[k,t]
and   comp_end(i,t) = comp_start[i,t] + w_i(n_t) * V_comp(n_t) * gamma[i,t].

§5 extensions implemented: per-message affine latencies K_i, processor
availability dates tau_i, load release dates, unrelated machines w_i^n, and
affine objectives  sum_n alpha_n C_n + beta * makespan.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.lpir import InstanceView, elide_dead_rows, emit_schedule_ir, lower_sparse

from .instance import Instance
from .schedule import Schedule, comm_durations, comp_durations, ret_durations

__all__ = ["ScheduleLP", "build_lp", "extract_schedule"]


@dataclasses.dataclass
class ScheduleLP:
    instance: Instance
    n_vars: int
    c: np.ndarray
    # sparse triplets
    ub_rows: list
    ub_cols: list
    ub_vals: list
    b_ub: list
    eq_rows: list
    eq_cols: list
    eq_vals: list
    b_eq: list
    # variable offsets
    off_comm: int
    off_comp: int
    off_gamma: int
    off_mk: int
    off_cn: int  # -1 if absent
    T: int
    off_ret: int = -1  # -1 if the result-return phase is absent

    def comm(self, i: int, t: int) -> int:
        return self.off_comm + i * self.T + t

    def comp(self, i: int, t: int) -> int:
        return self.off_comp + i * self.T + t

    def gam(self, i: int, t: int) -> int:
        return self.off_gamma + i * self.T + t

    def dense_ub(self) -> tuple[np.ndarray, np.ndarray]:
        A = np.zeros((len(self.b_ub), self.n_vars))
        A[self.ub_rows, self.ub_cols] = 0.0  # ensure shape
        for r, c_, v in zip(self.ub_rows, self.ub_cols, self.ub_vals):
            A[r, c_] += v
        return A, np.asarray(self.b_ub)

    def dense_eq(self) -> tuple[np.ndarray, np.ndarray]:
        A = np.zeros((len(self.b_eq), self.n_vars))
        for r, c_, v in zip(self.eq_rows, self.eq_cols, self.eq_vals):
            A[r, c_] += v
        return A, np.asarray(self.b_eq)

    def sparse_ub(self):
        import scipy.sparse as sp

        return sp.coo_matrix(
            (self.ub_vals, (self.ub_rows, self.ub_cols)), shape=(len(self.b_ub), self.n_vars)
        ).tocsr()

    def sparse_eq(self):
        import scipy.sparse as sp

        return sp.coo_matrix(
            (self.eq_vals, (self.eq_rows, self.eq_cols)), shape=(len(self.b_eq), self.n_vars)
        ).tocsr()


def build_lp(
    inst: Instance,
    objective: str = "makespan",
    weights=None,
    beta: float = 0.0,
) -> ScheduleLP:
    """Build the Fig. 6 LP for ``inst`` (emitted via the shared IR).

    objective:
      "makespan"    — min makespan (the paper's objective);
      "completion"  — min sum_n weights[n] * C_n + beta * makespan (§5 affine
                      objective; default weights = 1 → average completion time).
    """
    ir = emit_schedule_ir(
        InstanceView(inst), objective=objective, weights=weights, beta=beta
    )
    # per-row elision reproduces the historical builder exactly: a release /
    # availability row was only ever written when its date was nonzero
    ir = elide_dead_rows(ir, granularity="row")
    rows = lower_sparse(ir)
    lay = ir.layout
    return ScheduleLP(
        instance=inst,
        n_vars=lay.n_vars,
        c=ir.c,
        ub_rows=rows.ub_rows,
        ub_cols=rows.ub_cols,
        ub_vals=rows.ub_vals,
        b_ub=rows.b_ub,
        eq_rows=rows.eq_rows,
        eq_cols=rows.eq_cols,
        eq_vals=rows.eq_vals,
        b_eq=rows.b_eq,
        off_comm=lay.off_comm,
        off_comp=lay.off_comp,
        off_gamma=lay.off_gamma,
        off_mk=lay.off_mk,
        off_cn=lay.off_cn,
        T=lay.T,
        off_ret=lay.off_ret,
    )


def extract_schedule(lp: ScheduleLP, x: np.ndarray) -> Schedule:
    """Turn an LP solution vector into a Schedule (ends recomputed from starts)."""
    inst = lp.instance
    m, T = inst.m, lp.T
    gamma = np.maximum(x[lp.off_gamma : lp.off_gamma + m * T].reshape(m, T), 0.0)
    cs = x[lp.off_comm : lp.off_comm + max(m - 1, 0) * T].reshape(max(m - 1, 0), T)
    ps = x[lp.off_comp : lp.off_comp + m * T].reshape(m, T)
    dcomm = comm_durations(inst, gamma)
    dcomp = comp_durations(inst, gamma)
    rs = re = None
    if lp.off_ret >= 0:
        rs = x[lp.off_ret : lp.off_ret + max(m - 1, 0) * T].reshape(max(m - 1, 0), T)
        re = rs + ret_durations(inst, gamma)
    return Schedule(
        instance=inst,
        gamma=gamma,
        comm_start=cs,
        comm_end=cs + dcomm,
        comp_start=ps,
        comp_end=ps + dcomp,
        makespan=float(x[lp.off_mk]),
        ret_start=rs,
        ret_end=re,
    )
