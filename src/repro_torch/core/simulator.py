"""ASAP event simulator for the platform model (the Simgrid stand-in of
paper §6), topology-general.

Given an instance and the fractions ``gamma[i, t]`` (the only free decision
once the fixed lexicographic distribution order of §2 is adopted), the ASAP
(as-soon-as-possible) execution is the unique componentwise-minimal set of
start times satisfying the topology's constraint families — each start time
is the max of its lower bounds:

* **chain** — Fig. 6 families (1)-(10): store-and-forward down the links,
  own-port and receive-after-forward serialization, compute-after-receive;
* **star** — the one-port master families: all sends serialize on the
  master's port in the fixed order (cells lexicographic, workers in index
  order), worker ``i+1`` computes after its private link-``i`` receive;
* **result-return** (either topology, when ``inst.has_returns``) — each
  cell's results flow back toward the source: backward store-and-forward on
  the chain, serialized master receive-port on the star, with the makespan
  covering the last return arrival.

The simulator therefore evaluates the *achieved* makespan of any fraction
assignment, including those produced by the paper's adversary heuristics
(SIMPLE, SINGLEINST, MULTIINST, ...), with the same cost model (incl. §5
per-message latencies) as the LP.

It doubles as the replay validator for LP schedules: replaying the LP's
fractions must reproduce the LP objective (property-tested).
"""

from __future__ import annotations

import numpy as np

from .instance import Instance
from .schedule import Schedule, comm_durations, comp_durations, ret_durations

__all__ = ["simulate"]


def _comm_starts(inst: Instance, dcomm: np.ndarray, rel: np.ndarray) -> tuple:
    """Forward-phase starts/ends [m-1, T] under the topology's precedences."""
    m = inst.m
    T = dcomm.shape[1]
    cells = list(inst.cells())
    cs = np.zeros((max(m - 1, 0), T))
    ce = np.zeros((max(m - 1, 0), T))
    star = inst.topology == "star"
    for t, (n, _) in enumerate(cells):
        for i in range(m - 1):
            lo = 0.0
            if star:
                lo = max(lo, rel[n])  # nothing leaves the master before release
                if i >= 1:
                    lo = max(lo, ce[i - 1, t])  # master one-port, within cell
                elif t >= 1:
                    lo = max(lo, ce[m - 2, t - 1])  # one-port across cells
            else:
                if i == 0:
                    lo = max(lo, rel[n])  # load leaves P_0 only after release
                if i >= 1:
                    lo = max(lo, ce[i - 1, t])  # (1)
                if t >= 1:
                    lo = max(lo, ce[i, t - 1])  # own-port serialization (2b/3b)
                    if i + 1 <= m - 2:
                        lo = max(lo, ce[i + 1, t - 1])  # (2)/(3)
            cs[i, t] = lo
            ce[i, t] = lo + dcomm[i, t]
    return cs, ce


def _ret_starts(inst: Instance, dret: np.ndarray, pe: np.ndarray) -> tuple:
    """Return-phase starts/ends [m-1, T] under the topology's precedences."""
    m = inst.m
    T = dret.shape[1]
    rs = np.zeros((max(m - 1, 0), T))
    re = np.zeros((max(m - 1, 0), T))
    star = inst.topology == "star"
    for t in range(T):
        if star:
            for i in range(m - 1):  # serialized master receive port
                lo = max(0.0, pe[i + 1, t])
                if i >= 1:
                    lo = max(lo, re[i - 1, t])
                elif t >= 1:
                    lo = max(lo, re[m - 2, t - 1])
                rs[i, t] = lo
                re[i, t] = lo + dret[i, t]
        else:
            for i in range(m - 2, -1, -1):  # backward store-and-forward
                lo = max(0.0, pe[i + 1, t])
                if i + 1 <= m - 2:
                    lo = max(lo, re[i + 1, t])
                if t >= 1:
                    lo = max(lo, re[i, t - 1])  # per-link serialization
                rs[i, t] = lo
                re[i, t] = lo + dret[i, t]
    return rs, re


def simulate(inst: Instance, gamma: np.ndarray) -> Schedule:
    """ASAP replay of fraction assignment ``gamma`` ([m, T]); returns a Schedule."""
    m = inst.m
    cells = list(inst.cells())
    T = len(cells)
    gamma = np.asarray(gamma, dtype=np.float64)
    if gamma.shape != (m, T):
        raise ValueError(f"gamma must be [m={m}, T={T}], got {gamma.shape}")

    dcomm = comm_durations(inst, gamma)  # [m-1, T]
    dcomp = comp_durations(inst, gamma)  # [m, T]

    rel = inst.loads.release
    cs, ce = _comm_starts(inst, dcomm, rel)

    # computations — identical recurrence in both topologies: link i-1 feeds
    # P_i, so (6) reads ce[i-1, t]; (8)/(9) serialize per processor; (10)/(4r)
    ps = np.zeros((m, T))
    pe = np.zeros((m, T))
    for t, (n, _) in enumerate(cells):
        for i in range(m):
            lo = inst.platform.tau[i] if t == 0 else pe[i, t - 1]
            if i == 0:
                lo = max(lo, rel[n])
            else:
                lo = max(lo, ce[i - 1, t])  # (6)
            ps[i, t] = lo
            pe[i, t] = lo + dcomp[i, t]

    rs = re = None
    if inst.has_returns and m > 1:
        dret = ret_durations(inst, gamma)
        rs, re = _ret_starts(inst, dret, pe)

    makespan = float(pe[:, T - 1].max()) if T else 0.0
    if re is not None and re.size:
        makespan = max(makespan, float(re.max()))
    return Schedule(
        instance=inst,
        gamma=gamma,
        comm_start=cs,
        comm_end=ce,
        comp_start=ps,
        comp_end=pe,
        makespan=makespan,
        ret_start=rs,
        ret_end=re,
    )
