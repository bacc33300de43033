"""The comparison heuristics of paper §6 (and the [18]/[19] algorithms of §3).

All heuristics produce *fraction assignments* (gamma) plus an installment
structure; the achieved makespan is always measured by replaying the fractions
through the ASAP simulator (`repro_torch.core.simulator`) — the exact counterpart of
the paper's Perl-script + Simgrid protocol.

Implemented strategies:

  SIMPLE        one installment per load, fractions proportional to speeds.
  SINGLELOAD    [18] applied load by load: per-load equal-finish solve whose
                time origin is the availability date of the *first* link —
                downstream link availability is ignored (the paper explains
                this is why it collapses when communications are expensive).
  SINGLEINST    [19] single-installment: load-by-load equal-completion solve
                with full knowledge of link/port availability.
  MULTIINST     [19] multi-installment: load-by-load; each installment is the
                largest equal-compute-duration chunk whose communications
                complete before the processors finish the previous chunk
                (no idle).  May FAIL to cover a load (paper §3.4 case 1) —
                reported as a ``failure == "infeasible"`` result, never an
                exception.  ``cap`` bounds installments per load; the capped
                variant dumps the remainder in the last installment
                (MULTIINST-n of §6).

Failure signalling contract (the campaign classifier depends on it): a
strategy that cannot produce a schedule returns a :class:`HeuristicResult`
with ``failed=True`` and a structured ``failure`` kind —

  "infeasible"   the strategy's own construction has no solution on this
                 instance (paper §3.4 case 1, a per-load LP with an empty
                 feasible set, installment divergence past the limit);
  "error"        an unexpected exception inside the construction (a solver
                 blow-up on pathological numbers) — :func:`run_strategy`
                 converts it into a result so a campaign sweep can tally it
                 instead of aborting;
  "unsupported"  the instance is outside the strategy's model (star
                 topology / result-return phase — the [18]/[19] strategies
                 are chain-only); raised as ``ValueError`` by the direct
                 call, converted by :func:`run_strategy`.
  HEURISTIC_B   reconstruction of [19]'s Heuristic B: like SINGLEINST but the
                participating set is the best prefix P_1..P_p per load.

NOTE — faithfulness: [19]'s exact pseudo-code is not reproduced in the paper
under study; SINGLEINST/MULTIINST follow the defining principles quoted in
§3.1 ("all processors complete simultaneously ...", "each installment is the
largest possible ...", "keep processors busy").  The reconstruction is
validated exactly against every closed form the paper derives for them on the
motivating example (tests/test_motivating_example.py): the single-installment
regime and threshold, the geometric installment sizes gamma_1^k(2) =
lambda^k * gamma_2^1(1), the installment-count formula Q_2, the makespan 9/10
at lambda = 3/4, and the divergence (no solution) for lambda < (sqrt(17)+1)/8.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.lpir import EqualFinishView, elide_dead_rows, emit_schedule_ir, lower_dense

from .instance import Instance
from .schedule import Schedule
from .simplex import solve_simplex
from .simulator import simulate

__all__ = [
    "HeuristicResult",
    "simple",
    "single_load",
    "single_inst",
    "multi_inst",
    "heuristic_b",
    "run_strategy",
    "adversary_sweep",
    "ALL_HEURISTICS",
    "FAILURE_KINDS",
]

_TOL = 1e-12


def _require_chain(inst: Instance, name: str) -> None:
    """The [18]/[19] strategies are defined on the paper's chain platform;
    star instances are solved through the topology-general LP instead."""
    if inst.topology != "chain":
        raise ValueError(
            f"{name} is a chain heuristic; got a {inst.topology!r} instance "
            "(use the schedule LP — repro_torch.core.solver.solve — for stars)"
        )
    if inst.has_returns:
        raise ValueError(
            f"{name} predates the result-return phase; solve return-phase "
            "instances through the schedule LP instead"
        )


# the structured failure kinds a HeuristicResult may carry ("" == success)
FAILURE_KINDS = ("", "infeasible", "error", "unsupported")


@dataclasses.dataclass
class HeuristicResult:
    name: str
    instance: Instance | None  # with the heuristic's installment structure
    gamma: np.ndarray | None  # [m, T]
    schedule: Schedule | None  # ASAP replay
    failed: bool = False
    reason: str = ""
    # structured failure kind (see module docstring): "" on success,
    # "infeasible" when the strategy's construction has no solution,
    # "error" for an unexpected exception, "unsupported" for instances
    # outside the strategy's model.  Failed results constructed before this
    # field existed default to "infeasible" in __post_init__ so old
    # call sites keep their meaning.
    failure: str = ""

    def __post_init__(self):
        if self.failed and not self.failure:
            self.failure = "infeasible"
        if self.failure not in FAILURE_KINDS:
            raise ValueError(f"unknown failure kind {self.failure!r}")

    @property
    def makespan(self) -> float:
        return self.schedule.makespan if self.schedule is not None else np.inf

    @property
    def infeasible(self) -> bool:
        """True when the strategy itself has no solution on this instance
        (as opposed to an internal error or an out-of-model instance)."""
        return self.failure == "infeasible"


class _State:
    """Platform availability carried across the load-by-load constructions."""

    def __init__(self, inst: Instance):
        self.inst = inst
        m = inst.m
        self.last_ce = np.zeros(max(m - 1, 0))  # last comm end on link i
        self.proc_free = inst.chain.tau.copy()  # last comp end on P_i

    def link_ready(self) -> np.ndarray:
        """Earliest start for the next message on each link ((2b) + (2)/(3))."""
        m = self.inst.m
        r = self.last_ce.copy()
        for i in range(m - 1):
            if i + 1 <= m - 2:
                r[i] = max(r[i], self.last_ce[i + 1])
        return r

    def apply_cell(self, n: int, gamma_col: np.ndarray) -> None:
        """ASAP-execute one cell (same recurrences as the simulator)."""
        inst = self.inst
        m = inst.m
        vcomm, vcomp = inst.loads.v_comm[n], inst.loads.v_comp[n]
        rel = inst.loads.release[n]
        suffix = np.concatenate([np.cumsum(gamma_col[::-1])[::-1], [0.0]])
        ready = self.link_ready()
        prev_ce = 0.0
        for i in range(m - 1):
            lo = ready[i]
            if i == 0:
                lo = max(lo, rel)
            else:
                lo = max(lo, prev_ce)
            dur = inst.chain.latency[i] + inst.chain.z[i] * vcomm * suffix[i + 1]
            ce = lo + dur
            self.last_ce[i] = ce
            arrival_of = ce
            prev_ce = ce
            # computation on P_{i+1}
            ps = max(self.proc_free[i + 1], arrival_of)
            self.proc_free[i + 1] = ps + inst.w_of(i + 1, n) * vcomp * gamma_col[i + 1]
        # P_0
        ps0 = max(self.proc_free[0], rel)
        self.proc_free[0] = ps0 + inst.w_of(0, n) * vcomp * gamma_col[0]


def _finalize(name: str, inst: Instance, q: list[int], cols: list[np.ndarray]) -> HeuristicResult:
    inst_q = inst.with_q(q)
    gamma = np.stack(cols, axis=1)
    sched = simulate(inst_q, gamma)
    return HeuristicResult(name=name, instance=inst_q, gamma=gamma, schedule=sched)


# --------------------------------------------------------------------------
# per-load equal-finish LP (the [18]/[19] building block)
# --------------------------------------------------------------------------


def _equal_finish_load(
    inst: Instance,
    n: int,
    proc_free: np.ndarray,
    link_ready: np.ndarray,
    participants: np.ndarray | None = None,
) -> np.ndarray | None:
    """Fractions for load ``n`` s.t. all participants finish simultaneously,
    minimizing that common finish time given the platform state.  Returns
    gamma [m] or None if the tiny LP fails (should not happen).

    The sub-LP is the shared schedule-LP IR in equal-finish mode: one cell of
    load ``n`` with the platform state injected as availability floors
    (``proc_free`` -> family (10), ``link_ready`` -> family (4')) and the
    Fig. 6 makespan family replaced by the participants' common-finish
    equalities — see :class:`repro_torch.lpir.EqualFinishView`.
    """
    m = inst.m
    if m == 1:
        return np.array([1.0])
    part = np.ones(m, dtype=bool) if participants is None else participants

    view = EqualFinishView(inst, n, proc_free, link_ready)
    ir = elide_dead_rows(emit_schedule_ir(view, equal_finish=part), granularity="row")
    c, A_ub, b_ub, A_eq, b_eq = lower_dense(ir)
    res = solve_simplex(c, A_ub, b_ub, A_eq, b_eq)
    if not res.ok:
        return None
    lay = ir.layout
    return np.maximum(res.x[lay.off_gamma : lay.off_gamma + m], 0.0)


def _max_chunk(
    inst: Instance,
    n: int,
    deadlines: np.ndarray,
    link_ready: np.ndarray,
    remaining: float,
) -> float | None:
    """MULTIINST chunk: the largest equal-compute-duration theta such that all
    chunk communications complete before each processor's deadline.  Returns
    theta (seconds of compute per processor) or None if infeasible."""
    m = inst.m
    vcomm, vcomp = inst.loads.v_comm[n], inst.loads.v_comp[n]
    rel = inst.loads.release[n]
    z, K = inst.chain.z, inst.chain.latency
    w = np.array([inst.w_of(i, n) for i in range(m)])
    inv_w = 1.0 / w
    # gamma_i = theta / (w_i * Vp); volume over link i = Vc * theta/Vp * sum_{k>i} 1/w_k
    A = (vcomm / vcomp) * np.array([inv_w[i + 1 :].sum() for i in range(m - 1)])

    # variables: theta, cs_0..cs_{m-2}
    nv = 1 + (m - 1)
    c = np.zeros(nv)
    c[0] = -1.0  # maximize theta
    Aub, bub = [], []
    for i in range(m - 1):
        row = np.zeros(nv)
        row[1 + i] = -1.0
        Aub.append(row)
        bub.append(-float(max(link_ready[i], rel if i == 0 else 0.0)))
        if i >= 1:
            row = np.zeros(nv)
            row[1 + i] = -1.0
            row[1 + i - 1] = 1.0
            row[0] = z[i - 1] * A[i - 1]
            Aub.append(row)
            bub.append(-float(K[i - 1]))
        # arrival deadline at P_{i+1}: cs_i + K_i + z_i A_i theta <= D_{i+1}
        row = np.zeros(nv)
        row[1 + i] = 1.0
        row[0] = z[i] * A[i]
        Aub.append(row)
        bub.append(float(deadlines[i + 1] - K[i]))
    # distributed fraction <= remaining: theta * sum(1/(w_i Vp)) <= remaining
    row = np.zeros(nv)
    row[0] = inv_w.sum() / vcomp
    Aub.append(row)
    bub.append(float(remaining))

    res = solve_simplex(c, np.array(Aub), np.array(bub))
    if not res.ok:
        return None
    return max(float(res.x[0]), 0.0)


# --------------------------------------------------------------------------
# the strategies
# --------------------------------------------------------------------------


def simple(inst: Instance) -> HeuristicResult:
    """SIMPLE: single installment, fractions proportional to processor speeds."""
    _require_chain(inst, "SIMPLE")
    m = inst.m
    cols = []
    for n in range(inst.N):
        speeds = np.array([1.0 / inst.w_of(i, n) for i in range(m)])
        cols.append(speeds / speeds.sum())
    return _finalize("SIMPLE", inst, [1] * inst.N, cols)


def single_load(inst: Instance) -> HeuristicResult:
    """SINGLELOAD [18]: per-load equal-finish with the time origin reset to the
    availability of the first link; downstream link availability ignored."""
    _require_chain(inst, "SINGLELOAD")
    m = inst.m
    st = _State(inst)
    cols = []
    for n in range(inst.N):
        origin = st.last_ce[0] if m > 1 else 0.0
        ready = np.full(max(m - 1, 0), origin)
        g = _equal_finish_load(inst, n, st.proc_free, ready)
        if g is None:
            return HeuristicResult("SINGLELOAD", None, None, None, True, f"load {n} LP failed")
        st.apply_cell(n, g)
        cols.append(g)
    return _finalize("SINGLELOAD", inst, [1] * inst.N, cols)


def single_inst(inst: Instance) -> HeuristicResult:
    """SINGLEINST: load-by-load equal-completion with full availability info."""
    _require_chain(inst, "SINGLEINST")
    st = _State(inst)
    cols = []
    for n in range(inst.N):
        g = _equal_finish_load(inst, n, st.proc_free, st.link_ready())
        if g is None:
            return HeuristicResult("SINGLEINST", None, None, None, True, f"load {n} LP failed")
        st.apply_cell(n, g)
        cols.append(g)
    return _finalize("SINGLEINST", inst, [1] * inst.N, cols)


def heuristic_b(inst: Instance) -> HeuristicResult:
    """HEURISTIC B (reconstruction): SINGLEINST over the best processor prefix."""
    _require_chain(inst, "HEURISTIC_B")
    m = inst.m
    st = _State(inst)
    cols = []
    for n in range(inst.N):
        best_g, best_T = None, np.inf
        for p in range(1, m + 1):
            part = np.zeros(m, dtype=bool)
            part[:p] = True
            g = _equal_finish_load(inst, n, st.proc_free, st.link_ready(), participants=part)
            if g is None:
                continue
            # evaluate this choice by tentative ASAP application
            tmp = _State(inst)
            tmp.last_ce = st.last_ce.copy()
            tmp.proc_free = st.proc_free.copy()
            tmp.apply_cell(n, g)
            T = tmp.proc_free.max()
            if T < best_T - _TOL:
                best_T, best_g = T, g
        if best_g is None:
            return HeuristicResult("HEURISTIC_B", None, None, None, True, f"load {n} failed")
        st.apply_cell(n, best_g)
        cols.append(best_g)
    return _finalize("HEURISTIC_B", inst, [1] * inst.N, cols)


def _dump_remainder(inst: Instance, n: int, st: "_State", remaining: float) -> np.ndarray:
    """MULTIINST-n's final installment: distribute all remaining work.

    Uses the equal-finish rule over the best processor prefix (as HEURISTIC B
    does per load), scaled to the remaining fraction; the 1-processor prefix
    (everything on P_1, no communication) is always feasible, so this never
    fails.
    """
    m = inst.m
    best_g, best_T = None, np.inf
    for p in range(1, m + 1):
        part = np.zeros(m, dtype=bool)
        part[:p] = True
        if p == 1:
            g = np.zeros(m)
            g[0] = 1.0
        else:
            g = _equal_finish_load(inst, n, st.proc_free, st.link_ready(), participants=part)
            if g is None:
                continue
        g = g * remaining  # scaled fractions only shorten every duration
        tmp = _State(inst)
        tmp.last_ce = st.last_ce.copy()
        tmp.proc_free = st.proc_free.copy()
        tmp.apply_cell(n, g)
        T = tmp.proc_free.max()
        if T < best_T - _TOL:
            best_T, best_g = T, g
    return best_g


def multi_inst(inst: Instance, cap: int | None = None, max_uncapped: int = 10_000) -> HeuristicResult:
    """MULTIINST (optionally capped at ``cap`` installments per load).

    Never raises on a well-formed chain instance: a construction that has no
    solution (paper §3.4 case 1, a chunk LP with an empty feasible set, more
    than ``max_uncapped`` installments) comes back as a ``failure ==
    "infeasible"`` result, and an unexpected exception inside the chunk /
    equal-finish LPs (pathological numerics) as ``failure == "error"`` — so
    a campaign sweep can classify every instance instead of aborting.
    """
    _require_chain(inst, "MULTIINST")
    name = f"MULTIINST_{cap}" if cap else "MULTIINST"
    try:
        return _multi_inst(inst, name, cap, max_uncapped)
    except Exception as e:  # construction blow-up -> structured error result
        return HeuristicResult(
            name, None, None, None, True,
            f"construction raised {type(e).__name__}: {e}", failure="error",
        )


def _multi_inst(inst: Instance, name: str, cap: int | None, max_uncapped: int) -> HeuristicResult:
    m = inst.m
    if m == 1:
        cols = [np.array([1.0]) for _ in range(inst.N)]
        return _finalize(name, inst, [1] * inst.N, cols)
    st = _State(inst)
    cols: list[np.ndarray] = []
    q: list[int] = []
    for n in range(inst.N):
        vcomp = inst.loads.v_comp[n]
        inv_w = np.array([1.0 / inst.w_of(i, n) for i in range(m)])
        if n == 0:
            # first load: single installment, equal finish (cf. §3: the first
            # load is sent in one installment)
            g = _equal_finish_load(inst, n, st.proc_free, st.link_ready())
            if g is None:
                return HeuristicResult(name, None, None, None, True, "load 0 LP failed")
            st.apply_cell(n, g)
            cols.append(g)
            q.append(1)
            continue
        remaining = 1.0
        k = 0
        load_cols: list[np.ndarray] = []
        while remaining > 1e-12:
            k += 1
            limit = cap if cap is not None else max_uncapped
            if cap is not None and k == cap:
                # dump the remainder (MULTIINST-n semantics)
                g = _dump_remainder(inst, n, st, remaining)
                st.apply_cell(n, g)
                load_cols.append(g)
                remaining = 0.0
                break
            theta = _max_chunk(inst, n, st.proc_free, st.link_ready(), remaining)
            if theta is None:
                if cap is not None:
                    # MULTIINST-n semantics: no further feasible installment —
                    # the last installment distributes all the remaining work
                    g = _dump_remainder(inst, n, st, remaining)
                    st.apply_cell(n, g)
                    load_cols.append(g)
                    remaining = 0.0
                    break
                return HeuristicResult(name, None, None, None, True, f"load {n} chunk LP failed")
            frac = theta * inv_w.sum() / vcomp
            if frac <= 1e-12:
                if cap is None:
                    return HeuristicResult(
                        name,
                        None,
                        None,
                        None,
                        True,
                        f"load {n}: installments cannot cover the load "
                        f"(remaining {remaining:.6f}) — paper §3.4 case 1",
                    )
                continue  # capped: keep iterating until the dump installment
            g = (theta / vcomp) * inv_w
            if frac >= remaining - 1e-12:
                g = remaining * inv_w / inv_w.sum()
                remaining = 0.0
            else:
                remaining -= frac
            st.apply_cell(n, g)
            load_cols.append(g)
            if k >= limit:
                if remaining > 1e-12:
                    if cap is None:
                        return HeuristicResult(
                            name, None, None, None, True, f"load {n}: >{limit} installments"
                        )
                    g = _dump_remainder(inst, n, st, remaining)
                    st.apply_cell(n, g)
                    load_cols.append(g)
                    remaining = 0.0
                break
        cols.extend(load_cols)
        q.append(len(load_cols))
    return _finalize(name, inst, q, cols)


ALL_HEURISTICS = {
    "SIMPLE": simple,
    "SINGLELOAD": single_load,
    "SINGLEINST": single_inst,
    "HEURISTIC_B": heuristic_b,
    "MULTIINST": multi_inst,
}


def run_strategy(name: str, fn, inst: Instance) -> HeuristicResult:
    """Run one strategy with the campaign's failure contract: never raises.

    Out-of-model instances (the chain-only guard's ``ValueError``) come back
    as ``failure == "unsupported"``, any other exception as ``failure ==
    "error"`` — both as resolved results so sweeps tally them instead of
    aborting.  Success and structured in-model failures pass through.
    """
    try:
        return fn(inst)
    except ValueError as e:  # chain-only guard: out of the strategy's model
        return HeuristicResult(name, None, None, None, True, str(e),
                               failure="unsupported")
    except Exception as e:  # unexpected blow-up inside the construction
        return HeuristicResult(name, None, None, None, True,
                               f"construction raised {type(e).__name__}: {e}",
                               failure="error")


def adversary_sweep(
    instances: list,
    strategies: dict | None = None,
    simulator: str = "batched",
    session=None,
) -> dict:
    """Evaluate every heuristic over a population of instances at once.

    The heuristics *construct* their fraction assignments serially (each is a
    chain of tiny per-load LPs), but the achieved makespans — the §6 campaign
    statistic — are measured in bulk: with ``simulator="batched"`` all
    (instance, gamma) pairs of a strategy are replayed through the session
    front door (``Session.evaluate_gammas`` — the batched ASAP replay on the
    session's device, the CUDA card by default) in a handful of fixed-shape
    batches instead of one NumPy replay per instance.  ``session`` is an
    optional :class:`repro_torch.api.Session` to share; the process-wide
    default is used otherwise.

    Returns ``{strategy: np.ndarray of makespans}`` (inf where the strategy
    failed — including star/return-phase instances, which every chain
    heuristic rejects), aligned with ``instances``.
    """
    strategies = dict(ALL_HEURISTICS) if strategies is None else strategies

    sess = None
    if simulator == "batched":
        from repro_torch.api import default_session  # deferred: keeps core torch-free

        sess = session if session is not None else default_session()

    out = {}
    for name, fn in strategies.items():
        results = [run_strategy(name, fn, inst) for inst in instances]
        mks = np.full(len(instances), np.inf)
        ok = [i for i, r in enumerate(results) if not r.failed]
        if ok and sess is not None:
            mks[ok] = sess.evaluate_gammas(
                [results[i].instance for i in ok], [results[i].gamma for i in ok]
            )
        elif ok:
            mks[ok] = [results[i].makespan for i in ok]
        out[name] = mks
    return out
