"""The schedule-LP intermediate representation: every constraint family
emitted exactly once, for every topology.

Before this package existed the paper's constraint families (1)-(10) were
written three times — sparse triplets in ``core/lp.py``, dense ``[B, R, n]``
bucket batches in ``engine/batched_lp.py``, and a per-load equal-finish copy
inside ``core/heuristics.py``.  Every §5 extension had to be implemented and
debugged three times.  Here the families are walked by ONE emitter,
:func:`emit_schedule_ir`, which produces a backend-neutral *row stream*; the
lowerers in :mod:`repro_torch.lpir.lower` turn that stream into whichever matrix
format a solver backend wants.

The emitter is also where topology lives: ``view.topology`` selects between
the paper's heterogeneous **chain** (Fig. 6) and the one-port-master **star**
(Marchal–Rehn–Robert–Vivien), and ``view.has_returns`` appends the
result-return phase (a third start-time variable block plus its precedence
families) to either.  A new scenario is written once, here, and inherited by
every backend.

The trick that lets a single emitter serve both the serial and the batched
builders is that every coefficient is obtained through a *view* (see
:mod:`repro_torch.lpir.views`): a view returns either a Python float (one
instance) or a ``[B]`` numpy vector (a whole packed bucket).  The emitter
only ever multiplies and negates coefficients, and numpy broadcasting makes
those operations agnostic to which of the two it is holding — so the row
stream is literally the same code path for both, with ``ir.batch`` recording
which flavour it carries.

Row stream format
-----------------

* a :class:`Row` is ``(kind, terms, rhs)`` with ``terms = [(col, coeff)]``
  meaning ``sum_j coeff_j * x_{col_j}  <=  rhs`` (ub rows) or ``== rhs``
  (eq rows); ``coeff``/``rhs`` are floats or ``[B]`` vectors;
* ``kind`` tags the family the row came from (see ``K_*`` below) so passes
  and tests can reason about provenance;
* variable columns follow :class:`VarLayout` — comm starts, comp starts,
  gamma, then (when the return phase is active) return starts, makespan,
  then optional completion-time variables.  Without returns the layout is
  bit-identical to the historical ``ScheduleLP``/``BatchedLP`` layouts, so
  extraction offsets are interchangeable across every backend.

Families emitted (paper numbering for the chain; DESIGN.md §6 for the rest):

  chain forward phase
  (1)   store-and-forward            ``comm(i,t)   >= comm_end(i-1,t)``
  (2b)/(3b) own-port serialization   ``comm(i,t)   >= comm_end(i,t-1)``
  (2)/(3) receive-after-forward      ``comm(i,t)   >= comm_end(i+1,t-1)``

  star forward phase (replaces the three above)
  (1*)  master one-port              ``comm(i,t)   >= comm_end(i-1,t)`` and
        ``comm(0,t) >= comm_end(m-2,t-1)`` — one total send order

  both topologies
  (4)   release dates                ``comm(0,t)   >= rel(t)``, ``comp(0,t) >= rel(t)``
  (4')  link availability floors     ``comm(i,0)   >= comm_floor(i)``  (zero on
        plain instances — this is how the heuristics' equal-finish sub-LP
        injects platform state; elided when zero)
  (6)   compute-after-receive        ``comp(i,t)   >= comm_end(i-1,t)``
        (link i-1 feeds P_i in both topologies; only ``comm_end``'s volume
        terms differ — suffix on the chain, own fraction on the star)
  (8)/(9) compute serialization      ``comp(i,t)   >= comp_end(i,t-1)``
  (10)  availability dates           ``comp(i,0)   >= tau(i)``
  (12)  completeness (eq)            ``sum_{i,t: load(t)=n} gamma(i,t) == 1``
  (13)  makespan                     ``mk >= comp_end(i,T-1)`` — or, in
        equal-finish mode, ``comp_end(i,T-1) == mk`` for participants and
        ``gamma(i,t) == 0`` for non-participants
  (§5)  completion-time variables    ``C_n >= comp_end(i, last cell of n)``

  result-return phase (when ``view.has_returns``)
  (R6)  results exist after compute  ``ret(i,t)    >= comp_end(i+1,t)``
  (R1)  chain backward forwarding    ``ret(i,t)    >= ret_end(i+1,t)``
  (R2b) chain per-link serialization ``ret(i,t)    >= ret_end(i,t-1)``
  (R1*) star master receive port     ``ret(i,t)    >= ret_end(i-1,t)`` and
        ``ret(0,t) >= ret_end(m-2,t-1)``
  (R13) makespan covers returns      ``mk >= ret_end(i,T-1)``
  (R§5) completion covers returns    ``C_n >= ret_end(i, last cell of n)``

Dead-row elision (:func:`elide_dead_rows`) drops the single-variable floor
families whose right-hand side is identically zero — they reduce to
``x >= 0``, which the standard form already enforces.  ``granularity="row"``
reproduces the serial builder's per-cell behaviour; ``granularity="family"``
reproduces the batched builder's bucket-wide decision (the row count must
stay batch-constant, so a family is only dropped when NO instance in the
bucket activates ANY of its rows).  The elidable set is topology-independent
because every precedence family — including the star's one-port rows and the
whole return phase — is multi-variable and therefore never elidable; only
the four floor families qualify, on either topology.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Row",
    "VarLayout",
    "ScheduleIR",
    "emit_schedule_ir",
    "elide_dead_rows",
    "ELIDABLE_KINDS",
    "K_STORE_FORWARD",
    "K_OWN_PORT",
    "K_RECV_AFTER_FWD",
    "K_MASTER_PORT",
    "K_RELEASE_COMM",
    "K_RELEASE_COMP",
    "K_LINK_AVAIL",
    "K_COMPUTE_AFTER_RECV",
    "K_COMP_SERIAL",
    "K_AVAIL",
    "K_COMPLETENESS",
    "K_MAKESPAN",
    "K_MAKESPAN_RET",
    "K_EQUAL_FINISH",
    "K_GAMMA_ZERO",
    "K_COMPLETION",
    "K_RET_AFTER_COMP",
    "K_RET_STORE_FORWARD",
    "K_RET_SERIAL",
    "K_RET_PORT",
]

# constraint-family tags (paper numbering in the docstring above)
K_STORE_FORWARD = "store_forward"  # (1), chain
K_OWN_PORT = "own_port"  # (2b)/(3b), chain
K_RECV_AFTER_FWD = "recv_after_fwd"  # (2)/(3), chain
K_MASTER_PORT = "master_port"  # (1*), star one-port send serialization
K_RELEASE_COMM = "release_comm"  # (4) on comm starts
K_RELEASE_COMP = "release_comp"  # (4) on comp starts
K_LINK_AVAIL = "link_avail"  # (4') platform link floors
K_COMPUTE_AFTER_RECV = "compute_after_recv"  # (6)
K_COMP_SERIAL = "comp_serial"  # (8)/(9)
K_AVAIL = "avail"  # (10)
K_COMPLETENESS = "completeness"  # (12), equality
K_MAKESPAN = "makespan"  # (13)
K_MAKESPAN_RET = "makespan_ret"  # (R13) makespan covers return arrivals
K_EQUAL_FINISH = "equal_finish"  # equal-finish variant of (13), equality
K_GAMMA_ZERO = "gamma_zero"  # non-participant pin, equality
K_COMPLETION = "completion"  # §5 completion-time rows
K_RET_AFTER_COMP = "ret_after_comp"  # (R6) results exist after compute
K_RET_STORE_FORWARD = "ret_store_forward"  # (R1), chain backward forwarding
K_RET_SERIAL = "ret_serial"  # (R2b), chain per-link return serialization
K_RET_PORT = "ret_port"  # (R1*), star receive-port serialization

# single-variable floor families: their rows are ``x >= rhs`` and become the
# standard form's ``x >= 0`` when rhs == 0, hence safely removable.  Every
# topology-specific precedence family (chain, star, return phase) is
# multi-variable, so this set needs no topology dispatch.
ELIDABLE_KINDS = frozenset(
    {K_RELEASE_COMM, K_RELEASE_COMP, K_LINK_AVAIL, K_AVAIL}
)


@dataclasses.dataclass
class Row:
    """One constraint row: ``sum(coeff * x[col] for col, coeff in terms) (<=|==) rhs``."""

    kind: str
    terms: list  # [(col, coeff)] — coeff is float or [B] ndarray
    rhs: object  # float or [B] ndarray


@dataclasses.dataclass(frozen=True)
class VarLayout:
    """Column layout shared by every lowering.

    Without a return phase this matches the historical builders exactly:
    comm starts, comp starts, gamma, makespan, optional completion vars.
    With returns, the return-start block slots in between gamma and the
    makespan (``off_ret``; -1 when absent).
    """

    m: int
    T: int
    off_comm: int
    off_comp: int
    off_gamma: int
    off_mk: int
    off_cn: int  # -1 when completion-time variables are absent
    n_vars: int
    off_ret: int = -1  # -1 when the return phase is absent

    def comm(self, i: int, t: int) -> int:
        return self.off_comm + i * self.T + t

    def comp(self, i: int, t: int) -> int:
        return self.off_comp + i * self.T + t

    def gam(self, i: int, t: int) -> int:
        return self.off_gamma + i * self.T + t

    def ret(self, i: int, t: int) -> int:
        return self.off_ret + i * self.T + t


@dataclasses.dataclass
class ScheduleIR:
    """The emitter's output: a solver-agnostic LP in row-stream form."""

    layout: VarLayout
    ub_rows: list  # [Row] — `terms <= rhs`
    eq_rows: list  # [Row] — `terms == rhs`
    c: np.ndarray  # [n_vars] objective (batch-constant by construction)
    batch: int | None  # None => scalar coefficients; B => [B] coefficients
    n_loads: int

    @property
    def n_vars(self) -> int:
        return self.layout.n_vars


def _layout_for(m: int, T: int, n_loads: int, want_cn: bool, want_ret: bool) -> VarLayout:
    n_comm = max(m - 1, 0) * T
    n_comp = m * T
    off_comm = 0
    off_comp = n_comm
    off_gamma = n_comm + n_comp
    off_ret = off_gamma + m * T if want_ret else -1
    off_mk = off_gamma + m * T + (n_comm if want_ret else 0)
    off_cn = off_mk + 1 if want_cn else -1
    n_vars = off_mk + 1 + (n_loads if want_cn else 0)
    return VarLayout(
        m=m, T=T, off_comm=off_comm, off_comp=off_comp, off_gamma=off_gamma,
        off_mk=off_mk, off_cn=off_cn, n_vars=n_vars, off_ret=off_ret,
    )


def emit_schedule_ir(
    view,
    objective: str = "makespan",
    weights=None,
    beta: float = 0.0,
    equal_finish=None,
) -> ScheduleIR:
    """Walk the constraint families once over ``view``.

    ``view`` is any object satisfying the coefficient protocol of
    :mod:`repro_torch.lpir.views` (``m``, ``T``, ``batch``, ``load_of_cell``,
    ``n_loads``, ``topology``, ``has_returns`` plus the accessors
    ``z/K/tau/comm_floor/vcomm/vcomp/rel/ret/w``).

    ``equal_finish`` (bool [m] or None) switches the (13) makespan family
    into the equal-finish mode the [18]/[19] heuristics are built on: the
    makespan variable becomes the participants' common completion time
    (equality rows) and non-participants' fractions are pinned to zero.
    """
    m, T = view.m, view.T
    topology = getattr(view, "topology", "chain")
    if topology not in ("chain", "star"):
        raise ValueError(f"unknown topology {topology!r}")
    star = topology == "star"
    want_ret = bool(getattr(view, "has_returns", False)) and m > 1
    want_cn = objective == "completion"
    if equal_finish is not None:
        if want_cn:
            raise ValueError("equal_finish only applies to the makespan objective")
        if want_ret:
            raise ValueError("equal_finish mode has no return phase (chain heuristics only)")
    lay = _layout_for(m, T, view.n_loads, want_cn, want_ret)
    ub: list[Row] = []
    eq: list[Row] = []

    def _msg_end_terms(start_col: int, i: int, t: int, coef):
        """A link-i message end as (linear terms, constant): start + K_i +
        coef * vol(i, t), where vol is the topology's link volume — the
        worker's own fraction on a star, the forwarded suffix on a chain.
        One helper for both phases so the volume structure exists once."""
        terms = [(start_col, 1.0)]
        if star:  # link i carries only worker i+1's own fraction
            terms.append((lay.gam(i + 1, t), coef))
        else:  # chain link i forwards the whole suffix
            for k in range(i + 1, m):
                terms.append((lay.gam(k, t), coef))
        return terms, view.K(i)

    def comm_end_terms(i: int, t: int):
        """comm_end(i, t) — K_i + z_i V_comm vol."""
        return _msg_end_terms(lay.comm(i, t), i, t, view.z(i) * view.vcomm(t))

    def ret_end_terms(i: int, t: int):
        """ret_end(i, t): the forward message mirrored with the return ratio."""
        return _msg_end_terms(
            lay.ret(i, t), i, t, view.z(i) * view.vcomm(t) * view.ret(t)
        )

    def comp_end_terms(i: int, t: int):
        return [(lay.comp(i, t), 1.0), (lay.gam(i, t), view.w(i, t) * view.vcomp(t))], 0.0

    def ge(kind, lhs_terms, rhs_terms, rhs_const):
        """lhs >= rhs + const  ->  -(lhs) + rhs <= -const."""
        terms = [(col, -cf) for col, cf in lhs_terms] + rhs_terms
        ub.append(Row(kind=kind, terms=terms, rhs=-rhs_const))

    for t in range(T):
        for i in range(m - 1):
            if star:
                if i >= 1:  # (1*) master one-port, within the cell
                    rt, rc = comm_end_terms(i - 1, t)
                    ge(K_MASTER_PORT, [(lay.comm(i, t), 1.0)], rt, rc)
                elif t >= 1:  # (1*) master one-port, across cells
                    rt, rc = comm_end_terms(m - 2, t - 1)
                    ge(K_MASTER_PORT, [(lay.comm(0, t), 1.0)], rt, rc)
            else:
                if i >= 1:  # (1) store-and-forward
                    rt, rc = comm_end_terms(i - 1, t)
                    ge(K_STORE_FORWARD, [(lay.comm(i, t), 1.0)], rt, rc)
                if t >= 1:
                    rt, rc = comm_end_terms(i, t - 1)  # (2b)/(3b) own-port
                    ge(K_OWN_PORT, [(lay.comm(i, t), 1.0)], rt, rc)
                    if i + 1 <= m - 2:  # (2)/(3) receive-after-forward
                        rt, rc = comm_end_terms(i + 1, t - 1)
                        ge(K_RECV_AFTER_FWD, [(lay.comm(i, t), 1.0)], rt, rc)
            if i == 0:  # (4) release dates on the first link
                ge(K_RELEASE_COMM, [(lay.comm(0, t), 1.0)], [], view.rel(t))
            if t == 0:  # (4') link availability floors (platform state)
                ge(K_LINK_AVAIL, [(lay.comm(i, 0), 1.0)], [], view.comm_floor(i))
        for i in range(m):
            if i >= 1:  # (6) compute after the corresponding receive
                rt, rc = comm_end_terms(i - 1, t)
                ge(K_COMPUTE_AFTER_RECV, [(lay.comp(i, t), 1.0)], rt, rc)
            if t >= 1:  # (8)/(9) compute serialization
                rt, rc = comp_end_terms(i, t - 1)
                ge(K_COMP_SERIAL, [(lay.comp(i, t), 1.0)], rt, rc)
            if t == 0:  # (10) availability dates
                ge(K_AVAIL, [(lay.comp(i, 0), 1.0)], [], view.tau(i))
            if i == 0:  # (4) release dates on the source processor
                ge(K_RELEASE_COMP, [(lay.comp(0, t), 1.0)], [], view.rel(t))

    # ---- result-return phase ----
    if want_ret:
        for t in range(T):
            for i in range(m - 1):
                # (R6) results exist only after P_{i+1} computes
                rt, rc = comp_end_terms(i + 1, t)
                ge(K_RET_AFTER_COMP, [(lay.ret(i, t), 1.0)], rt, rc)
                if star:
                    if i >= 1:  # (R1*) master receive port, within the cell
                        rt, rc = ret_end_terms(i - 1, t)
                        ge(K_RET_PORT, [(lay.ret(i, t), 1.0)], rt, rc)
                    elif t >= 1:  # (R1*) across cells
                        rt, rc = ret_end_terms(m - 2, t - 1)
                        ge(K_RET_PORT, [(lay.ret(0, t), 1.0)], rt, rc)
                else:
                    if i + 1 <= m - 2:  # (R1) backward store-and-forward
                        rt, rc = ret_end_terms(i + 1, t)
                        ge(K_RET_STORE_FORWARD, [(lay.ret(i, t), 1.0)], rt, rc)
                    if t >= 1:  # (R2b) per-link return serialization
                        rt, rc = ret_end_terms(i, t - 1)
                        ge(K_RET_SERIAL, [(lay.ret(i, t), 1.0)], rt, rc)

    # (12) completeness — one equality per load, in load order
    load_of_cell = list(view.load_of_cell)
    for n in range(view.n_loads):
        terms = [
            (lay.gam(i, t), 1.0)
            for t in range(T)
            if load_of_cell[t] == n
            for i in range(m)
        ]
        eq.append(Row(kind=K_COMPLETENESS, terms=terms, rhs=1.0))

    # (13) makespan — or its equal-finish variant
    if equal_finish is None:
        for i in range(m):
            rt, rc = comp_end_terms(i, T - 1)
            ge(K_MAKESPAN, [(lay.off_mk, 1.0)], rt, rc)
        if want_ret:
            # (R13): the serialization families make ret_end(i, .) monotone
            # in t on both topologies, so covering the last cell covers all
            for i in range(m - 1):
                rt, rc = ret_end_terms(i, T - 1)
                ge(K_MAKESPAN_RET, [(lay.off_mk, 1.0)], rt, rc)
    else:
        part = np.asarray(equal_finish, dtype=bool)
        if part.shape != (m,):
            raise ValueError(f"equal_finish must be bool [m={m}], got {part.shape}")
        for i in range(m):
            if part[i]:
                rt, rc = comp_end_terms(i, T - 1)
                eq.append(Row(
                    kind=K_EQUAL_FINISH,
                    terms=rt + [(lay.off_mk, -1.0)],
                    rhs=-rc,
                ))
            else:
                for t in range(T):
                    eq.append(Row(kind=K_GAMMA_ZERO, terms=[(lay.gam(i, t), 1.0)], rhs=0.0))

    # §5 completion-time variables
    if want_cn:
        last_cell = {n: t for t, n in enumerate(load_of_cell)}
        for n in range(view.n_loads):
            for i in range(m):
                rt, rc = comp_end_terms(i, last_cell[n])
                ge(K_COMPLETION, [(lay.off_cn + n, 1.0)], rt, rc)
            if want_ret:
                for i in range(m - 1):
                    rt, rc = ret_end_terms(i, last_cell[n])
                    ge(K_COMPLETION, [(lay.off_cn + n, 1.0)], rt, rc)

    # objective
    c = np.zeros(lay.n_vars)
    if objective == "makespan":
        c[lay.off_mk] = 1.0
    elif objective == "completion":
        w = np.ones(view.n_loads) if weights is None else np.asarray(weights, dtype=np.float64)
        c[lay.off_cn : lay.off_cn + view.n_loads] = w
        # with beta == 0 keep the makespan tied down so solutions stay
        # interpretable (same convention as the historical builder)
        c[lay.off_mk] = beta if beta != 0.0 else 1e-9
    else:
        raise ValueError(objective)

    return ScheduleIR(
        layout=lay, ub_rows=ub, eq_rows=eq, c=c, batch=view.batch,
        n_loads=view.n_loads,
    )


def _all_zero(rhs) -> bool:
    return bool(np.all(np.asarray(rhs) == 0.0))


def elide_dead_rows(ir: ScheduleIR, granularity: str = "row") -> ScheduleIR:
    """Drop floor rows that reduce to ``x >= 0`` (implied by the standard form).

    ``granularity="row"``   — drop each all-zero floor row individually (the
                              serial builder's historical per-cell behaviour);
    ``granularity="family"`` — drop a floor family only when EVERY one of its
                              rows is all-zero across the whole batch (the
                              batched builder's bucket-wide decision; keeps
                              the row count batch-constant, and guarantees
                              the elision never fires when any instance in
                              the bucket has a nonzero date in the family).
    """
    if granularity == "row":
        keep = [
            r for r in ir.ub_rows
            if not (r.kind in ELIDABLE_KINDS and _all_zero(r.rhs))
        ]
    elif granularity == "family":
        live_kinds = {
            r.kind for r in ir.ub_rows
            if r.kind in ELIDABLE_KINDS and not _all_zero(r.rhs)
        }
        keep = [
            r for r in ir.ub_rows
            if r.kind not in ELIDABLE_KINDS or r.kind in live_kinds
        ]
    else:
        raise ValueError(granularity)
    return dataclasses.replace(ir, ub_rows=keep)
