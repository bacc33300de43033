"""Schedule objects and the feasibility checker (paper §2 / Fig. 6 semantics,
generalized over the :class:`repro_torch.core.instance.Topology` families).

A :class:`Schedule` stores, for every cell ``t`` (a (load, installment) pair in
the fixed lexicographic distribution order):

* ``gamma[i, t]``      fraction of load ``n_t`` processed by ``P_i`` in that cell,
* ``comm_start/comm_end[i, t]``  times of the link-``i`` message of cell ``t``,
* ``comp_start/comp_end[i, t]``  times of ``P_i``'s computation of cell ``t``,
* ``ret_start/ret_end[i, t]``    (optional) times of the link-``i``
  result-return message of cell ``t`` — present exactly when the instance
  activates the return phase (``Instance.has_returns``).

Link semantics are topology-dispatched:

* **chain** — link ``i`` carries the *suffix* volume ``sum_{k>i} gamma[k,t]``
  forward (store-and-forward) and, in the return phase, the same suffix of
  result volume backward;
* **star** — link ``i`` is the master's private channel to worker ``i+1``:
  it carries only ``gamma[i+1, t]`` forward and ``gamma[i+1, t]`` of result
  volume back.

``check_feasible`` verifies *every* constraint family of the matching
topology — the chain's (1)-(13) of Fig. 6 (plus the explicit own-port
serialization, which the paper leaves implicit and which is required for
m=2), or the star's one-port master families — plus the return-phase
precedences, so any schedule accepted here is executable on the platform
model.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .instance import Instance

__all__ = [
    "Schedule",
    "check_feasible",
    "comm_durations",
    "comp_durations",
    "ret_durations",
]


@dataclasses.dataclass
class Schedule:
    instance: Instance
    gamma: np.ndarray  # [m, T]
    comm_start: np.ndarray  # [m-1, T]
    comm_end: np.ndarray  # [m-1, T]
    comp_start: np.ndarray  # [m, T]
    comp_end: np.ndarray  # [m, T]
    makespan: float
    ret_start: np.ndarray | None = None  # [m-1, T] when the return phase is on
    ret_end: np.ndarray | None = None  # [m-1, T]

    @property
    def cells(self):
        return list(self.instance.cells())

    def load_fractions(self, n: int) -> np.ndarray:
        """Total fraction of load ``n`` processed per processor, [m]."""
        cols = [t for t, (ln, _) in enumerate(self.instance.cells()) if ln == n]
        return self.gamma[:, cols].sum(axis=1)

    def completion_time(self, n: int) -> float:
        cols = [t for t, (ln, _) in enumerate(self.instance.cells()) if ln == n]
        done = float(self.comp_end[:, cols].max())
        if self.ret_end is not None and self.ret_end.size:
            done = max(done, float(self.ret_end[:, cols].max()))
        return done

    def idle_fraction(self) -> float:
        """Fraction of processor-time idle before the makespan (diagnostic)."""
        busy = (self.comp_end - self.comp_start).sum()
        total = self.makespan * self.instance.m
        return float(1.0 - busy / total) if total > 0 else 0.0


def _link_volumes(inst: Instance, gamma: np.ndarray) -> np.ndarray:
    """[m-1, T] data volume fractions carried by each link, per topology.

    chain: suffix sums ``sum_{k>i} gamma[k,t]`` (store-and-forward);
    star:  the worker's own fraction ``gamma[i+1, t]``.
    """
    if inst.topology == "star":
        return gamma[1:, :]
    suffix = np.cumsum(gamma[::-1], axis=0)[::-1]  # suffix[i] = sum_{k>=i}
    return suffix[1:, :]


def comm_durations(inst: Instance, gamma: np.ndarray) -> np.ndarray:
    """[m-1, T] message durations: K_i + z_i * V_comm(n_t) * vol(i, t).

    ``vol`` is the topology-dispatched link volume (see :func:`_link_volumes`).
    Latency convention: every (link, cell) message incurs its startup cost
    ``K_i`` whether or not its volume is zero — this matches the paper's
    rho = ((m-1) Q K + V) / V accounting in §5 and keeps the model linear.
    """
    m = inst.m
    cells = list(inst.cells())
    T = len(cells)
    out = np.zeros((max(m - 1, 0), T))
    if m == 1:
        return out
    vcomm = np.array([inst.loads.v_comm[n] for n, _ in cells])
    vol = _link_volumes(inst, gamma)
    for i in range(m - 1):
        out[i] = inst.platform.z[i] * vcomm * vol[i] + inst.platform.latency[i]
    return out


def ret_durations(inst: Instance, gamma: np.ndarray) -> np.ndarray:
    """[m-1, T] result-return message durations.

    The return message on link ``i`` for cell ``t`` mirrors the forward one
    with the per-load return ratio as an extra volume factor:
    ``K_i + z_i * r(n_t) * V_comm(n_t) * vol(i, t)``.  Only meaningful when
    ``inst.has_returns``; like the forward phase, every (link, cell) return
    message pays its startup latency ``K_i``.
    """
    m = inst.m
    cells = list(inst.cells())
    T = len(cells)
    out = np.zeros((max(m - 1, 0), T))
    if m == 1:
        return out
    rv = np.array(
        [inst.loads.return_ratio[n] * inst.loads.v_comm[n] for n, _ in cells]
    )
    vol = _link_volumes(inst, gamma)
    for i in range(m - 1):
        out[i] = inst.platform.z[i] * rv * vol[i] + inst.platform.latency[i]
    return out


def comp_durations(inst: Instance, gamma: np.ndarray) -> np.ndarray:
    """[m, T] computation durations: w_i(n_t) * V_comp(n_t) * gamma[i, t]."""
    cells = list(inst.cells())
    T = len(cells)
    out = np.zeros((inst.m, T))
    for t, (n, _) in enumerate(cells):
        for i in range(inst.m):
            out[i, t] = inst.w_of(i, n) * inst.loads.v_comp[n] * gamma[i, t]
    return out


def check_feasible(sched: Schedule, tol: float = 1e-6, require_complete: bool = True) -> list[str]:
    """Return a list of violated-constraint descriptions (empty == feasible).

    Checks every constraint family of the instance's topology — the chain's
    Fig. 6 (1)-(13) plus own-port serialization, or the star's one-port
    master precedences — plus the result-return families when the instance
    activates them.  ``tol`` is absolute, scaled by the makespan magnitude.
    """
    inst = sched.instance
    m, cells = inst.m, list(inst.cells())
    T = len(cells)
    star = inst.topology == "star"
    g = sched.gamma
    scale = max(abs(sched.makespan), 1.0)
    atol = tol * scale
    errs: list[str] = []

    def req(ok: bool, msg: str):
        if not ok:
            errs.append(msg)

    # (11) nonnegative fractions
    req(bool((g >= -tol).all()), f"(11) negative gamma: min={g.min():.3e}")
    # (12) completeness
    if require_complete:
        for n in range(inst.N):
            s = sched.load_fractions(n).sum()
            req(abs(s - 1.0) <= 1e-6, f"(12) load {n} fractions sum to {s:.9f} != 1")

    dcomm = comm_durations(inst, g)
    dcomp = comp_durations(inst, g)

    # (5)/(7): durations consistent with start/end
    if m > 1:
        req(
            bool(np.allclose(sched.comm_end, sched.comm_start + dcomm, atol=atol)),
            "(5) comm_end != comm_start + duration",
        )
    req(
        bool(np.allclose(sched.comp_end, sched.comp_start + dcomp, atol=atol)),
        "(7) comp_end != comp_start + duration",
    )

    cs, ce = sched.comm_start, sched.comm_end
    ps, pe = sched.comp_start, sched.comp_end
    rel = np.array([inst.loads.release[n] for n, _ in cells])

    # (4) + release dates
    if m > 1:
        req(bool((cs >= -atol).all()), "(4) negative comm start")
        req(bool((cs[0] >= rel - atol).all()), "(4r) comm before load release")
    req(bool((ps[0] >= rel - atol).all()), "(4r) P_0 computes before load release")

    for t in range(T):
        for i in range(m - 1):
            if star:
                # one-port master: all sends serialize in the fixed order
                # (cells lexicographic, workers in index order within a cell)
                if i >= 1:
                    req(cs[i, t] >= ce[i - 1, t] - atol,
                        f"(1*) master port: send {i} cell {t} overlaps send {i - 1}")
                elif t >= 1:
                    req(cs[0, t] >= ce[m - 2, t - 1] - atol,
                        f"(1*) master port: cell {t} starts before cell {t - 1} sent")
            else:
                # (1) store-and-forward
                if i >= 1:
                    req(cs[i, t] >= ce[i - 1, t] - atol,
                        f"(1) link {i} cell {t} starts before upstream done")
                if t >= 1:
                    # own-port serialization (implicit in the paper, explicit here)
                    req(cs[i, t] >= ce[i, t - 1] - atol,
                        f"(2b) link {i} cell {t} overlaps previous send")
                    # (2)/(3) receive-after-forward
                    if i + 1 <= m - 2:
                        req(cs[i, t] >= ce[i + 1, t - 1] - atol,
                            f"(2/3) link {i} cell {t} before P recv free")
        for i in range(m):
            # (6) compute after receive — link i-1 feeds P_i in both topologies
            if i >= 1 and m > 1:
                req(ps[i, t] >= ce[i - 1, t] - atol, f"(6) P{i} cell {t} computes before data arrives")
            # (8)/(9) compute serialization
            if t >= 1:
                req(ps[i, t] >= pe[i, t - 1] - atol, f"(8/9) P{i} cell {t} compute overlap")
            # (10) availability
            if t == 0:
                req(ps[i, 0] >= inst.platform.tau[i] - atol, f"(10) P{i} computes before tau")
    # (13) makespan covers every completion
    req(bool((pe <= sched.makespan + atol).all()), "(13) makespan smaller than a completion time")

    # ---- result-return phase ----
    if inst.has_returns and m > 1:
        rs, re = sched.ret_start, sched.ret_end
        if rs is None or re is None:
            errs.append("(R) instance has returns but the schedule carries none")
            return errs
        dret = ret_durations(inst, g)
        req(bool(np.allclose(re, rs + dret, atol=atol)), "(R5) ret_end != ret_start + duration")
        req(bool((rs >= -atol).all()), "(R) negative return start")
        for t in range(T):
            for i in range(m - 1):
                # results exist only after the adjacent processor computes
                req(rs[i, t] >= pe[i + 1, t] - atol,
                    f"(R6) return {i} cell {t} starts before P{i + 1} done")
                if star:
                    # master receive port serializes returns in the fixed order
                    if i >= 1:
                        req(rs[i, t] >= re[i - 1, t] - atol,
                            f"(R1*) return port: msg {i} cell {t} overlaps msg {i - 1}")
                    elif t >= 1:
                        req(rs[0, t] >= re[m - 2, t - 1] - atol,
                            f"(R1*) return port: cell {t} before cell {t - 1} returned")
                else:
                    # backward store-and-forward + per-link serialization
                    if i + 1 <= m - 2:
                        req(rs[i, t] >= re[i + 1, t] - atol,
                            f"(R1) return {i} cell {t} before downstream returned")
                    if t >= 1:
                        req(rs[i, t] >= re[i, t - 1] - atol,
                            f"(R2b) return {i} cell {t} overlaps previous return")
        req(bool((re <= sched.makespan + atol).all()),
            "(R13) makespan smaller than a return completion")
    return errs
