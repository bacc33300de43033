"""Per-instance LP-vs-heuristic outcome classification.

Each campaign instance is solved two ways — through the Session LP (the
paper's approach) and through every §3 strategy (SIMPLE, SINGLELOAD [18],
SINGLEINST / MULTIINST [19], HEURISTIC B) — and the pair of results is
bucketed into exactly one of :data:`CLASSES`:

* ``lp-wins``      — the best feasible heuristic is strictly worse than the
                     LP makespan (beyond ``rtol``);
* ``tie``          — the best feasible heuristic matches the LP within
                     ``rtol`` (the LP never loses, so "match" is a tie);
* ``heuristic-infeasible`` — no strategy produced a feasible schedule:
                     every applicable one failed (paper §3.4 case 1 — the
                     motivating regime) or none applies (star platforms are
                     outside the [18]/[19] chain model);
* ``lp-fallback``  — the LP plan was served off the requested backend
                     (``PlanArtifact.events`` non-empty), outcome otherwise
                     ordinary;
* ``anomaly``      — the invariant broke: the LP failed or produced an
                     infeasible schedule on a feasible instance, or a
                     feasible heuristic strictly beat the LP *even at the
                     heuristic's own installment structure*.

Anomaly candidates are verified lazily, because "heuristic < grid LP" alone
is not a bug: the grid solves at the cell's ``q`` while e.g. MULTIINST
chooses its own (often much finer) per-load installment counts, and the LP
bound only says LP(q) <= any feasible schedule *with structure q*.  A
candidate therefore triggers (1) :func:`repro_torch.core.schedule.check_feasible`
on the heuristic's schedule — a fabricated makespan is reclassified as a
failed strategy, not an anomaly — and (2) an exact re-solve at the
heuristic's installment structure through ``matched_solve`` (a serial
backend; no shape compilation), with ``effective_lp = min(grid LP, matched
solves)`` and the artifact-level :meth:`PlanArtifact.diff` recorded as
evidence.  Only a feasible heuristic below ``effective_lp`` beyond ``rtol``
is an anomaly — and that is a hard failure of the whole campaign.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.keys import instance_content_key
from repro_torch.core.schedule import check_feasible

__all__ = ["CLASSES", "Classification", "classify_instance"]

CLASSES = ("lp-wins", "tie", "heuristic-infeasible", "lp-fallback", "anomaly")

# feasibility tolerance for replayed schedules (matches the fuzz suite's
# absolute scale; the classifier's own comparisons use spec.rtol)
FEAS_TOL = 1e-6


def _f(x):
    """JSON-safe float: finite -> float, None/NaN/inf -> None."""
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


@dataclasses.dataclass
class Classification:
    """One instance's verdict + the evidence behind it (JSON-safe)."""

    cell_id: str
    index: int
    content_key: str
    label: str
    lp_makespan: float | None  # the grid LP (cell's q)
    effective_lp: float | None  # min(grid LP, matched re-solves)
    best_strategy: str | None  # best *feasible* heuristic
    best_makespan: float | None
    ratio: float | None  # best_makespan / effective_lp
    strategies: dict  # name -> {makespan, failure, violations}
    lp_events: list  # event kinds from the serving artifact
    matched: dict  # strategy -> matched-LP makespan (verified candidates)
    anomaly: dict | None  # evidence when label == "anomaly"

    def to_dict(self) -> dict:
        return {
            "cell_id": self.cell_id,
            "index": self.index,
            "content_key": self.content_key,
            "label": self.label,
            "lp_makespan": _f(self.lp_makespan),
            "effective_lp": _f(self.effective_lp),
            "best_strategy": self.best_strategy,
            "best_makespan": _f(self.best_makespan),
            "ratio": _f(self.ratio),
            "strategies": self.strategies,
            "lp_events": list(self.lp_events),
            "matched": {k: _f(v) for k, v in sorted(self.matched.items())},
            "anomaly": self.anomaly,
        }


def _total_installments(result) -> int:
    inst = result.instance
    if inst is None:
        return 0
    return int(sum(inst.q)) if not isinstance(inst.q, int) else int(inst.q) * inst.N


def classify_instance(
    inst,
    artifact,
    heuristics,
    *,
    rtol: float = 1e-9,
    matched_solve=None,
    matched_t_cap: int = 64,
    cell_id: str = "",
    index: int = 0,
) -> Classification:
    """Bucket one (LP artifact, heuristic results) pair into a class.

    ``heuristics`` is a list of resolved :class:`HeuristicResult`s (run
    through :func:`repro_torch.core.heuristics.run_strategy`, so out-of-model and
    crashed strategies arrive as structured failures).  ``matched_solve``
    is an ``Instance -> PlanArtifact`` callable used only to verify anomaly
    candidates at the heuristic's exact installment structure; pass None to
    skip matched verification (the grid LP then stands as ``effective_lp``).
    """
    lp_ok = bool(artifact is not None and artifact.ok)
    lp_mk = _f(artifact.makespan) if lp_ok else None
    lp_events = [str(e.get("kind", "?")) for e in (artifact.events if artifact is not None else ())]

    # -- heuristic side: feasibility-check every claimed schedule ----------
    strategies: dict = {}
    feasible: list = []  # (makespan, name, result)
    for r in heuristics:
        entry = {"failure": r.failure, "makespan": None, "violations": 0}
        if not r.failed and r.schedule is not None:
            viol = check_feasible(r.schedule, tol=FEAS_TOL)
            entry["violations"] = len(viol)
            if viol:
                # a fabricated schedule is a failed strategy, not a bound
                entry["failure"] = "infeasible"
            else:
                entry["makespan"] = _f(r.schedule.makespan)
                feasible.append((entry["makespan"], r.name, r))
        strategies[r.name] = entry
    feasible.sort(key=lambda t: (t[0], t[1]))
    best_mk, best_name = (feasible[0][0], feasible[0][1]) if feasible else (None, None)

    # -- LP self-check: its own schedule must satisfy every constraint -----
    lp_violations: list = []
    if lp_ok:
        lp_violations = check_feasible(artifact.schedule(), tol=FEAS_TOL)

    # -- lazy anomaly verification ----------------------------------------
    effective_lp = lp_mk
    matched: dict = {}
    anomaly = None
    if lp_ok and not lp_violations and best_mk is not None and effective_lp is not None:
        scale = max(abs(effective_lp), abs(best_mk), 1e-300)
        for mk, name, r in feasible:
            if mk >= effective_lp - rtol * scale:
                break  # sorted: nothing further can beat the LP
            if matched_solve is None or _total_installments(r) > matched_t_cap:
                continue
            art2 = matched_solve(r.instance)
            if art2 is not None and art2.ok:
                m2 = _f(art2.makespan)
                matched[name] = m2
                if m2 is not None and m2 < effective_lp:
                    effective_lp = m2
        scale = max(abs(effective_lp), abs(best_mk), 1e-300)
        if best_mk < effective_lp - rtol * scale:
            anomaly = {
                "kind": "heuristic-beats-lp",
                "strategy": best_name,
                "heuristic_makespan": _f(best_mk),
                "effective_lp": _f(effective_lp),
                "grid_lp": _f(lp_mk),
                "matched": {k: _f(v) for k, v in sorted(matched.items())},
            }
    elif lp_ok and lp_violations:
        anomaly = {
            "kind": "lp-infeasible",
            "violations": lp_violations[:5],
            "n_violations": len(lp_violations),
        }
    elif not lp_ok:
        anomaly = {
            "kind": "lp-failed",
            "status": getattr(artifact, "status", "missing"),
            "error": getattr(artifact, "error", None) if artifact is not None else None,
        }

    # -- precedence: anomaly > heuristic-infeasible > lp-fallback > win/tie
    if anomaly is not None:
        label = "anomaly"
    elif best_mk is None:
        label = "heuristic-infeasible"
    elif lp_events:
        label = "lp-fallback"
    else:
        scale = max(abs(effective_lp), abs(best_mk), 1e-300)
        label = "lp-wins" if best_mk > effective_lp + rtol * scale else "tie"

    ratio = None
    if best_mk is not None and effective_lp not in (None, 0.0):
        ratio = best_mk / effective_lp

    return Classification(
        cell_id=cell_id,
        index=index,
        content_key=instance_content_key(inst),
        label=label,
        lp_makespan=lp_mk,
        effective_lp=effective_lp,
        best_strategy=best_name,
        best_makespan=best_mk,
        ratio=ratio,
        strategies=strategies,
        lp_events=lp_events,
        matched=matched,
        anomaly=anomaly,
    )
