"""Theorem 1 machinery and the §5 latency argument.

Theorem 1 (paper): under a *linear* cost model, any finite-installment
schedule is suboptimal — more installments strictly help.  We expose an
empirical verifier ``q_monotonicity`` (LP(Q+1) <= LP(Q), strict on
communication-bound instances) used by property tests and benchmarks.

§5: with per-message startup latencies (affine model) the makespan as a
function of Q first decreases (pipelining) then increases (latency overhead
(m-1)·Q·K), so a finite optimal Q* exists.  ``optimal_installments`` sweeps Q
to find it — this is the *practical* multi-installment designer the paper
argues the linear model cannot provide.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .instance import Instance
from .solver import solve

__all__ = ["q_monotonicity", "optimal_installments", "QStarResult"]


def q_monotonicity(inst: Instance, qs: list[int], backend: str = "auto") -> list[float]:
    """LP-optimal makespans for uniform installment counts ``qs`` (Theorem 1:
    nonincreasing under the linear model)."""
    out = []
    for q in qs:
        res = solve(inst.with_q(q), backend=backend)
        if not res.ok:
            raise RuntimeError(f"LP failed for Q={q}: {res.status}")
        out.append(res.makespan)
    return out


@dataclasses.dataclass
class QStarResult:
    q_star: int
    makespans: dict  # q -> makespan
    swept: list


def optimal_installments(
    inst: Instance,
    q_max: int = 16,
    backend: str = "auto",
    patience: int = 3,
) -> QStarResult:
    """Sweep uniform Q to find the latency-aware optimal installment count.

    Under the affine model the sequence is unimodal in practice; we stop after
    ``patience`` consecutive non-improvements.
    """
    makespans: dict[int, float] = {}
    best_q, best = 1, np.inf
    bad = 0
    swept = []
    for q in range(1, q_max + 1):
        res = solve(inst.with_q(q), backend=backend)
        if not res.ok:
            break
        makespans[q] = res.makespan
        swept.append(q)
        if res.makespan < best - 1e-12:
            best, best_q = res.makespan, q
            bad = 0
        else:
            bad += 1
            if bad >= patience:
                break
    return QStarResult(q_star=best_q, makespans=makespans, swept=swept)
