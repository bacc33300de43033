"""Solver front-end — compatibility shims over the backend registry.

The real machinery lives in :mod:`repro_torch.core.backends` (the
``SolverBackend`` registry with uniform :class:`SolveRequest` /
:class:`SolveReport` dataclasses) and, for bulk solves, in
:mod:`repro_torch.engine.service`.  The functions here keep the historical
``backend="..."`` string-kwarg API alive — strings now simply name registry
entries — so existing callers and tests keep working.

.. deprecated::
   New code should build a :class:`SolveRequest` and call
   ``get_backend(name).solve(request)`` (or ``solve_many``) directly; the
   string kwargs on :func:`solve` / :func:`solve_batch` are retained as
   shims only.
"""

from __future__ import annotations

from .backends import (  # noqa: F401  (re-exported for compatibility)
    LPResult,
    SolveReport,
    SolveRequest,
    get_backend,
)
from .instance import Instance

__all__ = ["LPResult", "SolveRequest", "SolveReport", "solve", "solve_batch", "lower_bound"]


def solve(
    inst: Instance,
    objective: str = "makespan",
    weights=None,
    beta: float = 0.0,
    backend: str = "auto",
    cross_check: bool = False,
    validate: bool = True,
) -> SolveReport:
    """Solve the optimal-schedule LP for ``inst`` (paper §4).

    ``backend`` may be a registry name ("auto", "simplex", "scipy",
    "torch", "cuda", ...) or a :class:`repro_torch.core.backends.SolverBackend` instance.
    """
    req = SolveRequest(
        instance=inst,
        objective=objective,
        weights=weights,
        beta=beta,
        cross_check=cross_check,
        validate=validate,
    )
    return get_backend(backend).solve(req)


def solve_batch(
    instances,
    objective: str = "makespan",
    backend: str = "torch",
    cache=None,
) -> list:
    """Bulk counterpart of :func:`solve`: many instances, one call.

    backend:
      "torch"   — the PyTorch engine (repro_torch.engine): instances are
                  bucketed by (m, T, q), their LPs solved by the batched
                  simplex, and the fractions replayed through the batched
                  ASAP simulator, on the CUDA card.
                  Uncertified elements go to the (counted) serial rescue.
      "serial"  — a plain Python loop over :func:`solve` (the reference).

    Returns a list of :class:`SolveReport` in caller order.  ``cache`` may be
    a :class:`repro_torch.engine.cache.SolutionCache` to reuse solutions across
    calls (engine backends only).

    .. deprecated::
       Use ``repro_torch.api.Session.solve_bulk`` — it returns versioned
       :class:`PlanArtifact`\\ s and owns the cache for you.
    """
    import warnings

    warnings.warn(
        "solve_batch is deprecated: use repro_torch.api.Session.solve_bulk "
        "(one session owns the cache and returns PlanArtifacts)",
        DeprecationWarning,
        stacklevel=2,
    )
    reqs = [SolveRequest(instance=inst, objective=objective) for inst in instances]
    return get_backend(backend, cache=cache).solve_many(reqs)


def lower_bound(inst: Instance) -> float:
    """Cheap makespan lower bounds (used for sanity checks / roofline-style gap).

    LB1: total work / aggregate compute speed (perfect sharing, no comms).
    LB2: the data P_1 does not process must cross link 0 — but that amount is a
         decision, so the safe communication bound pairs with LB1 per load:
         for each load, min over split of max(P_1-only compute, link-0 time for
         the shipped part at infinite downstream speed).  We keep LB1 + release
         dates (valid and cheap); tighter bounds come from the LP itself.
    """
    rates = 1.0 / inst.chain.w  # unit volume per sec
    total_rate = rates.sum()
    work = float(inst.loads.v_comp.sum())
    lb = work / total_rate
    lb = max(lb, float(inst.loads.release.max()) if inst.N else 0.0)
    lb = max(lb, float(inst.chain.tau.min()))
    return lb
