"""Solver backends: uniform request/report dataclasses + a pluggable registry.

Every consumer in the tree states *what* to solve — a :class:`SolveRequest`
(instance + objective) — and the registry decides *how*: a
:class:`SolverBackend` looked up by name (or passed as an instance) turns
requests into :class:`SolveReport`s.  This replaces the historical
string-dispatch scattered through ``core/solver.py``, ``core/planner.py``
and ``engine/service.py``.

Built-in backends:

  "simplex"  — the in-tree dense two-phase simplex (repro_torch.core.simplex),
               with a scipy/HiGHS rescue when it loses a numerical fight;
  "scipy"    — scipy.optimize.linprog / HiGHS (sparse), used for large
               instances exactly as the paper used GLPK;
  "auto"     — simplex for small LPs, scipy above a size threshold (or
               simplex if scipy is unavailable);
  "serial"   — alias of "auto" (the bulk-path name for "loop per instance");
  "torch"    — the PyTorch engine (repro_torch.engine.service.TorchBackend)
               on the device its caller names (``device=None`` is the CUDA
               card); registered lazily so importing repro_torch.core never
               imports torch;
  "cuda"     — the same engine on the card, its hot loops in the hand-written
               CUDA kernels (repro_torch.kernels); selecting it with no card,
               or with kernels that do not build, raises — there is no silent
               degrade to another device or to the plain versions.

Every optimal solve is finished by an ASAP *replay* of the LP's fractions
through the simulator: the replay is guaranteed feasible, its makespan can
only be <= the LP objective, and at the optimum the two agree
(property-tested).  The returned report carries the replayed (executable)
schedule.

Extending: subclass :class:`SolverBackend`, implement ``solve`` (or
``solve_many`` for bulk-native backends), and ``register_backend("name",
factory)``.  Factories take ``cache=None`` (an engine
:class:`repro_torch.engine.cache.SolutionCache`; serial backends ignore it).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from .instance import Instance
from .lp import build_lp, extract_schedule
from .schedule import Schedule, check_feasible
from .simplex import solve_simplex
from .simulator import simulate

__all__ = [
    "LPResult",
    "SolveRequest",
    "SolveReport",
    "SolverBackend",
    "register_backend",
    "get_backend",
    "available_backends",
    "SimplexBackend",
    "ScipyBackend",
    "AutoBackend",
]

_SCIPY_THRESHOLD_VARS = 120  # above this, prefer HiGHS (our dense simplex is the
# tiny-LP fast path, the no-scipy fallback, and the cross-check oracle; Bland
# anti-cycling gets slow on degenerate latency instances beyond ~100 vars)


def _have_scipy() -> bool:
    try:
        import scipy.optimize  # noqa: F401

        return True
    except Exception:  # pragma: no cover
        return False


@dataclasses.dataclass
class LPResult:
    schedule: Schedule  # replayed, executable schedule
    lp_makespan: float  # the LP objective value (== schedule.makespan at opt)
    objective_value: float  # value of the requested objective
    backend: str
    status: str
    n_vars: int
    n_rows: int
    # solver telemetry (DESIGN.md §8): per-stage timings + LP/bucket stats
    # gathered by the serving path; None on paths that don't record any.
    # JSON-safe by construction (str keys, float/int/str/list leaves).
    telemetry: dict | None = dataclasses.field(default=None, compare=False)

    @property
    def ok(self) -> bool:
        return self.status == "optimal"

    @property
    def makespan(self) -> float:
        return self.schedule.makespan


@dataclasses.dataclass
class SolveRequest:
    """What to solve: one schedule-LP instance plus its objective."""

    instance: Instance
    objective: str = "makespan"
    weights: object = None  # completion-objective weights (§5)
    beta: float = 0.0
    cross_check: bool = False
    validate: bool = True
    # warm-start seed for the engine backends: the exit basis of a previous
    # solve of a perturbed sibling (sequence of LP-row column ids, as found
    # in telemetry["lp"]["final_basis"]).  None = cold.  Serial backends
    # ignore it — it is a speed hint, never a correctness input.
    warm_basis: object = None


@dataclasses.dataclass
class SolveReport(LPResult):
    """How it went: an :class:`LPResult` that remembers its request."""

    request: SolveRequest | None = None

    @classmethod
    def from_result(cls, res: LPResult, request: SolveRequest) -> "SolveReport":
        if isinstance(res, cls):
            res.request = request
            return res
        return cls(
            schedule=res.schedule,
            lp_makespan=res.lp_makespan,
            objective_value=res.objective_value,
            backend=res.backend,
            status=res.status,
            n_vars=res.n_vars,
            n_rows=res.n_rows,
            telemetry=res.telemetry,
            request=request,
        )


class SolverBackend:
    """Base class: implement ``solve`` or ``solve_many`` (each defaults to
    the other).  ``cache`` is an optional engine solution cache; backends
    that cannot use one simply ignore it."""

    name = "base"

    def __init__(self, cache=None):
        self.cache = cache

    def solve(self, request: SolveRequest) -> SolveReport:
        return self.solve_many([request])[0]

    def solve_many(self, requests: list) -> list:
        return [self.solve(r) for r in requests]


# --------------------------------------------------------------------------
# the serial backends (build via the shared IR, solve, replay-validate)
# --------------------------------------------------------------------------


def _solve_scipy(lp) -> tuple[np.ndarray, str]:
    from scipy.optimize import linprog

    res = linprog(
        lp.c,
        A_ub=lp.sparse_ub() if lp.b_ub else None,
        b_ub=np.asarray(lp.b_ub) if lp.b_ub else None,
        A_eq=lp.sparse_eq() if lp.b_eq else None,
        b_eq=np.asarray(lp.b_eq) if lp.b_eq else None,
        bounds=(0, None),
        method="highs",
    )
    status = "optimal" if res.status == 0 else ("infeasible" if res.status == 2 else "failed")
    x = res.x if res.x is not None else np.full(lp.n_vars, np.nan)
    return np.asarray(x), status


def _solve_simplex(lp) -> tuple[np.ndarray, str]:
    A_ub, b_ub = lp.dense_ub()
    A_eq, b_eq = lp.dense_eq()
    res = solve_simplex(lp.c, A_ub, b_ub, A_eq, b_eq)
    return res.x, res.status


def _primal_violation(lp, x: np.ndarray) -> float:
    """Worst primal-feasibility violation of ``x`` (0.0 == feasible).

    A dense-simplex exit can read "optimal" while the iterate drifted off
    the polytope (a numerical fight it lost silently rather than loudly) —
    the golden-eval campaign caught exactly that on a star/returns LP, with
    a port-serialization row violated by ~0.24 under an objective that
    looked better than the true optimum.  Two matvecs make "optimal"
    actually mean feasible."""
    worst = 0.0
    if lp.b_ub:
        A_ub, b_ub = lp.dense_ub()
        worst = max(worst, float(np.max(A_ub @ x - b_ub)))
    if lp.b_eq:
        A_eq, b_eq = lp.dense_eq()
        worst = max(worst, float(np.max(np.abs(A_eq @ x - b_eq))))
    worst = max(worst, float(np.max(-x)) if x.size else 0.0)
    return worst


def _feasibility_tol(x: np.ndarray) -> float:
    """Absolute tolerance scaled by the iterate's magnitude: schedule-LP
    variables are event times, so honest float noise is ~1e-12 relative to
    the makespan while a lost pivot shows up orders of magnitude larger."""
    scale = float(np.max(np.abs(x))) if x.size else 1.0
    return 1e-7 * max(1.0, scale)


def _solve_serial(req: SolveRequest, backend: str) -> SolveReport:
    """The reference solve path (paper §4): build, solve, replay-validate."""
    inst = req.instance
    lp = build_lp(inst, objective=req.objective, weights=req.weights, beta=req.beta)

    if backend == "auto":
        backend = (
            "scipy" if (_have_scipy() and lp.n_vars > _SCIPY_THRESHOLD_VARS) else "simplex"
        )

    if backend == "scipy":
        x, status = _solve_scipy(lp)
    elif backend == "simplex":
        x, status = _solve_simplex(lp)
        if status in ("unbounded", "iteration_limit") and _have_scipy():
            # schedule LPs are never unbounded — a non-optimal exit here is
            # the dense simplex losing a numerical fight; HiGHS is the rescue
            x, status = _solve_scipy(lp)
        elif status == "optimal" and _primal_violation(lp, x) > _feasibility_tol(x):
            # ...and so is an "optimal" exit whose iterate left the polytope
            # (silently lost pivot): the objective reads better than the true
            # optimum while a constraint row is violated outright
            if _have_scipy():
                x, status = _solve_scipy(lp)
            else:
                status = "failed"
            backend = "simplex+scipy"
    else:
        raise ValueError(backend)

    # (skip after a scipy rescue: the dense simplex already failed once, and
    # re-running it just burns its full iteration budget for no comparison)
    if req.cross_check and _have_scipy() and status == "optimal" and backend in ("simplex", "scipy"):
        x2, s2 = _solve_scipy(lp) if backend == "simplex" else _solve_simplex(lp)
        if s2 == "optimal":
            o1, o2 = float(lp.c @ x), float(lp.c @ x2)
            scale = max(abs(o1), abs(o2), 1e-12)
            if abs(o1 - o2) / scale > 1e-6:
                raise AssertionError(
                    f"backend disagreement: {backend}={o1!r} vs other={o2!r}"
                )

    if status != "optimal":
        nan_sched = extract_schedule(lp, np.full(lp.n_vars, np.nan))
        return SolveReport(
            nan_sched, np.nan, np.nan, backend, status, lp.n_vars,
            len(lp.b_ub) + len(lp.b_eq), request=req,
        )

    sched_lp = extract_schedule(lp, x)
    # replay the fractions ASAP -> executable schedule with tightest times
    sched = simulate(inst, sched_lp.gamma)
    if req.validate:
        errs = check_feasible(sched, tol=1e-6)
        if errs:
            raise AssertionError(f"LP replay infeasible: {errs[:5]}")
        if sched.makespan > sched_lp.makespan * (1 + 1e-6) + 1e-9:
            raise AssertionError(
                f"replay makespan {sched.makespan} exceeds LP makespan {sched_lp.makespan}"
            )
    if req.objective == "makespan":
        obj_val = sched.makespan
    else:
        w = np.ones(inst.N) if req.weights is None else np.asarray(req.weights)
        comp = np.array([sched.completion_time(n) for n in range(inst.N)])
        obj_val = float(w @ comp + req.beta * sched.makespan)
    return SolveReport(
        schedule=sched,
        lp_makespan=float(sched_lp.makespan),
        objective_value=obj_val,
        backend=backend,
        status=status,
        n_vars=lp.n_vars,
        n_rows=len(lp.b_ub) + len(lp.b_eq),
        request=req,
    )


class SimplexBackend(SolverBackend):
    """The in-tree dense two-phase simplex (scipy-rescued on numerical loss)."""

    name = "simplex"

    def solve(self, request: SolveRequest) -> SolveReport:
        return _solve_serial(request, "simplex")


class ScipyBackend(SolverBackend):
    """scipy.optimize.linprog / HiGHS on the sparse lowering."""

    name = "scipy"

    def solve(self, request: SolveRequest) -> SolveReport:
        return _solve_serial(request, "scipy")


class AutoBackend(SolverBackend):
    """simplex below the size threshold, scipy/HiGHS above (when available)."""

    name = "auto"

    def solve(self, request: SolveRequest) -> SolveReport:
        return _solve_serial(request, "auto")


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

_FACTORIES: dict = {}
_DEFAULTS: dict = {}  # name -> shared instance (constructed without a cache)


def register_backend(name: str, factory) -> None:
    """Register ``factory(cache=None) -> SolverBackend`` under ``name``."""
    _FACTORIES[name] = factory
    _DEFAULTS.pop(name, None)


def available_backends() -> list:
    return sorted(_FACTORIES)


def get_backend(spec, cache=None) -> SolverBackend:
    """Resolve a backend: an instance passes through; a name hits the registry.

    ``cache`` (an engine solution cache) is handed to the factory when
    ``spec`` is a name; without one, a shared default instance per name is
    returned.  An *instance* with no cache of its own is served as a shallow
    copy carrying ``cache`` (so ``Planner(..., cache=...)`` works with
    backend instances too, without mutating the caller's — or the shared
    default — instance); an instance's existing cache is never replaced.
    """
    if isinstance(spec, SolverBackend):
        if cache is not None and spec.cache is None:
            spec = copy.copy(spec)
            spec.cache = cache
        return spec
    try:
        factory = _FACTORIES[spec]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown solver backend {spec!r}; available: {available_backends()}"
        ) from None
    if cache is not None:
        return factory(cache=cache)
    if spec not in _DEFAULTS:
        _DEFAULTS[spec] = factory()
    return _DEFAULTS[spec]


def _torch_factory(cache=None):
    from repro_torch.engine.service import TorchBackend  # deferred: torch import

    return TorchBackend(cache=cache)


def _cuda_factory(cache=None):
    from repro_torch.engine.service import CudaBackend  # deferred: torch import

    # raises when there is no card or the kernels do not build
    return CudaBackend(cache=cache)


register_backend("simplex", SimplexBackend)
register_backend("scipy", ScipyBackend)
register_backend("auto", AutoBackend)
register_backend("serial", AutoBackend)  # bulk-path alias: loop of auto solves
register_backend("torch", _torch_factory)
register_backend("cuda", _cuda_factory)
