"""Declarative problem/policy specs — the *what* and the *how* of a solve.

A :class:`Problem` is the full Fig.-6 scheduling instance minus any solver
choice: platform topology (chain or one-port-master star), per-processor
speeds and availability dates, per-link bandwidths and startup latencies,
the divisible loads with their release dates and result-return ratios, and
(optionally) the §5 unrelated-machine ``w_per_load`` matrix.  It is frozen
and hashable — every field is a tuple of floats — so Problems can key
dicts, deduplicate request streams, and derive the arena/cache keys
(:mod:`repro_torch.core.keys`) without ever re-deriving them per layer.

A :class:`Policy` is everything about *how* to solve that is not part of
the problem: the installment plan (a fixed count, or the cost-aware
auto-T* sweep of Theorem 1), the solver-backend registry entry, the
completion-objective parameters of §5, the cache quantum, and the engine
fallback/validation rules.  Also frozen and hashable, so a (problem,
policy) pair is itself a key.

The split deliberately moves the installment count ``q`` OUT of the
instance spec (where :class:`repro_torch.core.instance.Instance` carries it) and
into the policy: the paper's central lesson is that ``q`` is a solver
knob — LP(q+1) <= LP(q), Theorem 1 — not a property of the workload.

A copy of the reference package's specs: content and bucket keys are
byte-identical to the reference's, and only the backend names differ (the
port's registry).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.instance import Chain, Instance, Loads, Star
from repro_torch.core.keys import instance_bucket_key, instance_content_key

__all__ = ["Problem", "Policy"]


def _tup(x, n: int, name: str) -> tuple:
    """Coerce scalar-or-sequence to an n-tuple of floats (scalar broadcasts)."""
    a = np.asarray(x, dtype=np.float64)
    if a.ndim == 0:
        a = np.full(n, float(a))
    if a.shape != (n,):
        raise ValueError(f"{name}: expected shape ({n},), got {a.shape}")
    return tuple(float(v) for v in a)


_TOPOLOGIES = {"chain": Chain, "star": Star}


@dataclasses.dataclass(frozen=True)
class Problem:
    """One complete scheduling problem: platform + loads.  Frozen, hashable.

    Shapes: ``w``/``tau`` have one entry per processor (m), ``z``/``latency``
    one per link (m-1); ``v_comm``/``v_comp``/``release``/``return_ratio``
    one per load (N).  Scalars broadcast.  ``w_per_load`` (optional,
    m x N nested tuples) activates the §5 unrelated-machine model.
    """

    topology: str
    w: tuple
    z: tuple
    tau: tuple
    latency: tuple
    v_comm: tuple
    v_comp: tuple
    release: tuple
    return_ratio: tuple
    w_per_load: tuple | None

    def __init__(
        self,
        w,
        z,
        v_comm,
        v_comp,
        *,
        topology: str = "chain",
        tau=0.0,
        latency=0.0,
        release=0.0,
        return_ratio=0.0,
        w_per_load=None,
    ):
        if topology not in _TOPOLOGIES:
            raise ValueError(
                f"unknown topology {topology!r} (expected one of {sorted(_TOPOLOGIES)})"
            )
        w = np.atleast_1d(np.asarray(w, dtype=np.float64))
        m = w.shape[0]
        v_comm = np.atleast_1d(np.asarray(v_comm, dtype=np.float64))
        n = v_comm.shape[0]
        object.__setattr__(self, "topology", str(topology))
        object.__setattr__(self, "w", tuple(float(v) for v in w))
        object.__setattr__(self, "z", _tup(z, max(m - 1, 0), "z"))
        object.__setattr__(self, "tau", _tup(tau, m, "tau"))
        object.__setattr__(self, "latency", _tup(latency, max(m - 1, 0), "latency"))
        object.__setattr__(self, "v_comm", tuple(float(v) for v in v_comm))
        object.__setattr__(self, "v_comp", _tup(v_comp, n, "v_comp"))
        object.__setattr__(self, "release", _tup(release, n, "release"))
        object.__setattr__(self, "return_ratio", _tup(return_ratio, n, "return_ratio"))
        if w_per_load is not None:
            wpl = np.asarray(w_per_load, dtype=np.float64)
            if wpl.shape != (m, n):
                raise ValueError(f"w_per_load must be [m,N]={(m, n)}, got {wpl.shape}")
            w_per_load = tuple(tuple(float(v) for v in row) for row in wpl)
        object.__setattr__(self, "w_per_load", w_per_load)
        # per-q Instance memo (not a dataclass field: excluded from eq/hash/
        # repr).  Problems are frozen and consumers treat instances as
        # read-only, so the same materialization serves validation, key
        # derivation, and every solve instead of being rebuilt per layer.
        object.__setattr__(self, "_instances", {})
        # one canonical validator: Instance enforces every domain constraint
        # (w > 0, z >= 0, tau/latency >= 0, v_comp > 0, return_ratio >= 0)
        self.to_instance()

    # ---------------- conversions ----------------

    @classmethod
    def from_instance(cls, inst: Instance) -> "Problem":
        """Capture an :class:`Instance`'s platform + loads (q moves to Policy)."""
        return cls(
            w=inst.platform.w,
            z=inst.platform.z,
            v_comm=inst.loads.v_comm,
            v_comp=inst.loads.v_comp,
            topology=inst.topology,
            tau=inst.platform.tau,
            latency=inst.platform.latency,
            release=inst.loads.release,
            return_ratio=inst.loads.return_ratio,
            w_per_load=inst.w_per_load,
        )

    def to_instance(self, q=1) -> Instance:
        """Materialize the solver-facing :class:`Instance` with ``q``
        installments (memoized per q — treat the result as read-only)."""
        if isinstance(q, (int, np.integer)):
            qt = (int(q),) * self.n_loads
        else:
            qt = tuple(int(x) for x in q)
        inst = self._instances.get(qt)
        if inst is not None:
            return inst
        platform = _TOPOLOGIES[self.topology](
            w=np.array(self.w),
            z=np.array(self.z),
            tau=np.array(self.tau),
            latency=np.array(self.latency),
        )
        loads = Loads(
            v_comm=np.array(self.v_comm),
            v_comp=np.array(self.v_comp),
            release=np.array(self.release),
            return_ratio=np.array(self.return_ratio),
        )
        wpl = np.array(self.w_per_load) if self.w_per_load is not None else None
        inst = Instance(platform, loads, q=qt, w_per_load=wpl)
        self._instances[qt] = inst
        return inst

    # ---------------- shape ----------------

    @property
    def m(self) -> int:
        return len(self.w)

    @property
    def n_loads(self) -> int:
        return len(self.v_comm)

    @property
    def has_returns(self) -> bool:
        return any(r > 0.0 for r in self.return_ratio)

    # ---------------- keys (the one derivation, repro_torch.core.keys) ---

    def key(self, q=1, objective: str = "makespan", quantum: float = 1e-9) -> str:
        """The quantized content hash — the engine cache slot for (self, q)."""
        return instance_content_key(self.to_instance(q), objective=objective, quantum=quantum)

    def bucket_key(self, q=1) -> tuple:
        """The structural arena-bucket key ``(topology, has_returns, m, T, q)``."""
        return instance_bucket_key(self.to_instance(q))


@dataclasses.dataclass(frozen=True)
class Policy:
    """How to solve: installments, backend, objective, cache/fallback rules.

    Installment plan: ``installments`` is a per-load tuple (an int
    broadcasts) used as-is when ``auto_t`` is False.  With ``auto_t=True``
    the session sweeps the uniform ladder ``1..t_max`` (or the explicit
    ``t_candidates`` rungs) in ONE bulk call and keeps the cost-aware
    winner ``T* = argmin_q makespan(q) + installment_cost * q * n_loads``
    (ties break toward fewer installments) — the practical Theorem-1
    chooser.

    ``backend`` names a :mod:`repro_torch.core.backends` registry entry:
    ``"auto"``, ``"serial"``, ``"simplex"``, ``"scipy"``, ``"torch"`` or
    ``"cuda"`` (the reference's ``"batched"``/``"pallas"`` have no alias).
    ``fallback=False`` makes the engine backends raise instead of routing
    uncertified elements to the serial solver.  ``cache_quantum`` is the
    relative quantization of the session's solution-cache keys.
    ``weights``/``beta``/``cross_check``/``validate`` mirror
    :class:`repro_torch.core.backends.SolveRequest` field-for-field, so any
    historical request is expressible as a (Problem, Policy) pair.
    """

    installments: tuple = (1,)
    auto_t: bool = False
    t_max: int = 8
    t_candidates: tuple | None = None
    installment_cost: float = 0.0
    backend: str = "auto"
    objective: str = "makespan"
    weights: tuple | None = None
    beta: float = 0.0
    cross_check: bool = False
    validate: bool = True
    fallback: bool = True
    cache_quantum: float = 1e-9

    def __init__(
        self,
        installments=1,
        *,
        auto_t: bool = False,
        t_max: int = 8,
        t_candidates=None,
        installment_cost: float = 0.0,
        backend: str = "auto",
        objective: str = "makespan",
        weights=None,
        beta: float = 0.0,
        cross_check: bool = False,
        validate: bool = True,
        fallback: bool = True,
        cache_quantum: float = 1e-9,
    ):
        if isinstance(installments, (int, np.integer)):
            installments = (int(installments),)
        else:
            installments = tuple(int(x) for x in installments)
        if any(x < 1 for x in installments):
            raise ValueError("installments must all be >= 1")
        if t_candidates is not None:
            t_candidates = tuple(int(x) for x in t_candidates)
            if not t_candidates or any(x < 1 for x in t_candidates):
                raise ValueError("t_candidates must be a non-empty ladder of ints >= 1")
        if t_max < 1:
            raise ValueError("t_max must be >= 1")
        if installment_cost < 0:
            raise ValueError("installment_cost must be >= 0")
        if cache_quantum <= 0:
            raise ValueError("cache_quantum must be > 0")
        if weights is not None:
            weights = tuple(float(x) for x in np.asarray(weights, dtype=np.float64))
        object.__setattr__(self, "installments", installments)
        object.__setattr__(self, "auto_t", bool(auto_t))
        object.__setattr__(self, "t_max", int(t_max))
        object.__setattr__(self, "t_candidates", t_candidates)
        object.__setattr__(self, "installment_cost", float(installment_cost))
        object.__setattr__(self, "backend", str(backend))
        object.__setattr__(self, "objective", str(objective))
        object.__setattr__(self, "weights", weights)
        object.__setattr__(self, "beta", float(beta))
        object.__setattr__(self, "cross_check", bool(cross_check))
        object.__setattr__(self, "validate", bool(validate))
        object.__setattr__(self, "fallback", bool(fallback))
        object.__setattr__(self, "cache_quantum", float(cache_quantum))

    # ---------------- installment plans ----------------

    def q_for(self, problem: Problem) -> tuple:
        """The fixed per-load installment tuple for ``problem``."""
        q = self.installments
        if len(q) == 1 and problem.n_loads != 1:
            return q * problem.n_loads
        if len(q) != problem.n_loads:
            raise ValueError(
                f"installments {q} does not match the problem's {problem.n_loads} loads"
            )
        return q

    def q_candidates(self, problem: Problem) -> list:
        """Every installment tuple this policy wants solved (sweep order).

        A fixed policy has exactly one candidate; ``auto_t`` yields the
        uniform ladder, one tuple per rung.
        """
        if not self.auto_t:
            return [self.q_for(problem)]
        ladder = self.t_candidates or tuple(range(1, self.t_max + 1))
        return [(rung,) * problem.n_loads for rung in ladder]
