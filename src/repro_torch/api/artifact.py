"""Versioned, JSON-round-trippable plan artifacts.

A :class:`PlanArtifact` is what every :class:`repro_torch.api.Session` solve
returns: the *decision* (the gamma fractions and the installment tuple
actually solved), the certified objective values, and full provenance —
which backend actually served the request, whether the solution replayed
from the cache, any fallback/degradation events, and the solver's size
stats.  It deliberately does NOT store the schedule's event times: the ASAP
replay is deterministic and exact (a repo-wide invariant, property-tested),
so ``artifact.schedule()`` re-materializes the identical executable
schedule in any process from the gamma alone.

A copy of the reference package's artifact module: the document format and
``ARTIFACT_VERSION`` are the same, so each package reads the other's plans.

Versioning rules:

* ``ARTIFACT_VERSION`` bumps whenever a field is added, removed, renamed,
  or its meaning changes; ``from_json`` refuses versions it does not know
  (never a best-effort parse of a future schema).
* ``to_json`` is canonical — sorted keys, fixed separators, floats via
  ``repr`` (exact round-trip for every finite float64 and for NaN) — so
  ``from_json(s).to_json() == s`` bit-identically, across processes and
  platforms.  Ship it, diff it, replay it.

Version history:

* v1 — decision + provenance.
* v2 — adds ``events`` (structured provenance: what changed hands between
  the requested and serving backend, and why) and ``telemetry`` (per-stage
  solve timings + LP/bucket stats from the serving path).
  v1 documents still load — their artifacts keep ``version == 1`` and
  serialize back without the v2 keys, so v1 round-trips stay bit-stable.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .spec import Policy, Problem

__all__ = [
    "ARTIFACT_VERSION",
    "PlanArtifact",
    "problem_to_dict",
    "problem_from_dict",
    "policy_to_dict",
    "policy_from_dict",
]

ARTIFACT_VERSION = 2


def problem_to_dict(p: Problem) -> dict:
    """The canonical JSON-safe encoding of a :class:`Problem`.

    The exact field set artifacts serialize (and the serve wire format
    submits) — extracted so every encoder of a Problem agrees bit-for-bit.
    """
    return {
        "topology": p.topology,
        "w": list(p.w),
        "z": list(p.z),
        "tau": list(p.tau),
        "latency": list(p.latency),
        "v_comm": list(p.v_comm),
        "v_comp": list(p.v_comp),
        "release": list(p.release),
        "return_ratio": list(p.return_ratio),
        "w_per_load": [list(r) for r in p.w_per_load]
        if p.w_per_load is not None
        else None,
    }


def problem_from_dict(d: dict) -> Problem:
    """Inverse of :func:`problem_to_dict`."""
    return Problem(
        w=d["w"],
        z=d["z"],
        v_comm=d["v_comm"],
        v_comp=d["v_comp"],
        topology=d["topology"],
        tau=d["tau"],
        latency=d["latency"],
        release=d["release"],
        return_ratio=d["return_ratio"],
        w_per_load=d["w_per_load"],
    )


def policy_to_dict(pl: Policy) -> dict:
    """The canonical JSON-safe encoding of a :class:`Policy`."""
    return {
        "installments": list(pl.installments),
        "auto_t": pl.auto_t,
        "t_max": pl.t_max,
        "t_candidates": list(pl.t_candidates)
        if pl.t_candidates is not None
        else None,
        "installment_cost": pl.installment_cost,
        "backend": pl.backend,
        "objective": pl.objective,
        "weights": list(pl.weights) if pl.weights is not None else None,
        "beta": pl.beta,
        "cross_check": pl.cross_check,
        "validate": pl.validate,
        "fallback": pl.fallback,
        "cache_quantum": pl.cache_quantum,
    }


def policy_from_dict(d: dict) -> Policy:
    """Inverse of :func:`policy_to_dict`."""
    return Policy(
        installments=d["installments"],
        auto_t=d["auto_t"],
        t_max=d["t_max"],
        t_candidates=d["t_candidates"],
        installment_cost=d["installment_cost"],
        backend=d["backend"],
        objective=d["objective"],
        weights=d["weights"],
        beta=d["beta"],
        cross_check=d["cross_check"],
        validate=d["validate"],
        fallback=d["fallback"],
        cache_quantum=d["cache_quantum"],
    )


@dataclasses.dataclass
class PlanArtifact:
    """One solved plan + its provenance.  See module docstring."""

    problem: Problem
    policy: Policy
    q: tuple  # installment tuple actually solved (auto-T: the winning rung)
    gamma: np.ndarray  # [m, T] fractions (NaN on a failed solve)
    makespan: float  # replayed (executable) makespan
    lp_makespan: float  # the LP objective at the optimum
    objective_value: float  # value of the policy's objective
    status: str  # "optimal" | "infeasible" | "failed" | ...
    backend: str  # label that actually served it (e.g. "cuda+cache")
    cache_hit: bool
    fallback_events: tuple  # legacy strings, e.g. ("served_by:simplex",)
    n_vars: int
    n_rows: int
    sweep: dict | None = None  # auto-T provenance: qs/makespans/costs/t_star_index
    # v2: structured provenance events — dicts with at least
    # {"kind": "fallback"|"degrade"|"serial-rescue"|"rescue"|"error",
    #  "backend": str, "reason": str} (error events add "error_type" and
    #  "error_chain"); supersedes the fallback_events strings (kept as shims)
    events: tuple = ()
    # v2: per-stage solve timings + LP/bucket stats from the serving path
    # (JSON-safe dict); None on paths that record none
    telemetry: dict | None = None
    version: int = ARTIFACT_VERSION
    # live-solve conveniences, never serialized: the underlying SolveReport
    # (carries the already-replayed Schedule) and the per-rung sweep reports
    report: object = dataclasses.field(default=None, repr=False, compare=False)
    sweep_reports: tuple = dataclasses.field(default=(), repr=False, compare=False)

    @property
    def ok(self) -> bool:
        return self.status == "optimal"

    @property
    def t_star(self) -> int | None:
        """The winning uniform rung of an auto-T sweep (None on fixed plans)."""
        if self.sweep is None:
            return None
        return int(self.sweep["qs"][self.sweep["t_star_index"]][0])

    # ---------------- replay ----------------

    def instance(self):
        """The solver-facing instance this plan schedules."""
        return self.problem.to_instance(self.q)

    def schedule(self):
        """Re-materialize the executable schedule by exact ASAP replay.

        Prefers the live report's already-replayed schedule; a deserialized
        artifact replays from scratch — bit-identical by the replay
        invariant.  Raises on failed solves (there is nothing to replay).
        """
        if not self.ok:
            raise ValueError(f"cannot replay a {self.status!r} artifact")
        if self.report is not None:
            return self.report.schedule
        from repro_torch.core.simulator import simulate

        return simulate(self.instance(), self.gamma)

    # ---------------- diffing ----------------

    def diff(self, other: "PlanArtifact", tol: float = 0.0,
             include_provenance: bool = False) -> dict:
        """Field-level differences between two artifacts (empty == same plan).

        Compares the decision and outcome fields; ``tol`` is an absolute
        tolerance on the float fields and on the gamma entries (0 = exact).
        NaN gamma cells (failed solves) only match NaN cells — a failed
        plan never diffs clean against a solved one.

        ``include_provenance=True`` additionally compares the serving
        provenance (``backend``, ``cache_hit``, and — only when *both*
        artifacts are v2 documents — the structured ``events``).  The v2
        fields are version-gated so diffing a v1 document against a v2 one
        reports the version seam itself (``{"version": (1, 2)}``) instead of
        mis-reporting v1's absent events as "no events happened".
        """
        out: dict = {}
        if self.problem != other.problem:
            out["problem"] = (self.problem, other.problem)
        if self.q != other.q:
            out["q"] = (self.q, other.q)
        if self.status != other.status:
            out["status"] = (self.status, other.status)
        if self.gamma.shape != other.gamma.shape:
            out["gamma"] = (self.gamma.shape, other.gamma.shape)
        else:
            a, b = np.asarray(self.gamma), np.asarray(other.gamma)
            nan_a, nan_b = np.isnan(a), np.isnan(b)
            if (nan_a != nan_b).any():
                out["gamma"] = "nan-pattern"
            else:
                with np.errstate(invalid="ignore"):
                    d = np.abs(a - b)
                if not (np.nan_to_num(d) <= tol).all():
                    out["gamma"] = float(np.nanmax(d))
        for f in ("makespan", "lp_makespan", "objective_value"):
            a, b = getattr(self, f), getattr(other, f)
            same = (a == b) or (np.isnan(a) and np.isnan(b)) or (
                np.isfinite(a) and np.isfinite(b) and abs(a - b) <= tol
            )
            if not same:
                out[f] = (a, b)
        if include_provenance:
            if self.backend != other.backend:
                out["backend"] = (self.backend, other.backend)
            if self.cache_hit != other.cache_hit:
                out["cache_hit"] = (self.cache_hit, other.cache_hit)
            if self.version >= 2 and other.version >= 2:
                if self.events != other.events:
                    out["events"] = (self.events, other.events)
            elif self.version != other.version:
                out["version"] = (self.version, other.version)
        return out

    # ---------------- serialization ----------------

    def to_dict(self) -> dict:
        out = {
            "version": self.version,
            "problem": problem_to_dict(self.problem),
            "policy": policy_to_dict(self.policy),
            "q": list(self.q),
            "gamma": [[float(v) for v in row] for row in np.asarray(self.gamma)],
            "makespan": float(self.makespan),
            "lp_makespan": float(self.lp_makespan),
            "objective_value": float(self.objective_value),
            "status": self.status,
            "backend": self.backend,
            "cache_hit": self.cache_hit,
            "fallback_events": list(self.fallback_events),
            "n_vars": self.n_vars,
            "n_rows": self.n_rows,
            "sweep": self.sweep,
        }
        if self.version >= 2:
            # v1 artifacts (deserialized old documents) keep their exact
            # key set so the v1 round-trip stays bit-stable
            out["events"] = [dict(e) for e in self.events]
            out["telemetry"] = self.telemetry
        return out

    def to_json(self) -> str:
        """Canonical JSON: sorted keys, fixed separators, repr floats."""
        return json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"),
                          allow_nan=True)

    @classmethod
    def from_dict(cls, d: dict) -> "PlanArtifact":
        version = d.get("version")
        if version not in (1, ARTIFACT_VERSION):
            raise ValueError(
                f"unknown PlanArtifact version {version!r} "
                f"(this build reads versions 1..{ARTIFACT_VERSION})"
            )
        problem = problem_from_dict(d["problem"])
        policy = policy_from_dict(d["policy"])
        return cls(
            problem=problem,
            policy=policy,
            q=tuple(int(x) for x in d["q"]),
            gamma=np.asarray(d["gamma"], dtype=np.float64),
            makespan=float(d["makespan"]),
            lp_makespan=float(d["lp_makespan"]),
            objective_value=float(d["objective_value"]),
            status=d["status"],
            backend=d["backend"],
            cache_hit=bool(d["cache_hit"]),
            fallback_events=tuple(d["fallback_events"]),
            n_vars=int(d["n_vars"]),
            n_rows=int(d["n_rows"]),
            sweep=d["sweep"],
            events=tuple(dict(e) for e in d.get("events") or ()),
            telemetry=d.get("telemetry"),
            version=int(version),
        )

    @classmethod
    def from_json(cls, s: str) -> "PlanArtifact":
        return cls.from_dict(json.loads(s))
