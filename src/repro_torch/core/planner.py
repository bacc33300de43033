"""DLT planner: turns a (model, chain-of-device-groups, batch stream)
description into a paper Instance, solves it, and emits an executable
installment plan for the runtime.

A copy of the reference package's planner whose plans route through the
port's :class:`repro_torch.api.Session`: the engine backend names are the
port's (``"torch"``, which runs on the session's device, and ``"cuda"``).

Mapping:
  * chain stage  = a device group (the linear axis),
  * w_i          = seconds per unit work = 1 / (stage effective FLOP/s),
                   updated online from observed step times (straggler feedback),
  * z_i, K_i     = seconds per byte + message startup on the stage_i->stage_{i+1}
                   link,
  * load n       = a global batch: V_comm = bytes of its tokens/embeddings,
                   V_comp = model FLOPs to process it,
  * installment  = a microbatch slice; gamma[i, t] becomes an integer number
                   of samples per stage per round (largest-remainder rounding).

The plan is re-solved on failure (drop a stage; availability dates tau_i model
restore times) and on straggler drift (w_i EWMA) — `replan_*` below.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .backends import get_backend
from .instance import Instance
from .solver import LPResult

__all__ = [
    "StageSpec",
    "LinkSpec",
    "BatchSpec",
    "DLTPlan",
    "AutoTResult",
    "Planner",
]


@dataclasses.dataclass
class StageSpec:
    """One stage of the linear chain (a pod / device group)."""

    name: str
    flops_per_sec: float  # effective sustained FLOP/s of the whole stage
    available_at: float = 0.0  # tau_i (restore/join time)


@dataclasses.dataclass
class LinkSpec:
    bytes_per_sec: float  # sustained point-to-point bandwidth
    startup_sec: float = 0.0  # per-message latency K_i


@dataclasses.dataclass
class BatchSpec:
    """One divisible load: a global batch of independent samples.

    ``return_bytes_per_sample`` > 0 activates the result-return phase for
    this load: after a stage computes its samples, that many bytes per
    sample (gradients, logits, labels) must flow back to the source stage
    before the batch counts as finished.
    """

    num_samples: int
    bytes_per_sample: float
    flops_per_sample: float
    release_at: float = 0.0
    return_bytes_per_sample: float = 0.0


@dataclasses.dataclass
class DLTPlan:
    """Executable plan: per (load, round) integer sample counts per stage."""

    result: LPResult
    batches: list
    # samples[t][i] = integer samples of cell t's load on stage i
    samples: list
    cells: list  # (load index, installment index)
    makespan: float
    # the versioned repro_torch.api.PlanArtifact behind this plan (ship/diff/replay);
    # None only for plans built outside the Session path
    artifact: object = None

    def stage_rounds(self, stage: int) -> list:
        """[(load, installment, n_samples)] for one stage, in execution order."""
        out = []
        for t, (n, j) in enumerate(self.cells):
            out.append((n, j, self.samples[t][stage]))
        return out

    def total_samples(self, load: int) -> int:
        return sum(
            s[i]
            for t, s in enumerate(self.samples)
            for i in range(len(s))
            if self.cells[t][0] == load
        )


@dataclasses.dataclass
class AutoTResult:
    """Outcome of the cost-aware installment-count sweep (``plan_auto_T``).

    The paper's Theorem 1 says the *linear* cost model wants infinitely many
    installments; any real system pays a fixed per-installment overhead
    (message startup, kernel launch, planning/bookkeeping), so the practical
    objective is  ``makespan(T) + installment_cost * total_installments(T)``.
    ``t_star`` minimizes that; ``plan`` is the executable winner.
    """

    plan: DLTPlan
    t_star: int  # winning uniform installments-per-load
    installment_cost: float
    makespans: dict  # q -> LP-optimal makespan
    costs: dict  # q -> makespan + installment_cost * (q * n_loads)
    reports: list  # SolveReport per swept q, sweep order


def _largest_remainder(frac: np.ndarray, total: int) -> np.ndarray:
    """Round fractions-of-total to integers that sum exactly to ``total``."""
    raw = frac * total
    base = np.floor(raw).astype(np.int64)
    short = int(total - base.sum())
    if short > 0:
        order = np.argsort(-(raw - base))
        base[order[:short]] += 1
    return base


class Planner:
    """Solve + maintain DLT schedules for a chain or star of device groups.

    ``topology="chain"`` (default) is the paper's linear pipeline: stage i
    forwards data to stage i+1.  ``topology="star"`` makes stage 0 the
    one-port master (the data-holding pod) with every other stage attached
    by its own link — ``links[i]`` then connects the master to stage i+1.
    Both need exactly ``len(stages) - 1`` links.
    """

    def __init__(self, stages: list, links: list, ewma: float = 0.5, cache=None,
                 topology: str = "chain", session=None):
        if len(links) != max(len(stages) - 1, 0):
            raise ValueError("need exactly len(stages)-1 links")
        if topology not in ("chain", "star"):
            raise ValueError(f"unknown topology {topology!r}")
        self.stages = list(stages)
        self.links = list(links)
        self.ewma = ewma
        self.topology = topology
        # the repro_torch.api.Session every plan routes through; created lazily so
        # constructing a Planner stays import-light.  ``cache`` seeds the
        # session's solution cache (shared across replans so identical
        # platform states replay instead of solve).
        if session is not None and cache is not None:
            raise ValueError(
                "pass either cache= or session= (a session owns its cache); "
                "to reuse a warm cache with a shared session, set "
                "session.cache = cache first"
            )
        self._session = session
        self._cache0 = cache if session is None else None

    # ---------------- the session front door ----------------

    @property
    def session(self):
        """The :class:`repro_torch.api.Session` this planner solves through."""
        if self._session is None:
            from repro_torch.api import Session

            self._session = Session(cache=self._cache0)
            self._cache0 = None
        return self._session

    @property
    def _cache(self):
        """Historical alias: the session's solution cache (may be None)."""
        if self._session is not None:
            return self._session._cache
        return self._cache0

    @_cache.setter
    def _cache(self, value) -> None:
        if self._session is not None:
            self._session.cache = value
        else:
            self._cache0 = value

    def _policy(self, q, backend, **kw):
        """(Policy, backend-instance-override) for one legacy call."""
        from repro_torch.api import Policy

        if isinstance(backend, str):
            return Policy(installments=q, backend=backend, **kw), None
        return Policy(installments=q, **kw), backend

    # ---------------- instance construction ----------------

    def to_problem(self, batches: list):
        """Map stages/links/batches onto a declarative :class:`repro_torch.api.Problem`."""
        from repro_torch.api import Problem

        for b in batches:
            if b.return_bytes_per_sample > 0 and b.bytes_per_sample <= 0:
                raise ValueError(
                    "BatchSpec with return_bytes_per_sample > 0 needs "
                    "bytes_per_sample > 0: the return phase is modeled as a "
                    "ratio of the forward volume, so a zero-byte forward "
                    "load cannot express its return traffic"
                )
        return Problem(
            topology=self.topology,
            w=[1.0 / s.flops_per_sec for s in self.stages],
            z=[1.0 / l.bytes_per_sec for l in self.links],
            tau=[s.available_at for s in self.stages],
            latency=[l.startup_sec for l in self.links],
            v_comm=[b.num_samples * b.bytes_per_sample for b in batches],
            v_comp=[b.num_samples * b.flops_per_sample for b in batches],
            release=[b.release_at for b in batches],
            return_ratio=[
                (b.return_bytes_per_sample / b.bytes_per_sample)
                if b.bytes_per_sample > 0 else 0.0
                for b in batches
            ],
        )

    def to_instance(self, batches: list, q: int | list = 1) -> Instance:
        return self.to_problem(batches).to_instance(q)

    # ---------------- planning ----------------

    def solver(self, backend="auto"):
        """Resolve ``backend`` (registry name or instance) with this
        planner's solution cache attached."""
        return get_backend(backend, cache=self._cache)

    def plan(self, batches: list, q: int | list = 1, backend="auto") -> DLTPlan:
        """Solve one plan.  ``backend`` is a registry name or a
        :class:`SolverBackend`; ``"torch"``/``"cuda"`` route through the
        engine (repro_torch.engine) — replans through the session's solution
        cache hit it instead of the LP.  Shim over ``session.solve``."""
        policy, override = self._policy(q, backend)
        art = self.session.solve(self.to_problem(batches), policy, backend=override)
        if not art.ok:
            raise RuntimeError(f"DLT LP failed: {art.status}")
        return self._plan_from_artifact(art, batches)

    def plan_bulk(
        self, scenarios: list, q: int | list = 1, backend="torch"
    ) -> list:
        """What-if fan-out: plan many batch-lists in one engine call.

        ``scenarios`` is a list of batch-lists (e.g. one per straggler /
        failure hypothesis over the *same* chain); all the instances are
        solved in fixed-shape batches by the engine and integerized back
        into :class:`DLTPlan`s.  Shim over ``session.solve_bulk``.
        """
        policy, override = self._policy(q, backend)
        arts = self.session.solve_bulk(
            [self.to_problem(b) for b in scenarios], policy, backend=override
        )
        plans = []
        for art, batches in zip(arts, scenarios):
            if not art.ok:
                raise RuntimeError(f"DLT LP failed: {art.status}")
            plans.append(self._plan_from_artifact(art, batches))
        return plans

    def plan_auto_T(
        self,
        batches: list,
        t_max: int = 8,
        installment_cost: float = 0.0,
        backend="torch",
        qs=None,
    ) -> AutoTResult:
        """Pick the installment count: a batched sweep for the cost-aware T*.

        Theorem 1 (paper §4) shows that under the linear cost model the
        optimal schedule needs infinitely many installments — LP(T+1) <=
        LP(T), always.  The *practical* chooser therefore needs a cost for
        installments themselves: each one pays a fixed overhead
        ``installment_cost`` (message startup beyond K_i, kernel launches,
        per-round bookkeeping).  This sweeps uniform q = 1..t_max (or the
        explicit ``qs`` ladder), solves every candidate in ONE bulk call —
        each q is its own (m, T, q) bucket, so the engine packs one bucket
        per rung and solves them all batched — and returns the executable
        plan for

            T* = argmin_q  makespan(q) + installment_cost * q * n_loads.

        Ties break toward fewer installments (within 1e-12 relative).
        """
        qs = list(qs) if qs is not None else None  # materialize once: qs may be a generator
        if qs is not None and not qs:
            raise ValueError("need at least one candidate installment count")
        policy, override = self._policy(
            1, backend,
            auto_t=True, t_max=t_max,
            t_candidates=tuple(qs) if qs is not None else None,
            installment_cost=installment_cost,
        )
        art = self.session.solve(self.to_problem(batches), policy, backend=override)
        if not art.ok:
            # sweep provenance is absent when every rung failed — report the
            # actual swept ladder, one status per rung
            ladder = list(policy.t_candidates or range(1, policy.t_max + 1))
            raise RuntimeError(
                f"auto-T sweep failed for every q in {ladder}: "
                f"{[r.status for r in art.sweep_reports]}"
            )
        makespans: dict[int, float] = {}
        costs: dict[int, float] = {}
        for qt, mk, cst in zip(
            art.sweep["qs"], art.sweep["makespans"], art.sweep["costs"]
        ):
            if mk is not None:
                makespans[int(qt[0])] = mk
                costs[int(qt[0])] = cst
        return AutoTResult(
            plan=self._plan_from_artifact(art, batches),
            t_star=art.t_star,
            installment_cost=installment_cost,
            makespans=makespans,
            costs=costs,
            reports=list(art.sweep_reports),
        )

    def _plan_from_artifact(self, art, batches: list) -> DLTPlan:
        plan = self._plan_from_result(
            art.report.schedule.instance, art.report, batches
        )
        plan.artifact = art
        return plan

    def _plan_from_result(self, inst: Instance, res: LPResult, batches: list) -> DLTPlan:
        cells = list(inst.cells())
        gamma = res.schedule.gamma  # [m, T]
        samples = []
        # integerize per load across all its cells jointly
        for n, b in enumerate(batches):
            cols = [t for t, (ln, _) in enumerate(cells) if ln == n]
            flat = gamma[:, cols].reshape(-1)
            ints = _largest_remainder(flat, b.num_samples).reshape(len(self.stages), len(cols))
            for k, t in enumerate(cols):
                while len(samples) <= t:
                    samples.append(None)
                samples[t] = ints[:, k]
        return DLTPlan(
            result=res, batches=list(batches), samples=samples, cells=cells, makespan=res.makespan
        )

    # ---------------- elasticity / fault tolerance ----------------

    def replan_without_stage(
        self,
        dead: int,
        batches: list,
        restore_delay: float = 0.0,
        q: int | list = 1,
        backend="auto",
    ) -> "tuple[Planner, DLTPlan]":
        """Drop a failed stage, fuse its links, and re-solve from scratch.

        ``restore_delay`` becomes the surviving stages' availability date tau_i
        (the time to restore the last checkpoint onto the new chain).

        On a star, dropping a worker simply removes its private link (the
        master — stage 0 — cannot be dropped: it holds the data).
        """
        stages = [s for k, s in enumerate(self.stages) if k != dead]
        links = list(self.links)
        if self.topology == "star":
            if dead == 0:
                raise ValueError("cannot drop the star master (it holds the data)")
            links = links[: dead - 1] + links[dead:]
        elif dead == 0:
            links = links[1:]
        elif dead == len(self.stages) - 1:
            links = links[:-1]
        else:
            fused = LinkSpec(
                bytes_per_sec=1.0
                / (1.0 / links[dead - 1].bytes_per_sec + 1.0 / links[dead].bytes_per_sec),
                startup_sec=links[dead - 1].startup_sec + links[dead].startup_sec,
            )
            links = links[: dead - 1] + [fused] + links[dead + 1 :]
        stages = [
            dataclasses.replace(s, available_at=max(s.available_at, restore_delay)) for s in stages
        ]
        # the new planner shares this one's session (and with it the solution
        # cache and backend handles) — a platform change is not a state reset
        p2 = Planner(stages, links, ewma=self.ewma,
                     cache=None if self._session is not None else self._cache0,
                     topology=self.topology, session=self._session)
        return p2, p2.plan(batches, q=q, backend=backend)

    def observe_step_time(self, stage: int, achieved_flops_per_sec: float) -> bool:
        """Straggler feedback: EWMA-update a stage's effective speed.

        Returns True when drift exceeds 10% — callers should re-plan.
        """
        s = self.stages[stage]
        new = self.ewma * achieved_flops_per_sec + (1 - self.ewma) * s.flops_per_sec
        drift = abs(new - s.flops_per_sec) / s.flops_per_sec
        self.stages[stage] = dataclasses.replace(s, flops_per_sec=new)
        return drift > 0.10
