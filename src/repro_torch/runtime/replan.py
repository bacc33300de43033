"""Event-stream replanning: live traffic in, plan updates out.

The port of ``repro/runtime/replan.py``: the same events, folding and
provenance, re-solving through the port's :class:`repro_torch.api.Session`
(on a ``"cuda"`` policy the warm entry and the kernels run on the card).

The paper's central claim is that staying optimal under change means
*re-solving the LP*, not patching the old schedule — the Min/Veeravalli/
Barlas-style heuristics drift or fail outright once the instance moves
(cs/0702066 catalogs the failure modes).  This module is the online half of
that claim: a typed event log describes what changed on the platform, an
:class:`EventStreamReplanner` folds each event into the current
:class:`repro_torch.api.Problem` and re-solves through one
:class:`repro_torch.api.Session`, and subscribers (``session.subscribe``) receive
every updated :class:`repro_torch.api.PlanArtifact` as it lands.

Two replan regimes, chosen per event:

* **warm** — coefficient-only events (:class:`SpeedObserved`) preserve the
  LP's row pattern (the :class:`repro_torch.lpir.PerturbedView` invariant), so the
  previous solve's exit basis seeds the engine's basis-seeded simplex entry
  and the re-solve usually pays zero phase-1 pivots.  A seed the engine
  rejects (the old vertex is no longer feasible) falls back to a cold
  two-phase solve inside the solver — never a wrong answer, only a slower
  one.
* **cold** — structural events (:class:`LoadArrived`,
  :class:`ProcessorDown`, :class:`ProcessorUp`) change the LP's shape, so
  the carried basis is meaningless and is dropped before the solve.

Every replanned artifact carries a ``{"kind": "replan", ...}`` provenance
event recording the trigger, the warm/cold decision, the engine's actual
basis reuse, and the pivot counts — the serving audit trail DESIGN.md §11
specifies.

This supersedes the offline what-if surface of
:class:`repro_torch.runtime.dlt_runner.ChainReplanner` (``replan`` /
``on_failure`` / ``what_if_speeds``): those re-solve hypotheticals from
scratch per call; this consumes an ordered stream and carries solver state
(basis, cache, subscriptions) across solves.  ``ChainReplanner.stream()``
opens one on the chain's session.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.api import Policy, Problem, Session
from repro_torch.obs import metrics as obs_metrics

__all__ = [
    "LoadArrived",
    "ProcessorDown",
    "ProcessorUp",
    "SpeedObserved",
    "EventStreamReplanner",
]


# ---------------- the event vocabulary ----------------


@dataclasses.dataclass(frozen=True)
class LoadArrived:
    """A new divisible load enters the system (structural: adds LP columns
    and rows, so the next solve is cold).  ``deadline`` (optional, absolute
    seconds) is recorded in the replan provenance together with whether the
    re-solved makespan meets it — the LP itself stays a pure makespan
    minimization (the paper's objective)."""

    v_comm: float
    v_comp: float
    release: float = 0.0
    return_ratio: float = 0.0
    deadline: float | None = None


@dataclasses.dataclass(frozen=True)
class ProcessorDown:
    """Processor ``index`` leaves.  Chain: its two incident links fuse
    (rates add in series, latencies sum — the store-and-forward path through
    the hole).  Star: the worker and its private link drop (the master,
    index 0, holds the data and cannot leave).  ``restore_delay`` floors the
    survivors' availability dates (checkpoint-restore time)."""

    index: int
    restore_delay: float = 0.0


@dataclasses.dataclass(frozen=True)
class ProcessorUp:
    """A processor joins at the tail of the chain (or as a new star worker)
    with its own link.  Structural: the next solve is cold."""

    w: float
    z: float
    latency: float = 0.0
    tau: float = 0.0


@dataclasses.dataclass(frozen=True)
class SpeedObserved:
    """Processor ``index`` is measured at ``w`` seconds/unit (straggler
    drift, thermal throttling, a time-shared host changing share — the
    arXiv 1902.01898 regime).  Coefficient-only: the LP row pattern is
    unchanged, so the previous basis warm-starts the re-solve."""

    index: int
    w: float


# events that keep the LP row pattern (and therefore the carried basis) valid
_COEFFICIENT_EVENTS = (SpeedObserved,)


# ---------------- event -> Problem folding ----------------


def _fold(problem: Problem, event) -> Problem:
    """The successor Problem after ``event`` (pure; raises on impossible
    events, e.g. dropping the star master or the last processor)."""
    if isinstance(event, SpeedObserved):
        m = len(problem.w)
        if not 0 <= event.index < m:
            raise ValueError(f"SpeedObserved.index {event.index} out of range [0, {m})")
        w = list(problem.w)
        w[event.index] = float(event.w)
        wpl = problem.w_per_load
        if wpl is not None:
            # unrelated-machine model: a speed observation rescales the whole
            # row (the per-load affinities are relative to the base speed)
            old = problem.w[event.index]
            scale = float(event.w) / old if old else 1.0
            wpl = tuple(
                tuple(v * scale for v in row) if i == event.index else row
                for i, row in enumerate(wpl)
            )
        return _rebuild(problem, w=w, w_per_load=wpl)

    if isinstance(event, LoadArrived):
        if event.deadline is not None and event.deadline < event.release:
            raise ValueError("LoadArrived.deadline precedes its release date")
        wpl = problem.w_per_load
        if wpl is not None:
            # new load's per-processor cost defaults to the base speeds
            wpl = tuple(row + (problem.w[i],) for i, row in enumerate(wpl))
        return _rebuild(
            problem,
            v_comm=problem.v_comm + (float(event.v_comm),),
            v_comp=problem.v_comp + (float(event.v_comp),),
            release=problem.release + (float(event.release),),
            return_ratio=problem.return_ratio + (float(event.return_ratio),),
            w_per_load=wpl,
        )

    if isinstance(event, ProcessorUp):
        wpl = problem.w_per_load
        if wpl is not None:
            wpl = wpl + (tuple(float(event.w) for _ in problem.v_comm),)
        return _rebuild(
            problem,
            w=problem.w + (float(event.w),),
            z=problem.z + (float(event.z),),
            latency=problem.latency + (float(event.latency),),
            tau=problem.tau + (float(event.tau),),
            w_per_load=wpl,
        )

    if isinstance(event, ProcessorDown):
        d, m = event.index, len(problem.w)
        if not 0 <= d < m:
            raise ValueError(f"ProcessorDown.index {d} out of range [0, {m})")
        if m <= 1:
            raise ValueError("cannot drop the last processor")
        z, lat = list(problem.z), list(problem.latency)
        if problem.topology == "star":
            if d == 0:
                raise ValueError("cannot drop the star master (it holds the data)")
            del z[d - 1], lat[d - 1]
        elif d == 0:
            del z[0], lat[0]
        elif d == m - 1:
            del z[-1], lat[-1]
        else:
            # store-and-forward through the hole: rates add in series,
            # latencies sum (Planner.replan_without_stage's link fusion)
            z[d - 1 : d + 1] = [z[d - 1] + z[d]]
            lat[d - 1 : d + 1] = [lat[d - 1] + lat[d]]
        keep = [i for i in range(m) if i != d]
        tau = [max(problem.tau[i], float(event.restore_delay)) for i in keep]
        wpl = problem.w_per_load
        if wpl is not None:
            wpl = tuple(wpl[i] for i in keep)
        return _rebuild(
            problem,
            w=[problem.w[i] for i in keep],
            z=z, latency=lat, tau=tau, w_per_load=wpl,
        )

    raise TypeError(f"unknown replan event {type(event).__name__}")


def _rebuild(problem: Problem, **changes) -> Problem:
    kw = dict(
        w=problem.w, z=problem.z, v_comm=problem.v_comm, v_comp=problem.v_comp,
        topology=problem.topology, tau=problem.tau, latency=problem.latency,
        release=problem.release, return_ratio=problem.return_ratio,
        w_per_load=problem.w_per_load,
    )
    kw.update(changes)
    return Problem(**kw)


# ---------------- the replanner ----------------


class EventStreamReplanner:
    """Fold a live event stream into successive LP re-solves.

    One replanner tracks one evolving problem through one session.  Each
    :meth:`apply` folds the event into the current problem, re-solves —
    warm-started from the previous exit basis when the event preserves the
    LP row pattern and ``warm=True`` — and publishes the artifact to the
    attached :class:`repro_torch.api.PlanSubscription` (created via
    ``session.subscribe`` when not handed in).

    The carried basis is pure data riding the artifacts
    (``telemetry["lp"]["final_basis"]``): the replanner owns no solver
    state, so it serializes/restarts trivially — rebuild it from the last
    artifact and keep consuming the stream.

    **Debouncing** (``debounce_window``, seconds): an observation storm —
    hundreds of :class:`SpeedObserved` ticks from a jittery monitor — would
    otherwise pay one full re-solve per tick.  With a window, coefficient
    events *fold immediately* (``self.problem`` always reflects every event
    seen) but the re-solve is deferred: the first buffered event opens a
    window, later events within it coalesce, and the solve fires at the
    first event on-or-after the window edge — one solve per window, however
    dense the storm (regression-tested).  There is no background thread
    (the Session deadline convention): a burst that simply *stops* inside
    its window re-solves at the next :meth:`apply`, :meth:`flush`, or
    :meth:`close`.  Structural events are never deferred — they flush any
    buffered folds into their own (cold) solve, so event ordering holds.
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(
        self,
        session: Session,
        problem: Problem,
        policy: Policy | None = None,
        *,
        warm: bool = True,
        backend=None,
        subscription=None,
        solve_initial: bool = True,
        debounce_window: float | None = None,
        clock=time.monotonic,
    ):
        if debounce_window is not None and debounce_window <= 0:
            raise ValueError("debounce_window must be > 0 (or None to disable)")
        self.session = session
        self.policy = policy if policy is not None else session.policy
        self.warm = warm
        self.backend = backend
        self.problem = problem
        self.artifact = None
        self._basis = None
        self.events: list = []  # the applied log, in order
        self.debounce_window = debounce_window
        self._clock = clock
        self._buffered: list = []  # folded-but-unsolved coefficient events
        self._window_deadline: float | None = None
        self.solve_count = 0  # re-solves actually dispatched (storm tests)
        if solve_initial:
            self.artifact = session.solve(problem, self.policy, backend=backend)
            self._basis = self._extract_basis(self.artifact)
        self.subscription = (
            subscription
            if subscription is not None
            else session.subscribe(problem, self.policy, backend=backend,
                                   artifact=self.artifact)
        )

    @staticmethod
    def _extract_basis(artifact):
        """The engine exit basis riding ``artifact`` (None when absent —
        serial backends, failed solves, v1 documents)."""
        telem = getattr(artifact, "telemetry", None)
        if not telem:
            return None
        return (telem.get("lp") or {}).get("final_basis")

    def apply(self, event):
        """Fold one event; re-solve now or coalesce it into the open window.

        Returns the newest artifact: the freshly re-solved one, or — when
        the event was debounced into an open window — the current plan
        (``self.problem`` is already ahead of it; the solve lands at the
        window edge).
        """
        self.problem = _fold(self.problem, event)
        self.events.append(event)
        if self.debounce_window is not None and isinstance(
                event, _COEFFICIENT_EVENTS):
            self._buffered.append(event)
            now = self._clock()
            if self._window_deadline is None:
                self._window_deadline = now + self.debounce_window
            if now < self._window_deadline:
                obs_metrics.get_registry().inc(
                    "repro_replan_coalesced_total",
                    trigger=type(event).__name__)
                return self.artifact
            return self._solve_buffered()
        # structural (or undebounced) path: buffered folds ride along in
        # this solve — one re-solve covers the whole backlog plus the event
        coalesced, self._buffered = self._buffered, []
        self._window_deadline = None
        return self._resolve(event, len(coalesced))

    def flush(self):
        """Force the deferred re-solve of any buffered events now.

        A no-op (returning the current artifact) when nothing is buffered;
        call it when a storm went quiet mid-window and the fresher plan is
        wanted before the next event arrives.
        """
        if not self._buffered:
            return self.artifact
        return self._solve_buffered()

    def _solve_buffered(self):
        batch, self._buffered = self._buffered, []
        self._window_deadline = None
        return self._resolve(batch[-1], len(batch) - 1)

    def _resolve(self, event, n_coalesced: int):
        """One actual re-solve, triggered by ``event`` (with ``n_coalesced``
        earlier events folded into the same LP); publishes the artifact."""
        trigger = type(event).__name__
        structural = not isinstance(event, _COEFFICIENT_EVENTS)
        seed = None if (structural or not self.warm) else self._basis
        self.solve_count += 1
        art = self.session.solve(
            self.problem, self.policy, backend=self.backend, warm_basis=seed,
        )

        telem = getattr(art, "telemetry", None) or {}
        lp = telem.get("lp") or {}
        # cache hits carry no exit basis; the coefficients are (quantized-)
        # identical to the solve that populated the slot, so the basis we
        # already hold stays valid for the NEXT perturbation.  Structural
        # events invalidate it regardless of how this solve was served.
        new_basis = lp.get("final_basis")
        if new_basis is not None:
            self._basis = new_basis
        elif structural:
            self._basis = None

        provenance = {
            "kind": "replan",
            "trigger": trigger,
            "warm_requested": seed is not None,
            "warm": bool(lp.get("warm", False)),
            "cache_hit": bool(art.cache_hit),
            "pivots_phase1": lp.get("pivots_phase1"),
            "pivots_phase2": lp.get("pivots_phase2"),
        }
        if n_coalesced:
            # debounce provenance: this solve answered a whole burst
            provenance["coalesced"] = int(n_coalesced)
        if isinstance(event, LoadArrived) and event.deadline is not None:
            provenance["deadline"] = float(event.deadline)
            provenance["deadline_met"] = bool(art.ok and art.makespan <= event.deadline)
        if art.version >= 2:
            art = dataclasses.replace(art, events=art.events + (provenance,))

        self.artifact = art
        met = obs_metrics.get_registry()
        met.inc("repro_replan_events_total", trigger=trigger,
                warm=str(provenance["warm"]).lower())
        self.subscription.publish(art, problem=self.problem)
        return art

    def replay(self, events) -> list:
        """Apply an ordered event batch; returns the artifacts, one per event."""
        return [self.apply(ev) for ev in events]

    def close(self) -> None:
        """Flush any buffered (debounced) events, then end the feed."""
        self.flush()
        self.subscription.close()
