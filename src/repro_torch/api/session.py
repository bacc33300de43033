"""The Session front door: one declarative entry point for every solve.

The port of ``repro/api/session.py``.  A :class:`Session` owns the three
pieces of serving state the entry points (``Planner.plan*``, campaigns)
would otherwise each re-create for themselves:

* the **backend registry handles** — resolved once per registry name, with
  the session's solution cache attached (engine backends replay repeated
  platform states instead of re-solving);
* the **solution cache** — one :class:`repro_torch.engine.cache.SolutionCache`
  keyed by the canonical content hash (:mod:`repro_torch.core.keys`), created
  lazily so a session that only ever runs serial backends never imports
  the engine (or torch);
* the **submission queue** — ``submit()`` returns a future-style
  :class:`PlanTicket` and the session coalesces tickets into micro-batches:
  a flush fires when the queue reaches ``max_batch``, when a submitted
  deadline expires, or when any ticket's ``result()`` is demanded.  Serving
  traffic therefore batches itself into the engine's buckets instead of
  relying on callers to hand-assemble them.

The engine backends are ``"torch"`` and ``"cuda"``.  ``"torch"`` runs on the
session's ``device`` (``None``: the CUDA card, raising where there is none;
``"cpu"``: the kernels' plain versions); ``"cuda"`` runs on the card with
the hand-written kernels and never degrades — a session whose device is the
CPU refuses it.  The device is resolved when the session first needs it (an
engine backend, ``evaluate_gammas``), so a session on a serial backend stays
NumPy.

Synchronous paths: ``solve(problem)`` for one plan, ``solve_bulk(problems)``
for a population in one engine call.  Every solve returns a versioned
:class:`repro_torch.api.PlanArtifact` (decision + provenance, JSON-round-trip
stable).

Ticket lifecycle contract (the fixed ``PlanService`` semantics):
``result()`` on a not-yet-flushed ticket auto-flushes the session;
``flush()`` with an empty queue is an idempotent no-op (it neither errors
nor counts as a flush); a ticket's artifact, once resolved, is pinned on
the ticket itself — there is no retention window to age out of.  Every
ticket always resolves: configuration errors raise at ``submit`` (to the
caller that made them), and a backend that raises mid-flush resolves its
group's tickets to ``status="error"`` artifacts before the error
propagates — a queued batch can never be wedged or lost.

There is no background thread: deadlines are checked at every session
call — ``submit``, ``solve``/``solve_bulk``, and every ``result``/``done``
poll — so a deadline guarantees the work flushes no later than the first
API call after it expires (and ``result()`` always resolves immediately).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import threading
import time

import numpy as np

from repro_torch.core.backends import SolveRequest, SolverBackend, get_backend
from repro_torch.core.instance import Instance
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from .artifact import PlanArtifact
from .spec import Policy, Problem

__all__ = ["Session", "PlanTicket", "PlanSubscription"]

# backends that consult the session's solution cache; resolved lazily so the
# cache (and with it the engine) is only constructed when actually needed
_ENGINE_BACKENDS = ("torch", "cuda")

# the serial-solver family: a bulk engine backend landing on one of these
# labels means the batched path handed the element to the per-instance
# reference solver (a "serial-rescue" provenance event)
_SERIAL_LABELS = ("auto", "serial", "simplex", "scipy", "simplex+scipy")


def _truncate_words(s: str, limit: int = 500) -> str:
    """Bound provenance strings without cutting mid-word (or mid-class-name)."""
    if len(s) <= limit:
        return s
    cut = s[:limit]
    sp = cut.rfind(" ")
    if sp > limit // 2:  # a word boundary near the limit: break there
        cut = cut[:sp]
    return cut + " ...[truncated]"


class PlanTicket:
    """Future-style handle for one submitted problem.

    Resolution is two-step: a flush *resolves* the ticket by pinning the
    solved reports on it (cheap — no artifact built yet), and the first
    ``result()``/``report()`` *materializes* the :class:`PlanArtifact` from
    them.  Submit-heavy streams that only sample some tickets therefore
    never pay artifact construction for the rest; error artifacts (a
    backend that raised mid-flush) are pinned eagerly, so failure
    provenance is never deferred.
    """

    def __init__(self, session: "Session", seq: int):
        self._session = session
        self._seq = seq
        self._artifact: PlanArtifact | None = None
        self._payload: tuple | None = None  # (pending, requests, reports)

    def _materialize(self) -> PlanArtifact:
        if self._artifact is None:
            assert self._payload is not None, \
                "flush() must resolve every pending ticket"
            p, reqs, chunk = self._payload
            self._artifact = self._session._reduce(p, reqs, chunk)
            self._payload = None
        return self._artifact

    def done(self) -> bool:
        """True once the ticket is resolved (checks expired deadlines)."""
        self._session._flush_expired()
        return self._artifact is not None or self._payload is not None

    def result(self) -> PlanArtifact:
        """The artifact — auto-flushes the session when still pending."""
        if self._artifact is None and self._payload is None:
            self._session.flush()
        else:  # resolved tickets still honor other tickets' expired deadlines
            self._session._flush_expired()
        return self._materialize()

    def report(self):
        """The underlying :class:`SolveReport`.

        Error artifacts (a backend that raised mid-flush) carry no live
        report, so one is synthesized with the artifact's failure status —
        report-surface consumers always get a report whose ``.ok`` is False
        rather than ``None``.
        """
        art = self.result()
        if art.report is not None:
            return art.report
        from repro_torch.core.backends import SolveReport
        from repro_torch.core.schedule import Schedule

        inst = art.instance()
        m, T = inst.m, inst.total_installments
        nan = float("nan")
        sched = Schedule(
            instance=inst,
            gamma=art.gamma,
            comm_start=np.full((max(m - 1, 0), T), nan),
            comm_end=np.full((max(m - 1, 0), T), nan),
            comp_start=np.full((m, T), nan),
            comp_end=np.full((m, T), nan),
            makespan=nan,
        )
        return SolveReport(
            schedule=sched, lp_makespan=nan, objective_value=nan,
            backend=art.backend, status=art.status,
            n_vars=art.n_vars, n_rows=art.n_rows,
        )


class PlanSubscription:
    """A live feed of plan updates for one evolving problem.

    Returned by :meth:`Session.subscribe`; a replanner — or any caller
    holding the handle — pushes re-solved artifacts with :meth:`publish`
    and consumers long-poll :meth:`next`.  Updates queue in publish order
    (bounded; oldest dropped), so a slow consumer never blocks a replan and
    never sees updates out of order.  Thread-safe: publish and next may
    race freely.
    """

    def __init__(self, session: "Session", problem, policy,
                 max_queue: int = 256):
        self.session = session
        self.problem = problem  # current problem state (replans update this)
        self.policy = policy
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque(maxlen=max_queue)
        self._latest: PlanArtifact | None = None
        self._closed = False

    def publish(self, artifact: PlanArtifact, problem=None) -> None:
        """Push one plan update (and optionally the evolved problem state)."""
        with self._cond:
            if self._closed:
                return
            if problem is not None:
                self.problem = problem
            self._latest = artifact
            self._queue.append(artifact)
            self._cond.notify_all()

    def next(self, timeout: float | None = None) -> PlanArtifact | None:
        """Long-poll the next plan update (FIFO).

        Blocks until an update is queued, the subscription closes, or
        ``timeout`` (seconds) elapses; returns ``None`` on timeout or
        close-with-empty-queue.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None
                wait = None if deadline is None else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    return None
                self._cond.wait(wait)
            return self._queue.popleft()

    def latest(self) -> PlanArtifact | None:
        """The most recently published artifact (does not consume the queue)."""
        with self._cond:
            return self._latest

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """End the feed: queued updates stay readable, blocked ``next`` calls
        wake and drain them, then return ``None``."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __iter__(self):
        while True:
            art = self.next()
            if art is None and self._closed and not self._queue:
                return
            if art is not None:
                yield art


@dataclasses.dataclass
class _Pending:
    seq: int
    problem: Problem
    policy: Policy
    backend_override: object  # SolverBackend instance or None
    handle: object  # the backend resolved AT SUBMIT (config errors hit the submitter)
    priority: int
    deadline: float | None  # absolute time.monotonic() deadline
    ticket: PlanTicket
    warm_basis: object = None  # per-problem engine warm-start seed


class Session:
    """See module docstring.  ``policy`` is the session default; every
    ``solve``/``submit`` accepts a per-call ``policy`` (and, for the
    compatibility shims, a resolved backend instance) override.

    ``max_batch`` bounds the coalescing queue: the ``max_batch``-th pending
    submit triggers a flush.  ``None`` disables size-triggered flushing
    (explicit ``flush()``/``result()``-driven only).

    ``device`` is where the engine runs (see the module docstring).
    ``store=`` (a path or :class:`repro_torch.serve.PlanStore`) persists
    the session's plans: the cache becomes a
    :class:`repro_torch.serve.TieredSolutionCache` over it on first engine
    use; passing both ``cache=`` and ``store=`` raises.
    """

    def __init__(
        self,
        policy: Policy | None = None,
        cache=None,
        max_batch: int | None = 64,
        metrics=None,
        store=None,
        device=None,
    ):
        self.policy = policy if policy is not None else Policy()
        if max_batch is not None and max_batch < 1:
            raise ValueError("max_batch must be >= 1 (or None to disable)")
        if store is not None and cache is not None:
            raise ValueError(
                "pass either cache= or store= (a store builds its own "
                "TieredSolutionCache); not both")
        self.max_batch = max_batch
        self._device = device  # resolved on first engine use (self.device)
        self._cache = cache  # the default-quantum cache (None until needed)
        self._store = store  # path/PlanStore -> tiered cache on first engine use
        self._extra_caches: dict = {}  # per-call cache_quantum overrides
        self._backends: dict = {}
        self._pending: list[_Pending] = []
        self._next_deadline: float | None = None  # earliest absolute deadline queued
        self._seq = 0
        self._unreported_submits = 0  # counted locally, flushed to metrics in batch
        self.flush_count = 0  # completed (non-empty) flushes, for coalescing tests
        self._metrics = metrics  # None -> follow the process registry
        # one coarse reentrant lock over the submit/flush/solve bookkeeping:
        # the queue append + seq bump + deadline arm in submit, and the
        # queue swap + per-ticket resolution in flush, are multi-step
        # critical sections — two threads interleaving them lose tickets or
        # resolve one twice.  Reentrant because submit can trigger flush
        # (max_batch/deadline) and result() auto-flushes while a flush may
        # already hold the lock on this thread.
        self._lock = threading.RLock()

    @property
    def metrics(self):
        """The metrics registry this session records into.

        An explicit ``metrics=`` pins one (isolation for tests/benchmarks);
        the default follows the process registry, so a later
        :func:`repro_torch.obs.metrics.set_registry` takes effect immediately.
        """
        return self._metrics if self._metrics is not None else obs_metrics.get_registry()

    @property
    def device(self):
        """The engine's device as a ``torch.device``: resolved (and, for the
        card, checked to exist — raising where there is none) on every
        call, so only sessions that use the engine ever import torch."""
        from repro_torch.convert import resolve_device  # deferred: torch

        return resolve_device(self._device)

    # ---------------- observability ----------------

    @contextlib.contextmanager
    def trace(self, tracer: obs_trace.Tracer | None = None):
        """Record spans for everything this session does inside the block.

        Activates ``tracer`` (a fresh one by default) process-wide for the
        duration, opens a ``session.trace`` root span, and restores the
        previous tracer on exit.  Yields the tracer; export with
        ``tracer.save(path)`` (Chrome trace-event JSON — load in
        ``chrome://tracing`` or Perfetto) or inspect ``tracer.events()``::

            with session.trace() as tr:
                session.solve_bulk(problems)
            tr.save("build/session.trace.json")
        """
        tracer = tracer if tracer is not None else obs_trace.Tracer()
        prev = obs_trace.activate(tracer)
        try:
            with obs_trace.span("session.trace"):
                yield tracer
        finally:
            obs_trace.activate(prev)

    # ---------------- cache / backend plumbing ----------------

    @property
    def cache(self):
        """The session solution cache, created on first engine use.

        A session constructed with ``store=`` (a path or
        :class:`repro_torch.serve.PlanStore`) builds a
        :class:`repro_torch.serve.TieredSolutionCache` over it instead of the
        plain in-memory LRU, so its plans persist across processes.
        """
        if self._cache is None:
            if self._store is not None:
                from repro_torch.serve.store import TieredSolutionCache

                self._cache = TieredSolutionCache(
                    self._store, quantum=self.policy.cache_quantum)
            else:
                from repro_torch.engine.cache import SolutionCache  # deferred: engine pkg

                self._cache = SolutionCache(quantum=self.policy.cache_quantum)
        return self._cache

    @cache.setter
    def cache(self, value) -> None:
        self._cache = value
        self._backends.clear()  # resolved handles carry the old cache

    def _cache_for(self, quantum: float):
        """The cache serving requests keyed at ``quantum``.

        An explicitly seeded cache IS the session cache: seeding overrides
        the policy default, so session-default requests use it at its own
        quantum (the ``Planner(cache=...)`` contract).  Only a per-call
        ``cache_quantum`` that differs from the session default gets its own
        cache (keys quantized differently cannot share slots) — unless the
        seeded cache's actual quantum already matches it.
        """
        if self._cache is not None and (
            quantum == self.policy.cache_quantum
            or getattr(self._cache, "quantum", None) == quantum
        ):
            return self._cache
        if self._cache is None and quantum == self.policy.cache_quantum:
            return self.cache  # creates the default-quantum cache
        if quantum not in self._extra_caches:
            from repro_torch.engine.cache import SolutionCache  # deferred: engine pkg

            self._extra_caches[quantum] = SolutionCache(quantum=quantum)
        return self._extra_caches[quantum]

    def backend(self, spec, fallback: bool = True, quantum: float | None = None):
        """Resolve a backend name/instance with the session cache attached.

        Name resolutions are memoized per (name, fallback, quantum);
        instances pass through :func:`repro_torch.core.backends.get_backend`
        (cache adoption by shallow copy, never mutating the caller's
        instance).  Serial backends ignore the solution cache, so resolving
        one never drags the engine in just to build a cache.
        """
        quantum = self.policy.cache_quantum if quantum is None else quantum
        if not isinstance(spec, str):
            # memoized per instance identity so a bulk call over one
            # instance override resolves ONE handle (and therefore ONE
            # solve_many); the memo keeps a strong ref to the spec, which
            # also guards the id() key against reuse after a GC
            key = ("instance", id(spec), fallback, quantum)
            hit = self._backends.get(key)
            if hit is not None and hit[0] is spec:
                return hit[1]
            # attach a cache only when the instance can use one (engine
            # family) or one already exists — keeps serial-instance solves
            # from importing the engine
            if getattr(spec, "name", None) in _ENGINE_BACKENDS:
                handle = get_backend(spec, cache=self._cache_for(quantum))
                if getattr(handle, "fallback", fallback) != fallback:
                    if handle is spec:  # never mutate the caller's instance
                        handle = copy.copy(spec)
                    handle.fallback = fallback
            else:
                handle = get_backend(spec, cache=self._cache)
            self._backends[key] = (spec, handle)
            # bound the per-instance memo so a stream of ephemeral override
            # objects cannot accrete for the session's lifetime
            inst_keys = [k for k in self._backends if k[0] == "instance"]
            if len(inst_keys) > 32:
                del self._backends[inst_keys[0]]
            return handle
        key = (spec, fallback, quantum)
        if key not in self._backends:
            if spec in _ENGINE_BACKENDS:
                handle = self._engine_backend(spec, self._cache_for(quantum))
                handle.fallback = fallback
            else:
                handle = get_backend(spec, cache=self._cache)
            self._backends[key] = handle
        return self._backends[key]

    def _engine_backend(self, name: str, cache) -> SolverBackend:
        """A fresh engine backend on this session's device.  ``"cuda"`` on a
        session whose device is not a card raises: it never degrades."""
        from repro_torch.engine.service import CudaBackend, TorchBackend  # deferred: torch

        dev = self.device
        if name == "torch":
            return TorchBackend(cache=cache, device=dev)
        if dev.type != "cuda":
            raise ValueError(
                f"the 'cuda' backend runs on the card; this session's device is {dev}")
        return CudaBackend(cache=cache, device=dev)

    # ---------------- synchronous front door ----------------

    def solve(self, problem, policy: Policy | None = None, *, backend=None,
              warm_basis=None) -> PlanArtifact:
        """Solve one problem (auto-T sweeps included) into a PlanArtifact.

        ``warm_basis`` seeds the engine's basis-seeded simplex entry (the
        replan hot path) — pass ``telemetry["lp"]["final_basis"]`` of a
        previous solve of a perturbed sibling; unusable seeds fall back to a
        cold solve transparently (serial backends ignore it entirely).
        """
        return self.solve_bulk([problem], policy, backend=backend,
                               warm_starts=None if warm_basis is None else [warm_basis])[0]

    def solve_bulk(self, problems, policy: Policy | None = None, *, backend=None,
                   warm_starts=None) -> list:
        """Solve a population in one bulk call; artifacts in caller order.

        ``problems`` may be :class:`Problem` specs or legacy
        :class:`Instance` objects (whose ``q`` becomes the fixed
        installment plan for that element).  ``warm_starts`` (optional,
        parallel to ``problems``) carries per-problem engine warm-start
        bases — see :meth:`solve`.
        """
        if warm_starts is not None and len(warm_starts) != len(problems):
            raise ValueError(
                f"warm_starts must parallel problems "
                f"({len(warm_starts)} != {len(problems)})")
        with self._lock:
            self._flush_expired()  # synchronous traffic still honors queued deadlines
            policy = policy if policy is not None else self.policy
            with obs_trace.span("session.solve_bulk", n=len(problems)):
                work = [
                    self._make_pending(
                        p, policy, backend, seq=-1, priority=0, deadline=None,
                        warm_basis=None if warm_starts is None else warm_starts[i],
                    )
                    for i, p in enumerate(problems)
                ]
                self._solve_pending(work)
                return [w.ticket._materialize() for w in work]

    def evaluate_gammas(self, instances, gammas, use_batched: bool = True) -> np.ndarray:
        """Achieved makespans of explicit fraction assignments (bulk replay).

        The evaluation counterpart of ``solve_bulk`` — heuristic sweeps and
        what-if campaigns replay (instance, gamma) pairs through the batched
        ASAP replay on the session's device (the replay kernel on the card),
        or the serial reference with ``use_batched=False``.
        """
        instances = [
            p.to_instance(self.policy.q_for(p)) if isinstance(p, Problem) else p
            for p in instances
        ]
        if use_batched:
            from repro_torch.engine.batched_sim import makespans  # deferred: torch

            return np.asarray(makespans(instances, gammas, device=self.device))
        from repro_torch.core.simulator import simulate

        return np.array([simulate(i, g).makespan for i, g in zip(instances, gammas)])

    # ---------------- coalescing async front door ----------------

    def submit(
        self,
        problem,
        policy: Policy | None = None,
        *,
        priority: int = 0,
        deadline: float | None = None,
        backend=None,
    ) -> PlanTicket:
        """Queue one problem; returns a future-style :class:`PlanTicket`.

        ``priority`` orders *solving* within a flush (higher first): when a
        flush spans several backends (or a serial backend's per-request
        loop), higher-priority work is handed over first — so it is already
        resolved if a later group fails.  Ticket resolution is otherwise
        batch-atomic: every artifact of one engine bucket lands together.
        ``deadline`` (seconds from now) bounds coalescing latency: the
        queue flushes no later than the first session call after it
        expires.  A full queue (``max_batch``) flushes immediately.

        Configuration errors — an unknown backend name, an installment
        tuple that does not match the problem's loads — raise HERE, to the
        caller that made them; a queued batch can therefore never be
        poisoned by someone else's bad submit.
        """
        abs_deadline = None if deadline is None else time.monotonic() + float(deadline)
        with self._lock:
            with obs_trace.span("session.submit", priority=int(priority)):
                p = self._make_pending(
                    problem, policy if policy is not None else self.policy, backend,
                    seq=self._seq, priority=int(priority), deadline=abs_deadline,
                )
            # submit-queue bookkeeping is batched: the submit counter is kept
            # locally and pushed to the registry once per flush (one labelled-key
            # format + lock per batch instead of per submit on the serving path)
            self._unreported_submits += 1
            self._pending.append(p)
            self._seq += 1
            if abs_deadline is not None and (
                self._next_deadline is None or abs_deadline < self._next_deadline
            ):
                self._next_deadline = abs_deadline
            if self.max_batch is not None and len(self._pending) >= self.max_batch:
                self.flush()
            else:
                self._flush_expired()
            return p.ticket

    def _make_pending(self, problem, policy, backend, *, seq, priority, deadline,
                      warm_basis=None) -> _Pending:
        """Coerce + validate one submission (backend resolution and the
        policy/problem installment match happen now, not at flush)."""
        prob, pol = self._coerce(problem, policy)
        pol.q_candidates(prob)  # raises on installments/n_loads mismatch
        handle = self.backend(
            backend if backend is not None else pol.backend,
            fallback=pol.fallback, quantum=pol.cache_quantum,
        )
        return _Pending(
            seq=seq, problem=prob, policy=pol, backend_override=backend,
            handle=handle, priority=priority, deadline=deadline,
            ticket=PlanTicket(self, seq), warm_basis=warm_basis,
        )

    def flush(self) -> list:
        """Solve everything queued (idempotent; empty queue is a no-op).

        Returns the new artifacts in submission order.  A solver error
        (e.g. the engine raising with ``fallback=False``) does NOT lose
        the batch: the failing group's tickets resolve to failed
        artifacts (``status="error"``), every other group still solves,
        and the first error re-raises after the batch is resolved —
        nothing is ever left wedged in the queue.
        """
        with self._lock:
            if not self._pending:
                return []
            batch, self._pending = self._pending, []
            self._next_deadline = None
            if self._unreported_submits:
                self.metrics.inc("repro_session_submits_total", self._unreported_submits)
                self._unreported_submits = 0
            try:
                with obs_trace.span("session.flush", n=len(batch)):
                    # the queue is already in seq order; only sort when some
                    # ticket actually asked for non-default priority
                    if any(p.priority for p in batch):
                        work = sorted(batch, key=lambda p: (-p.priority, p.seq))
                    else:
                        work = batch
                    self._solve_pending(work)
            except BaseException:
                # backstop (solver errors are handled per group): re-queue
                # whatever was left unresolved so no ticket is ever lost
                self._pending = [
                    p for p in batch
                    if p.ticket._artifact is None and p.ticket._payload is None
                ] + self._pending
                self._recompute_deadline()
                raise
            self.flush_count += 1
            self.metrics.inc("repro_session_flushes_total")
            return [p.ticket._materialize() for p in batch]

    def _flush_expired(self) -> None:
        # O(1) on the hot path: only scan when an armed deadline expired
        with self._lock:
            if self._next_deadline is not None and time.monotonic() >= self._next_deadline:
                self.flush()

    # ---------------- subscriptions (online replanning) ----------------

    def subscribe(
        self,
        problem,
        policy: Policy | None = None,
        *,
        backend=None,
        artifact: PlanArtifact | None = None,
    ) -> PlanSubscription:
        """Open a live plan feed for ``problem``.

        Solves the problem once (unless an already-solved ``artifact`` is
        handed in to adopt) and returns a :class:`PlanSubscription` seeded
        with that plan; replanners push updates into the handle with
        ``publish`` and consumers long-poll ``handle.next()``.  The session
        itself stays passive — there is no background thread; what *drives*
        updates is whoever consumes the event stream (see
        a replanner).
        """
        pol = policy if policy is not None else self.policy
        sub = PlanSubscription(self, problem, pol)
        if artifact is None:
            artifact = self.solve(problem, pol, backend=backend)
        sub.publish(artifact)
        self.metrics.inc("repro_session_subscriptions_total")
        return sub

    def _recompute_deadline(self) -> None:
        armed = [p.deadline for p in self._pending if p.deadline is not None]
        self._next_deadline = min(armed) if armed else None

    # ---------------- stats ----------------

    def stats(self) -> dict:
        """Session counters in the historical dict shape.

        .. deprecated::
           A shim — the unified, cross-component view is the metrics
           registry (``repro_session_*`` / ``repro_cache_*``):
           ``session.metrics.snapshot()``.  The dict shape
           is frozen for old call sites; new keys are appended, never
           renamed.
        """
        out = {
            "pending": len(self._pending),
            "flushes": self.flush_count,
            "backends": sorted(k[0] for k in self._backends),
        }
        if self._cache is not None:
            out["cache"] = self._cache.stats()
        return out

    # ---------------- internals ----------------

    @staticmethod
    def _coerce(problem, policy: Policy) -> tuple:
        """Normalize a Problem | Instance | SolveRequest into (Problem, Policy)."""
        if isinstance(problem, Problem):
            return problem, policy
        if isinstance(problem, SolveRequest):
            req = problem
            prob = Problem.from_instance(req.instance)
            return prob, dataclasses.replace(
                policy,
                installments=req.instance.q,
                auto_t=False,
                objective=req.objective,
                weights=None if req.weights is None else tuple(
                    float(x) for x in np.asarray(req.weights, dtype=np.float64)
                ),
                beta=req.beta,
                cross_check=req.cross_check,
                validate=req.validate,
            )
        if isinstance(problem, Instance):
            return Problem.from_instance(problem), dataclasses.replace(
                policy, installments=problem.q, auto_t=False
            )
        raise TypeError(
            f"expected Problem, Instance, or SolveRequest; got {type(problem).__name__}"
        )

    def _solve_pending(self, work: list) -> None:
        """Solve a list of _Pending in place (sets every ticket's artifact).

        All candidates of all pending items that share a backend handle go
        to it in ONE ``solve_many`` call — the engine buckets them by
        ``(topology, has_returns, m, T, q)`` internally, so an auto-T sweep
        and a hundred distinct submits coalesce into a handful of batched
        solves.  A group whose backend raises resolves its tickets to
        failed artifacts; the remaining groups still solve, and the first
        error re-raises once every ticket is resolved.
        """
        groups: dict = {}  # id(handle) -> (handle, [(pending, [requests])])
        with obs_trace.span("session.build_requests", n=len(work)):
            for p in work:
                reqs = [
                    SolveRequest(
                        instance=p.problem.to_instance(q),
                        objective=p.policy.objective,
                        weights=p.policy.weights,
                        beta=p.policy.beta,
                        cross_check=p.policy.cross_check,
                        validate=p.policy.validate,
                        warm_basis=p.warm_basis,
                    )
                    for q in p.policy.q_candidates(p.problem)
                ]
                groups.setdefault(id(p.handle), (p.handle, []))[1].append((p, reqs))
        first_error: BaseException | None = None
        for handle, items in groups.values():
            flat = [r for _, reqs in items for r in reqs]
            try:
                with obs_trace.span(
                    "session.dispatch",
                    backend=getattr(handle, "name", type(handle).__name__),
                    n=len(flat),
                ):
                    reports = handle.solve_many(flat)
                with obs_trace.span("session.make_artifacts", n=len(flat)):
                    # resolve lazily: pin the reports; the artifact is built
                    # at first result()/report() (or at flush()'s return)
                    k = 0
                    for p, reqs in items:
                        chunk = reports[k : k + len(reqs)]
                        k += len(reqs)
                        p.ticket._payload = (p, reqs, chunk)
            except Exception as e:
                # solver errors only — KeyboardInterrupt/SystemExit propagate
                # immediately (flush's backstop re-queues unresolved tickets).
                # Failure artifacts pin eagerly: provenance is never deferred.
                for p, reqs in items:
                    if p.ticket._artifact is None and p.ticket._payload is None:
                        p.ticket._artifact = self._failed_artifact(p, reqs[0], e)
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error

    def _reduce(self, p: _Pending, reqs: list, reports: list) -> PlanArtifact:
        """Pick the winning rung (auto-T) and build the artifact."""
        qs = [r.instance.q for r in reqs]
        if len(reports) == 1 and not p.policy.auto_t:
            return self._artifact(p, qs[0], reports[0], sweep=None, sweep_reports=reports)
        makespans, costs = {}, {}
        for q, rep in zip(qs, reports):
            if not rep.ok:
                continue
            makespans[q] = rep.makespan
            costs[q] = rep.makespan + p.policy.installment_cost * sum(q)
        if not costs:
            # every rung failed: surface the first attempt's failure verbatim
            return self._artifact(p, qs[0], reports[0], sweep=None, sweep_reports=reports)
        best = min(costs.values())
        # ties break toward fewer installments (within 1e-12 relative)
        t_star = min(
            (q for q, c in costs.items() if c <= best * (1 + 1e-12) + 1e-12),
            key=sum,
        )
        k = qs.index(t_star)
        sweep = {
            "qs": [list(q) for q in qs],
            "makespans": [makespans.get(q) for q in qs],
            "costs": [costs.get(q) for q in qs],
            "t_star_index": k,
        }
        return self._artifact(p, t_star, reports[k], sweep=sweep, sweep_reports=reports)

    @staticmethod
    def _requested_backend(p: _Pending) -> str:
        """The backend name the caller asked for (override included)."""
        if p.backend_override is None:
            return p.policy.backend
        return getattr(p.backend_override, "name", type(p.backend_override).__name__)

    def _failed_artifact(self, p: _Pending, req: SolveRequest, error: BaseException) -> PlanArtifact:
        """A resolved-but-failed artifact for a group whose backend raised —
        the ticket holds the error provenance instead of wedging the queue.

        The exception class survives verbatim (it is its own event field,
        never part of the truncated message), the cause chain is recorded
        class-by-class, and the message truncates at a word boundary — the
        historical ``str(event)[:200]`` cut mid-word and could swallow the
        class of a nested fallback's root cause entirely.
        """
        requested = self._requested_backend(p)
        chain, seen = [], set()
        e: BaseException | None = error
        while e is not None and id(e) not in seen:
            seen.add(id(e))
            chain.append(type(e).__name__)
            e = e.__cause__ if e.__cause__ is not None else e.__context__
        reason = _truncate_words(str(error))
        event = {
            "kind": "error",
            "backend": requested,
            "reason": reason,
            "error_type": type(error).__name__,
            "error_chain": chain,
        }
        self.metrics.inc("repro_session_errors_total", backend=requested)
        self.metrics.inc("repro_session_events_total", kind="error")
        q = tuple(int(x) for x in req.instance.q)
        return PlanArtifact(
            problem=p.problem,
            policy=p.policy,
            q=q,
            gamma=np.full((p.problem.m, sum(q)), np.nan),
            makespan=float("nan"),
            lp_makespan=float("nan"),
            objective_value=float("nan"),
            status="error",
            backend=requested,
            cache_hit=False,
            fallback_events=(f"error:{type(error).__name__}: {reason}",),
            events=(event,),
            n_vars=-1,
            n_rows=-1,
        )

    def _artifact(self, p: _Pending, q: tuple, report, sweep, sweep_reports) -> PlanArtifact:
        label = report.backend
        cache_hit = label.endswith("+cache")
        requested = self._requested_backend(p)
        base = label[: -len("+cache")] if cache_hit else label
        # the label the requested backend gives its own results: "torch"
        # on the card labels them "cuda" (the same path, through the kernels)
        own = getattr(p.handle, "label", requested)
        # "auto"/"serial" delegate by design — any serial label matches them;
        # everything else that changed hands is provenance worth recording
        # (engine fallback to the serial solver, the simplex's scipy
        # rescue, ...).  "cuda" never degrades, so there is no degrade kind.
        telemetry = getattr(report, "telemetry", None)
        if requested in ("auto", "serial") or base in (requested, own):
            legacy: tuple = ()
            events: tuple = ()
        else:
            legacy = (f"served_by:{base}",)
            # classify WHY the serving backend differs from the requested one
            if requested in _ENGINE_BACKENDS and base in _SERIAL_LABELS:
                kind = "serial-rescue"  # bulk path certified this element serially
            elif base.startswith(requested + "+"):
                kind = "rescue"  # e.g. simplex+scipy: numerical rescue mid-solve
            else:
                kind = "fallback"
            reason = ""
            if telemetry is not None:
                rescue = telemetry.get("serial_rescue")
                if rescue is not None:
                    reason = str(rescue.get("reason", ""))
            events = ({"kind": kind, "backend": base, "reason": reason},)
            self.metrics.inc("repro_session_events_total", kind=kind)
        if report.ok:
            gamma = np.asarray(report.schedule.gamma, dtype=np.float64)
        else:
            inst = report.request.instance if report.request is not None else None
            shape = (
                (inst.m, inst.total_installments)
                if inst is not None
                else (p.problem.m, sum(q))
            )
            gamma = np.full(shape, np.nan)
        return PlanArtifact(
            problem=p.problem,
            policy=p.policy,
            q=tuple(int(x) for x in q),
            gamma=gamma,
            makespan=float(report.makespan) if report.ok else float("nan"),
            lp_makespan=float(report.lp_makespan),
            objective_value=float(report.objective_value),
            status=report.status,
            backend=label,
            cache_hit=cache_hit,
            fallback_events=legacy,
            events=events,
            telemetry=telemetry,
            n_vars=report.n_vars,
            n_rows=report.n_rows,
            sweep=sweep,
            report=report,
            sweep_reports=tuple(sweep_reports),
        )
