"""The long-lived planning front door: N Session workers behind one queue.

The port of ``repro/serve/server.py``: the same queue, deadlines, drain and
wire format; the workers run the port's :class:`repro_torch.api.Session` on
``device`` (``None``: the CUDA card).  On the card each worker thread solves
under a CUDA stream of its own, so two workers' buckets overlap there.  The
HTTP handler threads never touch CUDA: they only enqueue work for the
workers and wait for its future.

``PlanServer`` turns the repo's one-shot ``Session`` API into a service:

* **admission queue** — bounded (``queue_limit``); a full queue rejects
  immediately with :class:`ServerBusy` (HTTP 429) instead of buffering
  without limit — backpressure is the contract, not best-effort latency.
* **worker pool** — ``workers`` threads, each owning its own
  :class:`repro_torch.api.Session`.  All sessions share ONE solution cache (the
  :class:`repro_torch.serve.store.TieredSolutionCache` when a ``store`` is
  given), so a plan solved by any worker — or by any *previous process*
  against the same store file — is a hit for every other.  A worker drains
  up to ``max_batch`` queued jobs at once and solves them in one
  ``solve_bulk`` call, so bursty traffic coalesces into the engine's buckets
  exactly like direct Session use.
* **deadlines** — every request carries one (``default_deadline_s`` when
  unset).  Expired jobs are dropped at dequeue (never solved dead) and
  resolve to :class:`DeadlineExceeded` (HTTP 504).
* **observability** — ``/healthz`` reports queue depth/worker/drain state
  as JSON; ``/metrics`` serves the process :mod:`repro_torch.obs.metrics`
  registry in the Prometheus text format; every request lands in
  ``repro_serve_requests_total{status=...}`` and the
  ``repro_serve_request_seconds`` histogram.
* **graceful drain** — ``close()`` stops admission, lets every already-
  admitted job solve, joins the workers, then stops the HTTP listener.
  Nothing admitted is ever lost; nothing new is accepted while draining.

The HTTP layer (stdlib ``ThreadingHTTPServer``) is optional: ``port=None``
runs the same queue/worker machinery in-process (``submit``/``plan``),
which is what the served-smoke test drives; ``port=0`` binds an ephemeral
port for real clients (:class:`repro_torch.serve.client.PlanClient`).

Wire format (POST /v1/plan)::

    {"problem": problem_to_dict(p), "policy": policy_to_dict(pol) | null,
     "deadline_s": 30.0}

-> 200 ``{"artifact": artifact.to_dict()}`` | 429 busy | 504 deadline |
400/500 ``{"error": ..., "kind": ...}``.  Artifacts travel in their
canonical v2 JSON encoding, so a served plan is byte-comparable (and
``diff()``-comparable) with a direct ``Session.solve`` of the same spec.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import queue
import threading
import time

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import span

__all__ = ["PlanServer", "ServerBusy", "DeadlineExceeded", "ServerClosed"]


class ServerBusy(RuntimeError):
    """Admission queue full — retry with backoff (HTTP 429)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before a worker reached it (HTTP 504)."""


class ServerClosed(RuntimeError):
    """The server is draining or closed; no new work is admitted."""


@dataclasses.dataclass
class _Job:
    problem: object
    policy: object
    deadline: float | None  # absolute time.monotonic()
    future: concurrent.futures.Future
    admitted: float  # time.perf_counter() at admission (queue-wait metric)


_SENTINEL = object()


class PlanServer:
    """See module docstring.

    ``store`` (path or :class:`~repro_torch.serve.store.PlanStore` or an already-
    built cache) persists plans across processes; ``None`` serves from a
    process-local in-memory cache only.  ``devices``/``n_shards`` forward
    to the engine's sharded fan-out (:mod:`repro_torch.serve.shard`) for every
    worker solve.  ``device`` is the workers' engine device (``None``: the
    card; ``"cpu"`` runs the kernels' plain versions); the default policy is
    ``Policy()`` (the serial backend), so callers who want the kernels pass
    ``Policy(backend="cuda")``.
    """

    def __init__(
        self,
        store=None,
        workers: int = 2,
        queue_limit: int = 256,
        max_batch: int = 64,
        default_deadline_s: float | None = 30.0,
        policy=None,
        port: int | None = None,
        devices=None,
        n_shards: int | None = None,
        device=None,
    ):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        from repro_torch.api import Policy

        self.default_policy = policy if policy is not None else Policy()
        self.default_deadline_s = default_deadline_s
        self.max_batch = max(1, int(max_batch))
        self.device = device
        self._met = obs_metrics.get_registry()
        self._queue: queue.Queue = queue.Queue(maxsize=queue_limit)
        self._closed = threading.Event()
        self._drained = threading.Event()
        self.cache = self._build_cache(store)
        self.sessions = []
        self._workers: list = []
        for i in range(workers):
            from repro_torch.api import Session

            s = Session(policy=self.default_policy, cache=self.cache,
                        max_batch=None, device=device)
            if devices is not None or n_shards is not None:
                # the worker's engine handle fans buckets out across devices
                h = s.backend(self.default_policy.backend)
                if hasattr(h, "devices"):
                    h.devices, h.n_shards = devices, n_shards
            self.sessions.append(s)
            t = threading.Thread(target=self._worker_loop,
                                 args=(i, s, self._worker_stream()),
                                 name=f"plan-worker-{i}", daemon=True)
            t.start()
            self._workers.append(t)
        self._http = None
        if port is not None:
            self._http = self._start_http(port)

    def _build_cache(self, store):
        from repro_torch.engine.cache import SolutionCache

        from .store import PlanStore, TieredSolutionCache

        if store is None:
            return SolutionCache(quantum=self.default_policy.cache_quantum)
        if isinstance(store, (SolutionCache, TieredSolutionCache)):
            return store
        if isinstance(store, (str, PlanStore)) or hasattr(store, "__fspath__"):
            return TieredSolutionCache(
                store, quantum=self.default_policy.cache_quantum)
        raise TypeError(
            f"store must be a path, PlanStore, or cache; got {type(store).__name__}")

    # ---------------- admission ----------------

    def submit(self, problem, policy=None, deadline_s: float | None = None
               ) -> concurrent.futures.Future:
        """Admit one request; returns a Future resolving to a PlanArtifact.

        Raises :class:`ServerClosed` while draining and :class:`ServerBusy`
        when the bounded queue is full — the caller (or the HTTP layer)
        owns the retry policy; the server never buffers beyond its bound.
        """
        if self._closed.is_set():
            self._met.inc("repro_serve_rejects_total", reason="closed")
            raise ServerClosed("server is draining; not accepting work")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        job = _Job(problem=problem,
                   policy=policy if policy is not None else self.default_policy,
                   deadline=deadline,
                   future=concurrent.futures.Future(),
                   admitted=time.perf_counter())
        try:
            self._queue.put_nowait(job)
        except queue.Full:
            self._met.inc("repro_serve_rejects_total", reason="busy")
            raise ServerBusy(
                f"admission queue full ({self._queue.maxsize} waiting)") from None
        self._met.inc("repro_serve_admitted_total")
        return job.future

    def plan(self, problem, policy=None, deadline_s: float | None = None):
        """Synchronous convenience: submit + wait; returns the PlanArtifact."""
        fut = self.submit(problem, policy, deadline_s)
        return fut.result(timeout=deadline_s)

    # ---------------- the worker loop ----------------

    def _worker_stream(self):
        """A new CUDA stream for one worker when the workers run on a card
        (made here, on the constructing thread, so a bad device raises in
        the constructor), else None.  A session whose engine needs a card
        that is not there still raises in its solve."""
        import torch  # deferred: the server needs torch only with its workers

        dev = torch.device("cuda" if self.device is None else self.device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        return torch.cuda.Stream(dev)

    def _worker_loop(self, idx: int, session, stream) -> None:
        if stream is None:
            self._serve_queue(idx, session)
            return
        import torch

        with torch.cuda.stream(stream):
            self._serve_queue(idx, session)

    def _serve_queue(self, idx: int, session) -> None:
        while True:
            job = self._queue.get()
            if job is _SENTINEL:
                return
            # coalesce: drain whatever else is already queued (bounded) so a
            # burst becomes one bulk engine call instead of N serial solves
            batch = [job]
            while len(batch) < self.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    self._queue.put(_SENTINEL)  # keep the pool's shutdown count
                    break
                batch.append(nxt)
            now = time.monotonic()
            live: list = []
            for j in batch:
                if j.deadline is not None and now >= j.deadline:
                    self._met.inc("repro_serve_requests_total", status="deadline")
                    j.future.set_exception(DeadlineExceeded(
                        "deadline expired while queued"))
                elif not j.future.set_running_or_notify_cancel():
                    self._met.inc("repro_serve_requests_total", status="cancelled")
                else:
                    live.append(j)
            if not live:
                continue
            t0 = time.perf_counter()
            try:
                with span("serve.request_batch", worker=idx, n=len(live)):
                    # per-job policies: group identical ones into one call
                    arts = self._solve_batch(session, live)
            except Exception as e:
                for j in live:
                    if not j.future.done():
                        j.future.set_exception(e)
                self._met.inc("repro_serve_requests_total", status="error")
                continue
            dt = time.perf_counter() - t0
            for j, art in zip(live, arts):
                self._met.observe("repro_serve_request_seconds",
                                  (time.perf_counter() - j.admitted))
                self._met.inc("repro_serve_requests_total",
                              status=art.status if art is not None else "error")
                j.future.set_result(art)
            self._met.observe("repro_serve_batch_seconds", dt, worker=idx)

    @staticmethod
    def _solve_batch(session, jobs: list) -> list:
        """Solve a mixed-policy batch, grouping same-policy runs together."""
        arts: list = [None] * len(jobs)
        i = 0
        while i < len(jobs):
            j = i + 1
            while j < len(jobs) and jobs[j].policy is jobs[i].policy:
                j += 1
            chunk = session.solve_bulk([x.problem for x in jobs[i:j]],
                                       jobs[i].policy)
            arts[i:j] = chunk
            i = j
        return arts

    # ---------------- lifecycle ----------------

    @property
    def draining(self) -> bool:
        return self._closed.is_set()

    def healthz(self) -> dict:
        """The liveness/readiness document ``GET /healthz`` serves."""
        return {
            "status": "draining" if self._closed.is_set() else "ok",
            "workers": len(self._workers),
            "queue_depth": self._queue.qsize(),
            "queue_limit": self._queue.maxsize,
            "cache": self.cache.stats(),
        }

    def close(self, drain: bool = True) -> None:
        """Stop the server.  ``drain=True`` (the only graceful mode) stops
        admission, solves everything already queued, joins the workers, and
        only then stops the HTTP listener — an admitted request is never
        dropped.  ``drain=False`` abandons queued jobs (their futures get
        :class:`ServerClosed`)."""
        if self._drained.is_set():
            return
        self._closed.set()
        if not drain:
            while True:
                try:
                    job = self._queue.get_nowait()
                except queue.Empty:
                    break
                if job is not _SENTINEL and not job.future.done():
                    job.future.set_exception(ServerClosed("server closed"))
        for _ in self._workers:
            self._queue.put(_SENTINEL)
        for t in self._workers:
            t.join()
        self._drained.set()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        self._met.inc("repro_serve_drains_total")

    def __enter__(self) -> "PlanServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ---------------- the HTTP front ----------------

    @property
    def port(self) -> int | None:
        """The bound HTTP port (None when running in-process only)."""
        return None if self._http is None else self._http.server_address[1]

    def _start_http(self, port: int):
        import http.server

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, doc: dict) -> None:
                self._send(code, json.dumps(doc).encode())

            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.startswith("/healthz"):
                    doc = server.healthz()
                    code = 200 if doc["status"] == "ok" else 503
                    self._send_json(code, doc)
                elif self.path.startswith("/metrics"):
                    text = obs_metrics.get_registry().prometheus_text()
                    self._send(200, text.encode(),
                               ctype="text/plain; version=0.0.4")
                else:
                    self._send_json(404, {"error": "not found", "kind": "http"})

            def do_POST(self):  # noqa: N802 — http.server API
                if self.path != "/v1/plan":
                    self._send_json(404, {"error": "not found", "kind": "http"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length))
                    from repro_torch.api.artifact import (
                        policy_from_dict,
                        problem_from_dict,
                    )

                    problem = problem_from_dict(req["problem"])
                    policy = (policy_from_dict(req["policy"])
                              if req.get("policy") is not None else None)
                    deadline_s = req.get("deadline_s")
                except Exception as e:
                    self._send_json(
                        400, {"error": str(e), "kind": "bad_request"})
                    return
                try:
                    art = server.plan(problem, policy, deadline_s)
                except ServerBusy as e:
                    self._send_json(429, {"error": str(e), "kind": "busy"})
                except ServerClosed as e:
                    self._send_json(503, {"error": str(e), "kind": "closed"})
                except (DeadlineExceeded, concurrent.futures.TimeoutError) as e:
                    self._send_json(
                        504, {"error": str(e) or "deadline", "kind": "deadline"})
                except Exception as e:
                    self._send_json(500, {"error": str(e), "kind": "error"})
                else:
                    # the artifact's own canonical encoding IS the wire body
                    self._send(200, ("{\"artifact\":" + art.to_json() + "}")
                               .encode())

            def log_message(self, *args):  # keep request noise off stderr
                pass

        class Listener(http.server.ThreadingHTTPServer):
            # the listen backlog: the stdlib's 5 (the reference's) drops the
            # connections of a burst beyond it, and each dropped client's
            # connect waits ~1 s for its retry; the admission queue's bound
            # is the backlog the server can take
            request_queue_size = max(5, self._queue.maxsize)
            daemon_threads = True

        http_server = Listener(("", port), Handler)
        t = threading.Thread(target=http_server.serve_forever, daemon=True,
                             name=f"plan-server:{http_server.server_address[1]}")
        t.start()
        return http_server
