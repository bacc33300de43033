"""Span tracer: nested, thread-safe, Chrome-trace/Perfetto exportable.

Design constraints (DESIGN.md §8):

* **near-zero overhead when disabled** — library call sites use the
  module-level :func:`span` free function; when no tracer is active it
  returns one shared no-op singleton, so the hot path costs one global
  read and one identity return (no allocation, asserted by
  tests/test_obs.py);
* **balanced under exceptions** — a span records at ``__exit__`` whatever
  propagates through it, tagging the event with the exception class, so
  traces of failing runs still close every span;
* **thread-safe** — events append under a lock; the recording thread id
  becomes the Chrome-trace ``tid`` so per-thread lanes nest correctly;
* **exportable** — ``to_chrome_trace()`` emits the Trace Event Format
  (``ph: "X"`` complete events, microsecond timestamps) that
  ``chrome://tracing`` and Perfetto load directly; ``save(path)`` writes
  it as JSON.

Nesting needs no explicit bookkeeping: complete events nest by timestamp
containment per thread, which the context-manager discipline guarantees.
"""

from __future__ import annotations

import json
import threading
import time

__all__ = ["Tracer", "span", "activate", "get_tracer", "NOOP_SPAN"]


class _NoopSpan:
    """The shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span; records itself on ``__exit__`` (always, even when an
    exception is propagating — the event is tagged with the class name)."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter_ns() - self._t0
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self._tracer._record(self.name, self._t0, dur, self.args)
        return False

    def set(self, **attrs):
        """Attach attributes to the span mid-flight (shown as Chrome args)."""
        self.args.update(attrs)
        return self


class Tracer:
    """Collects spans; export with :meth:`to_chrome_trace` / :meth:`save`."""

    def __init__(self, process_name: str = "repro"):
        self.process_name = process_name
        self._lock = threading.Lock()
        self._events: list = []  # (name, t0_ns, dur_ns, tid, args)
        self._epoch_ns = time.perf_counter_ns()

    # ---------------- recording ----------------

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def _record(self, name: str, t0_ns: int, dur_ns: int, args: dict) -> None:
        tid = threading.get_ident()
        with self._lock:
            self._events.append((name, t0_ns, dur_ns, tid, args))

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._epoch_ns = time.perf_counter_ns()

    def __len__(self) -> int:
        return len(self._events)

    # ---------------- inspection ----------------

    def events(self) -> list:
        """Recorded events as dicts (name, ts_us, dur_us, tid, args), sorted
        by start time — parents precede their children."""
        with self._lock:
            evs = list(self._events)
        out = [
            {
                "name": name,
                "ts_us": (t0 - self._epoch_ns) / 1e3,
                "dur_us": dur / 1e3,
                "tid": tid,
                "args": dict(args),
            }
            for name, t0, dur, tid, args in evs
        ]
        out.sort(key=lambda e: (e["ts_us"], -e["dur_us"]))
        return out

    def total_us(self, name: str) -> float:
        """Summed duration of every span called ``name`` (microseconds)."""
        return sum(e["dur_us"] for e in self.events() if e["name"] == name)

    # ---------------- export ----------------

    def to_chrome_trace(self) -> dict:
        """The Trace Event Format dict chrome://tracing / Perfetto load."""
        trace_events = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "tid": 0,
                "args": {"name": self.process_name},
            }
        ]
        for e in self.events():
            trace_events.append(
                {
                    "name": e["name"],
                    "ph": "X",
                    "ts": e["ts_us"],
                    "dur": e["dur_us"],
                    "pid": 1,
                    "tid": e["tid"],
                    "args": e["args"],
                }
            )
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path`` (load it in Perfetto)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, default=str)
        return path


# --------------------------------------------------------------------------
# the module-level active tracer (what library call sites consult)
# --------------------------------------------------------------------------

_ACTIVE: Tracer | None = None


def activate(tracer: Tracer | None) -> Tracer | None:
    """Install ``tracer`` as the process-wide active tracer (None disables);
    returns the previous one so callers can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    return prev


def get_tracer() -> Tracer | None:
    return _ACTIVE


def span(name: str, **args):
    """A span on the active tracer — or the shared no-op when tracing is off.

    This is the call every instrumented hot path makes; with no active
    tracer it is a global read plus an identity return.
    """
    tr = _ACTIVE
    if tr is None:
        return NOOP_SPAN
    return tr.span(name, **args)
