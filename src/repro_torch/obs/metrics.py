"""Metrics registry: counters / gauges / histograms with label sets.

One documented key schema for the whole stack (DESIGN.md §8) replaces the
historical ad-hoc ``stats()`` dicts.  Names follow the Prometheus
conventions — snake case, ``repro_`` prefix, ``_total`` suffix on
counters, base-unit suffixes (``_seconds``, ``_ratio``); labels carry the
low-cardinality dimensions (backend, topology, status, phase, stage).

* ``snapshot()`` returns a flat ``{rendered_key: value}`` dict with sorted
  keys and sorted labels — two registries that saw the same sequence of
  operations snapshot identically (property-tested), so snapshots can be
  diffed, asserted on, and merged into bench summaries.
* ``prometheus_text()`` emits the text exposition format;
  :func:`start_metrics_server` serves it over HTTP (``serve
  --metrics-port``).
* One process-wide default registry (:func:`get_registry`) is what the
  engine/session/cache instrumentation writes to; ``set_registry`` swaps
  it (tests install a fresh one, overhead probes install a
  :class:`NullRegistry`).

Everything is stdlib-only and lock-protected; a counter bump is two dict
lookups and a float add, so always-on metrics cost <=5% of even the
smallest bucket solve (measured by scripts/traced_smoke.py).
"""

from __future__ import annotations

import threading

__all__ = [
    "MetricsRegistry",
    "NullRegistry",
    "get_registry",
    "set_registry",
    "start_metrics_server",
    "DEFAULT_LATENCY_BUCKETS",
]

# latency-style histogram buckets (seconds): log-ish 1e-5 .. 10, +Inf implicit
DEFAULT_LATENCY_BUCKETS = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render(name: str, lk: tuple) -> str:
    if not lk:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in lk) + "}"


def _prom_render(name: str, lk: tuple, extra: tuple = ()) -> str:
    items = lk + extra
    if not items:
        return name
    return name + "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


class _Hist:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class MetricsRegistry:
    """Counters, gauges, and histograms keyed by (name, label set)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}  # name -> {labelkey: float}
        self._gauges: dict = {}
        self._hists: dict = {}  # name -> {labelkey: _Hist}
        self._hist_buckets: dict = {}  # name -> buckets tuple

    # ---------------- writes ----------------

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        lk = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[lk] = series.get(lk, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        lk = _label_key(labels)
        with self._lock:
            self._gauges.setdefault(name, {})[lk] = float(value)

    def register_histogram(self, name: str, buckets=DEFAULT_LATENCY_BUCKETS) -> None:
        """Pin the bucket layout for ``name`` (before the first observe)."""
        with self._lock:
            self._hist_buckets[name] = tuple(buckets)

    def observe(self, name: str, value: float, **labels) -> None:
        lk = _label_key(labels)
        with self._lock:
            series = self._hists.setdefault(name, {})
            h = series.get(lk)
            if h is None:
                h = series[lk] = _Hist(
                    self._hist_buckets.get(name, DEFAULT_LATENCY_BUCKETS)
                )
            h.observe(value)

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # ---------------- reads ----------------

    def value(self, name: str, **labels) -> float:
        """Current value of a counter or gauge series (0.0 when unseen)."""
        lk = _label_key(labels)
        with self._lock:
            if name in self._counters:
                return self._counters[name].get(lk, 0.0)
            if name in self._gauges:
                return self._gauges[name].get(lk, 0.0)
        return 0.0

    def snapshot(self) -> dict:
        """Deterministic flat dict of every series, keys and labels sorted.

        Histograms contribute ``name_count{...}``, ``name_sum{...}`` and
        per-bucket ``name_bucket{le=...,...}`` entries.
        """
        out: dict = {}
        with self._lock:
            for name, series in self._counters.items():
                for lk, v in series.items():
                    out[_render(name, lk)] = v
            for name, series in self._gauges.items():
                for lk, v in series.items():
                    out[_render(name, lk)] = v
            for name, series in self._hists.items():
                for lk, h in series.items():
                    out[_render(name + "_count", lk)] = h.count
                    out[_render(name + "_sum", lk)] = h.sum
                    for b, c in zip(h.buckets, h.counts):
                        out[_render(name + "_bucket", lk + (("le", repr(b)),))] = c
                    out[_render(name + "_bucket", lk + (("le", "+Inf"),))] = h.count
        return dict(sorted(out.items()))

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (served by --metrics-port)."""
        lines: list = []
        with self._lock:
            for name in sorted(self._counters):
                lines.append(f"# TYPE {name} counter")
                for lk in sorted(self._counters[name]):
                    lines.append(
                        f"{_prom_render(name, lk)} {self._counters[name][lk]:g}"
                    )
            for name in sorted(self._gauges):
                lines.append(f"# TYPE {name} gauge")
                for lk in sorted(self._gauges[name]):
                    lines.append(
                        f"{_prom_render(name, lk)} {self._gauges[name][lk]:g}"
                    )
            for name in sorted(self._hists):
                lines.append(f"# TYPE {name} histogram")
                for lk in sorted(self._hists[name]):
                    h = self._hists[name][lk]
                    acc = 0
                    for b, c in zip(h.buckets, h.counts):
                        acc += c
                        lines.append(
                            f"{_prom_render(name + '_bucket', lk, (('le', repr(b)),))} {acc}"
                        )
                    lines.append(
                        f"{_prom_render(name + '_bucket', lk, (('le', '+Inf'),))} {h.count}"
                    )
                    lines.append(f"{_prom_render(name + '_sum', lk)} {h.sum:g}")
                    lines.append(f"{_prom_render(name + '_count', lk)} {h.count}")
        return "\n".join(lines) + "\n"


class NullRegistry(MetricsRegistry):
    """A registry that drops everything — the disabled-metrics baseline for
    overhead measurements (scripts/traced_smoke.py)."""

    def inc(self, name, value=1.0, **labels):  # noqa: D102
        pass

    def set_gauge(self, name, value, **labels):  # noqa: D102
        pass

    def observe(self, name, value, **labels):  # noqa: D102
        pass


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry all instrumentation writes to."""
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the default registry (returns the previous one)."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = registry
    return prev


def start_metrics_server(port: int, registry: MetricsRegistry | None = None):
    """Serve ``registry.prometheus_text()`` over HTTP on ``port``.

    Returns the ``http.server`` instance (a daemon thread runs it); call
    ``.shutdown()`` to stop.  Any path serves the exposition, so both
    ``/metrics`` scrapes and a browser poke work.
    """
    import http.server

    reg = registry if registry is not None else get_registry()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            body = reg.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-request stderr noise
            pass

    server = http.server.ThreadingHTTPServer(("", port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name=f"metrics-server:{port}")
    t.start()
    return server
