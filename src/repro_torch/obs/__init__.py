"""Flight recorder: tracing + metrics for the scheduling engine (DESIGN.md §8).

Zero-dependency observability threaded through every layer of the solve
pipeline:

* :mod:`repro_torch.obs.trace` — span-based tracer (context-manager spans with
  nesting, thread-safe, near-zero overhead when no tracer is active,
  Chrome-trace/Perfetto JSON export).  ``Session.trace()`` is the usual
  entry point; library code emits spans through the module-level
  :func:`repro_torch.obs.trace.span` free function, which is a no-op singleton
  unless a tracer has been activated.
* :mod:`repro_torch.obs.metrics` — a metrics registry (counters / gauges /
  histograms with label sets) with a deterministic ``snapshot()`` dict and
  Prometheus-text exposition.  One process-wide default registry
  (:func:`repro_torch.obs.metrics.get_registry`) collects the engine's cache,
  fallback, simplex, and latency metrics; swap it with ``set_registry``
  for isolation in tests.

Nothing in here imports JAX, numpy, or anything outside the stdlib — the
flight recorder must be importable (and near-free) everywhere, including
the serial-only paths.
"""

from .metrics import (MetricsRegistry, NullRegistry, get_registry,
                      set_registry, start_metrics_server)
from .trace import Tracer, activate, get_tracer, span

__all__ = [
    "MetricsRegistry",
    "NullRegistry",
    "get_registry",
    "set_registry",
    "start_metrics_server",
    "Tracer",
    "activate",
    "get_tracer",
    "span",
]
