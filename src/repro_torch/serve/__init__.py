"""repro_torch.serve — the planning service layer (DESIGN.md §12).

The port of ``repro.serve``, with the same exports.  Three layers over the engine/Session stack, each usable alone:

* :mod:`repro_torch.serve.shard` — sharded ``solve_bulk`` fan-out:
  deterministic bucket→shard assignment (LPT over ``B*m*T`` with batch
  splitting), one worker thread per shard on a CUDA stream of its own (or
  per card), parity-locked to the single path.  Reached from the engine as
  ``solve_bulk(..., devices=...)`` / ``n_shards=...``.
* :mod:`repro_torch.serve.store` — the persistent cross-process plan store:
  sqlite-backed, schema-versioned, content-addressed by the existing
  ``Problem.key()`` hash; corruption quarantines, TTL+LRU eviction.
  :class:`TieredSolutionCache` layers the in-memory LRU over it and drops
  into ``Session(cache=...)`` unchanged.
* :mod:`repro_torch.serve.server` / :mod:`~repro_torch.serve.client` — the long-lived
  front door: worker Sessions behind a bounded admission queue with
  deadlines and backpressure, ``/healthz`` + Prometheus ``/metrics``,
  graceful drain; the stdlib HTTP client mirrors the error contract.

Importing this package is cheap (no torch/engine import until a solve runs).
"""

from .client import PlanClient, PlanRequestError
from .server import DeadlineExceeded, PlanServer, ServerBusy, ServerClosed
from .shard import local_devices, plan_shards, solve_bulk_sharded
from .store import STORE_SCHEMA_VERSION, PlanStore, TieredSolutionCache

__all__ = [
    "PlanServer",
    "PlanClient",
    "PlanRequestError",
    "ServerBusy",
    "ServerClosed",
    "DeadlineExceeded",
    "PlanStore",
    "TieredSolutionCache",
    "STORE_SCHEMA_VERSION",
    "plan_shards",
    "solve_bulk_sharded",
    "local_devices",
]
