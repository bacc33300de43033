"""Solution cache: content-addressed storage of solved schedules.

Instances are hashed after quantization (relative rounding to
``quantum`` ~ 1e-9) so replans triggered by bit-identical — or merely
indistinguishable — platform states hit the cache instead of the solver.
The cache stores only the *decision* (the gamma fractions and the LP
objective); schedules are re-materialized by an ASAP replay, which is exact
and cheap, so a hit returns the same executable schedule the solver would.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.core.instance import Instance
from repro_torch.core.keys import instance_content_key, instance_content_keys
from repro_torch.obs import metrics as obs_metrics

__all__ = ["instance_key", "instance_keys", "CachedSolution", "SolutionCache"]


def instance_key(inst: Instance, objective: str = "makespan", quantum: float = 1e-9) -> str:
    """Stable content hash of a quantized instance (+ objective).

    The derivation lives in :func:`repro_torch.core.keys.instance_content_key` —
    the same one the reference package's ``repro.api.Problem.key()`` uses, so a Problem's key IS its
    cache slot.  Kept under the historical name for the engine call sites.
    """
    return instance_content_key(inst, objective=objective, quantum=quantum)


def instance_keys(
    instances: list, objective: str = "makespan", quantum: float = 1e-9
) -> list:
    """Bulk counterpart of :func:`instance_key` — one vectorized pass.

    Bit-identical to mapping :func:`instance_key` over the list (the bulk
    derivation IS the per-instance derivation; see repro_torch.core.keys), just
    amortized: same-shape instances share one stacked quantization.
    """
    return instance_content_keys(instances, objective=objective, quantum=quantum)


@dataclasses.dataclass
class CachedSolution:
    gamma: np.ndarray  # [m, T]
    lp_makespan: float
    backend: str


class SolutionCache:
    """A bounded LRU mapping quantized-instance hashes to solved fractions."""

    def __init__(self, max_entries: int = 65536, quantum: float = 1e-9):
        self.max_entries = max_entries
        self.quantum = quantum
        self._store: dict[str, CachedSolution] = {}
        # one lock over every store/counter mutation: the LRU touch is a
        # del+reinsert pair and eviction is a read-modify-write loop — both
        # corrupt under concurrent Sessions without mutual exclusion
        # (counters drift, touched entries vanish).  Reentrant because
        # lookup_many is get's bulk twin and either may sit under a Session
        # already holding it.
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def key(self, inst: Instance, objective: str = "makespan") -> str:
        return instance_key(inst, objective=objective, quantum=self.quantum)

    def keys(self, instances: list, objective: str = "makespan") -> list:
        """Content keys for a whole population (bulk vectorized derivation)."""
        return instance_keys(instances, objective=objective, quantum=self.quantum)

    def lookup_many(self, keys: list) -> list:
        """Batched :meth:`get`: one entry per key (``None`` on a miss).

        Semantics are identical to calling ``get`` per key (LRU touch on
        every hit, hit/miss counters advance the same way); the hit/miss
        metrics are flushed to the registry once per population instead of
        taking the registry lock per instance — measurable on warm-cache
        ``solve_bulk`` where the lookup loop IS the hot path.
        """
        sols: list = []
        hits = 0
        with self._lock:
            store = self._store
            for k in keys:
                sol = store.get(k)
                if sol is not None:
                    hits += 1
                    # LRU touch: re-insert at the dict tail
                    del store[k]
                    store[k] = sol
                sols.append(sol)
            misses = len(keys) - hits
            self.hits += hits
            self.misses += misses
        reg = obs_metrics.get_registry()
        if hits:
            reg.inc("repro_cache_hits_total", hits)
        if misses:
            reg.inc("repro_cache_misses_total", misses)
        return sols

    def get(self, key: str) -> CachedSolution | None:
        with self._lock:
            sol = self._store.get(key)
            if sol is None:
                self.misses += 1
                obs_metrics.get_registry().inc("repro_cache_misses_total")
                return None
            self.hits += 1
            obs_metrics.get_registry().inc("repro_cache_hits_total")
            # LRU touch: re-insert to the dict tail (dicts are insertion-ordered)
            del self._store[key]
            self._store[key] = sol
            return sol

    def put(self, key: str, sol: CachedSolution) -> None:
        with self._lock:
            if key in self._store:
                del self._store[key]
            self._store[key] = sol
            while len(self._store) > self.max_entries:
                self._store.pop(next(iter(self._store)))
                self.evictions += 1
                obs_metrics.get_registry().inc("repro_cache_evictions_total")

    def stats(self) -> dict:
        """Per-cache counters in the historical dict shape.

        .. deprecated::
           A shim — the unified, cross-component view is the metrics
           registry (``repro_cache_*_total``; key schema in DESIGN.md §8).
           The dict shape is frozen for the old call sites; new keys are
           appended, never renamed.
        """
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._store),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
            }
