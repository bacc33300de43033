"""Persistent cross-process plan store + the tiered cache over it.

The port's copy of ``repro/serve/store.py`` (the reference is never
imported), with the reference's schema and records.

The engine's in-memory :class:`repro_torch.engine.cache.SolutionCache` dies with
the process; a serving fleet re-pays every solve on every restart and every
replica re-solves what its siblings already solved.  :class:`PlanStore`
persists the same content-addressed slots to disk — the slot IS the
existing ``Problem.key()`` quantized content hash (:mod:`repro_torch.core.keys`),
so any process that derives the same key reads the same plan — and
:class:`TieredSolutionCache` layers the in-memory LRU over it: memory
first, disk on a memory miss (promoting the row), write-through on every
put.  Warm restarts and sibling worker processes share plans for free.

Storage is a single sqlite database (stdlib, already cross-process-atomic:
every ``put`` commits one transaction, readers never observe a torn row).
What a row holds is the *decision* — the gamma fractions, the LP objective,
the solving backend — exactly what the in-memory cache holds, because the
repo-wide invariant is that the ASAP replay re-materializes the identical
executable schedule from the decision alone (DESIGN.md §7): a store hit
flows through the same hit-replay path as a memory hit and produces a
``diff()``-clean :class:`repro_torch.api.PlanArtifact`.

Robustness rules (regression-tested in tests/test_torch_plan_server.py):

* **schema-versioned** — the store stamps ``STORE_SCHEMA_VERSION`` in a
  meta table and every row carries its own record schema.  A *newer* store
  read by old code quarantines (never a best-effort parse of a future
  schema — the artifact rule); an *older* store read by new code migrates
  in place (store-level bump now, row-level upgrade lazily on read via
  ``_upgrade_record``).
* **corruption never crashes** — a file sqlite cannot open (truncation,
  garbage, a torn header) is quarantined: renamed to
  ``<path>.quarantined-<n>`` and replaced with a fresh store.  A row whose
  payload does not parse or validate is deleted and counted
  (``repro_store_corrupt_total``) and reads as a miss.
* **bounded** — TTL expiry (``ttl_s``) plus LRU eviction over
  ``last_access`` when the row count exceeds ``max_entries``; hits touch
  ``last_access`` so the LRU order survives restarts too.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time

import numpy as np

from repro_torch.obs import metrics as obs_metrics

__all__ = ["STORE_SCHEMA_VERSION", "PlanStore", "TieredSolutionCache"]

STORE_SCHEMA_VERSION = 1

# column layout of the plans table; bumping it means bumping the schema
_CREATE = (
    "CREATE TABLE IF NOT EXISTS meta (key TEXT PRIMARY KEY, value TEXT)",
    "CREATE TABLE IF NOT EXISTS plans ("
    " key TEXT PRIMARY KEY,"
    " schema INTEGER NOT NULL,"
    " payload TEXT NOT NULL,"
    " created REAL NOT NULL,"
    " last_access REAL NOT NULL)",
    "CREATE INDEX IF NOT EXISTS plans_last_access ON plans (last_access)",
)


def _record_from_solution(sol) -> dict:
    """A :class:`repro_torch.engine.cache.CachedSolution` as a JSON-safe record."""
    return {
        "schema": STORE_SCHEMA_VERSION,
        "gamma": [[float(v) for v in row] for row in np.asarray(sol.gamma)],
        "lp_makespan": float(sol.lp_makespan),
        "backend": str(sol.backend),
    }


def _upgrade_record(d: dict) -> dict | None:
    """Lazily migrate an older record schema to the current one.

    Returns the upgraded record, or ``None`` when the record is from a
    future schema or malformed (the caller deletes it and reads a miss —
    migrate or quarantine, never crash).
    """
    if not isinstance(d, dict):
        return None
    # the schema-0 pre-release shape predates the embedded "schema" key
    schema = d.get("schema", 0)
    if schema == STORE_SCHEMA_VERSION:
        return d
    if schema == 0:
        # the pre-release shape: {"g": [[...]], "mk": float} with no backend
        if "g" not in d or "mk" not in d:
            return None
        return {
            "schema": STORE_SCHEMA_VERSION,
            "gamma": d["g"],
            "lp_makespan": d["mk"],
            "backend": str(d.get("backend", "unknown")),
        }
    return None  # future (or unknown) schema: not readable here


class PlanStore:
    """Disk-backed, schema-versioned, content-addressed plan store.

    One sqlite file holds every slot; the key is ``Problem.key()`` (the
    quantized content hash).  Thread-safe within a process (one connection
    behind a lock) and atomic across processes (sqlite transactions +
    ``busy_timeout``).  See the module docstring for the robustness rules.
    """

    def __init__(
        self,
        path: str,
        max_entries: int = 65536,
        ttl_s: float | None = None,
        clock=time.time,
    ):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError("ttl_s must be > 0 (or None to disable)")
        self.path = os.fspath(path)
        self.max_entries = int(max_entries)
        self.ttl_s = ttl_s
        self._clock = clock
        self._lock = threading.RLock()
        self._con: sqlite3.Connection | None = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.corrupt_rows = 0
        self.quarantines = 0
        self._open()

    # ---------------- lifecycle ----------------

    def _open(self) -> None:
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        try:
            self._con = self._connect()
            self._init_schema()
        except sqlite3.DatabaseError:
            # unreadable file (truncation, garbage): quarantine and restart
            self._quarantine("unreadable")
        else:
            return
        self._con = self._connect()
        self._init_schema()

    def _connect(self) -> sqlite3.Connection:
        con = sqlite3.connect(self.path, timeout=30.0, check_same_thread=False)
        con.execute("PRAGMA busy_timeout=30000")
        try:
            # WAL lets sibling processes read while one writes; a filesystem
            # that refuses WAL (some network mounts) just keeps the default
            con.execute("PRAGMA journal_mode=WAL")
        except sqlite3.DatabaseError:
            pass
        return con

    def _init_schema(self) -> None:
        con = self._con
        # any of these raising sqlite3.DatabaseError means the file is not a
        # (readable) database — the caller quarantines
        for stmt in _CREATE:
            con.execute(stmt)
        row = con.execute(
            "SELECT value FROM meta WHERE key='schema_version'"
        ).fetchone()
        if row is None:
            con.execute(
                "INSERT OR REPLACE INTO meta (key, value) VALUES (?, ?)",
                ("schema_version", str(STORE_SCHEMA_VERSION)),
            )
            con.commit()
            return
        try:
            found = int(row[0])
        except (TypeError, ValueError):
            raise sqlite3.DatabaseError(f"bad schema_version {row[0]!r}")
        if found > STORE_SCHEMA_VERSION:
            # a future store: this build cannot know its invariants — refuse
            # a best-effort parse, quarantine the whole file (artifact rule)
            raise sqlite3.DatabaseError(
                f"store schema {found} is newer than supported {STORE_SCHEMA_VERSION}"
            )
        if found < STORE_SCHEMA_VERSION:
            # older store: migrate in place — bump the store stamp now, rows
            # upgrade lazily on read (_upgrade_record)
            con.execute(
                "UPDATE meta SET value=? WHERE key='schema_version'",
                (str(STORE_SCHEMA_VERSION),),
            )
            con.commit()

    def _quarantine(self, reason: str) -> None:
        """Move the unreadable file aside and count it; never raises."""
        try:
            if self._con is not None:
                self._con.close()
        except Exception:
            pass
        self._con = None
        n = 0
        dest = f"{self.path}.quarantined-{n}"
        while os.path.exists(dest):
            n += 1
            dest = f"{self.path}.quarantined-{n}"
        try:
            os.replace(self.path, dest)
        except OSError:
            # cannot even rename: drop the file so a fresh store can exist
            try:
                os.remove(self.path)
            except OSError:
                pass
        # sqlite sidecar files (-wal/-shm) belong to the quarantined db
        for ext in ("-wal", "-shm"):
            try:
                os.remove(self.path + ext)
            except OSError:
                pass
        self.quarantines += 1
        obs_metrics.get_registry().inc(
            "repro_store_quarantines_total", reason=reason)

    def close(self) -> None:
        with self._lock:
            if self._con is not None:
                self._con.close()
                self._con = None

    def __enter__(self) -> "PlanStore":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def __len__(self) -> int:
        with self._lock:
            try:
                return int(
                    self._con.execute("SELECT COUNT(*) FROM plans").fetchone()[0]
                )
            except sqlite3.DatabaseError:
                self._quarantine("count")
                self._open()
                return 0

    # ---------------- reads ----------------

    def get(self, key: str):
        """The :class:`CachedSolution` at ``key`` (``None`` on miss).

        Expired rows (TTL) delete and read as a miss; unparseable rows
        delete, count as corrupt, and read as a miss; a database-level error
        quarantines the file and reads as a miss.  Hits touch
        ``last_access`` so the cross-restart LRU order stays meaningful.
        """
        out = self.lookup_many([key])
        return out[0]

    def lookup_many(self, keys: list) -> list:
        from repro_torch.engine.cache import CachedSolution  # deferred: engine pkg

        now = self._clock()
        reg = obs_metrics.get_registry()
        sols: list = []
        hits = 0
        corrupt = 0
        expired = 0
        with self._lock:
            try:
                con = self._con
                for k in keys:
                    row = con.execute(
                        "SELECT schema, payload, created FROM plans WHERE key=?",
                        (k,),
                    ).fetchone()
                    if row is None:
                        sols.append(None)
                        continue
                    _, payload, created = row
                    if self.ttl_s is not None and now - created > self.ttl_s:
                        con.execute("DELETE FROM plans WHERE key=?", (k,))
                        expired += 1
                        sols.append(None)
                        continue
                    try:
                        rec = _upgrade_record(json.loads(payload))
                    except (json.JSONDecodeError, TypeError, ValueError):
                        rec = None
                    if rec is None or "gamma" not in rec:
                        con.execute("DELETE FROM plans WHERE key=?", (k,))
                        corrupt += 1
                        sols.append(None)
                        continue
                    con.execute(
                        "UPDATE plans SET last_access=? WHERE key=?", (now, k)
                    )
                    hits += 1
                    sols.append(
                        CachedSolution(
                            gamma=np.asarray(rec["gamma"], dtype=np.float64),
                            lp_makespan=float(rec["lp_makespan"]),
                            backend=str(rec["backend"]),
                        )
                    )
                if hits or corrupt or expired:
                    con.commit()
            except sqlite3.DatabaseError:
                self._quarantine("read")
                self._open()
                sols.extend([None] * (len(keys) - len(sols)))
            misses = len(keys) - hits
            self.hits += hits
            self.misses += misses
            self.corrupt_rows += corrupt
            self.expirations += expired
        if hits:
            reg.inc("repro_store_hits_total", hits)
        if len(keys) - hits:
            reg.inc("repro_store_misses_total", len(keys) - hits)
        if corrupt:
            reg.inc("repro_store_corrupt_total", corrupt)
        if expired:
            reg.inc("repro_store_expired_total", expired)
        return sols

    # ---------------- writes ----------------

    def put(self, key: str, sol) -> None:
        """Write-through one solved decision (atomic: one transaction).

        Over-capacity stores evict the least-recently-accessed rows; a
        database-level failure quarantines and retries once into the fresh
        store (a bad disk file must never take the serving path down).
        """
        payload = json.dumps(_record_from_solution(sol),
                             separators=(",", ":"), sort_keys=True)
        now = self._clock()
        with self._lock:
            for attempt in (0, 1):
                try:
                    con = self._con
                    con.execute(
                        "INSERT OR REPLACE INTO plans "
                        "(key, schema, payload, created, last_access) "
                        "VALUES (?, ?, ?, ?, ?)",
                        (key, STORE_SCHEMA_VERSION, payload, now, now),
                    )
                    self._evict_locked(con)
                    con.commit()
                    return
                except sqlite3.DatabaseError:
                    self._quarantine("write")
                    self._open()
                    if attempt:
                        return

    def _evict_locked(self, con) -> None:
        n = con.execute("SELECT COUNT(*) FROM plans").fetchone()[0]
        excess = n - self.max_entries
        if excess <= 0:
            return
        con.execute(
            "DELETE FROM plans WHERE key IN ("
            " SELECT key FROM plans ORDER BY last_access ASC, key ASC LIMIT ?)",
            (excess,),
        )
        self.evictions += excess
        obs_metrics.get_registry().inc("repro_store_evictions_total", excess)

    def sweep_expired(self) -> int:
        """Drop every TTL-expired row now; returns how many went."""
        if self.ttl_s is None:
            return 0
        cutoff = self._clock() - self.ttl_s
        with self._lock:
            try:
                cur = self._con.execute(
                    "DELETE FROM plans WHERE created < ?", (cutoff,))
                self._con.commit()
            except sqlite3.DatabaseError:
                self._quarantine("sweep")
                self._open()
                return 0
            gone = cur.rowcount if cur.rowcount is not None else 0
        self.expirations += gone
        if gone:
            obs_metrics.get_registry().inc("repro_store_expired_total", gone)
        return gone

    # ---------------- stats ----------------

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "path": self.path,
            "entries": len(self),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "evictions": self.evictions,
            "expirations": self.expirations,
            "corrupt_rows": self.corrupt_rows,
            "quarantines": self.quarantines,
        }


class TieredSolutionCache:
    """Memory LRU over a :class:`PlanStore`: the serving cache.

    Duck-types :class:`repro_torch.engine.cache.SolutionCache` (the engine only
    calls ``keys``/``lookup_many``/``get``/``put``/``stats``) so it drops
    into ``Session(cache=...)`` and every engine path unchanged.  Lookup
    order: the in-memory LRU first; memory misses consult the store and
    promote disk hits into memory.  ``put`` writes through to both layers,
    so sibling processes sharing the store file see each other's solves.
    """

    def __init__(
        self,
        store: PlanStore | str,
        max_entries: int = 65536,
        quantum: float = 1e-9,
    ):
        from repro_torch.engine.cache import SolutionCache  # deferred: engine pkg

        self.store = store if isinstance(store, PlanStore) else PlanStore(store)
        self.memory = SolutionCache(max_entries=max_entries, quantum=quantum)
        self.quantum = quantum
        self.store_hits = 0

    def __len__(self) -> int:
        return len(self.memory)

    # ---------------- the SolutionCache surface ----------------

    @property
    def hits(self) -> int:
        return self.memory.hits  # memory counters already include promotions

    @property
    def misses(self) -> int:
        return self.memory.misses - self.store_hits

    @property
    def evictions(self) -> int:
        return self.memory.evictions

    def key(self, inst, objective: str = "makespan") -> str:
        return self.memory.key(inst, objective=objective)

    def keys(self, instances: list, objective: str = "makespan") -> list:
        return self.memory.keys(instances, objective=objective)

    def lookup_many(self, keys: list) -> list:
        sols = self.memory.lookup_many(keys)
        missing = [i for i, s in enumerate(sols) if s is None]
        if not missing:
            return sols
        from_store = self.store.lookup_many([keys[i] for i in missing])
        promoted = 0
        for i, sol in zip(missing, from_store):
            if sol is not None:
                sols[i] = sol
                self.memory.put(keys[i], sol)  # promote for the next lookup
                promoted += 1
        self.store_hits += promoted
        return sols

    def get(self, key: str):
        return self.lookup_many([key])[0]

    def put(self, key: str, sol) -> None:
        self.memory.put(key, sol)
        self.store.put(key, sol)

    def stats(self) -> dict:
        out = dict(self.memory.stats())
        out["store_hits"] = self.store_hits
        out["store"] = self.store.stats()
        return out
