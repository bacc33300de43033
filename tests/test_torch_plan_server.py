"""The port's planning service tier (``repro_torch.serve``, the deprecated
``repro_torch.engine.PlanService``), run on the CPU with the ``"torch"``
engine backend.

Copies of the reference's cases (``tests/test_serve_store.py``,
``test_serve_server.py``, ``test_serve_shard.py`` and the ``PlanService``
cases of ``test_api_session.py``) held to the port, plus the shard
assignment against the reference's own ``plan_shards`` over the same
buckets (in-process: ``repro.serve.shard`` imports no JAX).  Tests marked
``cuda`` need the card: launch counts that stay exact when four threads
launch on four streams, and the sharded and served paths on the card.
"""

from __future__ import annotations

import json
import os
import shutil
import sqlite3
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro_torch.api import Policy, Problem, Session
from repro_torch.core.instance import random_instance
from repro_torch.engine import PlanService, solve_bulk
from repro_torch.engine.arena import InstanceArena
from repro_torch.engine.cache import CachedSolution, SolutionCache
from repro_torch.serve import (
    STORE_SCHEMA_VERSION,
    DeadlineExceeded,
    PlanClient,
    PlanRequestError,
    PlanServer,
    PlanStore,
    ServerBusy,
    ServerClosed,
    TieredSolutionCache,
    plan_shards,
    solve_bulk_sharded,
)

REPO = Path(__file__).resolve().parents[1]
_POLICY = Policy(installments=2, backend="torch")


def _sol(v: float = 1.0) -> CachedSolution:
    return CachedSolution(gamma=np.full((2, 2), v), lp_makespan=v, backend="torch")


def _problem(scale: float = 1.0) -> Problem:
    return Problem(w=[1.0, 2.0 * scale], z=[0.1], v_comm=[1.0], v_comp=[3.0 * scale])


def _session(policy=_POLICY, **kw) -> Session:
    return Session(policy, device="cpu", **kw)


# ================================================================ the store


def test_store_roundtrip_and_stats(tmp_path):
    with PlanStore(tmp_path / "p.sqlite") as st:
        assert st.get("k0") is None
        st.put("k0", _sol(2.0))
        got = st.get("k0")
        np.testing.assert_array_equal(got.gamma, np.full((2, 2), 2.0))
        assert got.lp_makespan == 2.0 and got.backend == "torch"
        assert len(st) == 1
        s = st.stats()
        assert s["hits"] == 1 and s["misses"] == 1 and s["entries"] == 1
        assert s["quarantines"] == 0


def test_store_survives_reopen(tmp_path):
    path = tmp_path / "p.sqlite"
    with PlanStore(path) as st:
        st.put("k0", _sol(3.0))
    with PlanStore(path) as st2:  # the "second process"
        assert st2.get("k0").lp_makespan == 3.0


def test_store_lookup_many_mixed(tmp_path):
    with PlanStore(tmp_path / "p.sqlite") as st:
        st.put("a", _sol(1.0))
        st.put("c", _sol(3.0))
        sols = st.lookup_many(["a", "b", "c"])
        assert sols[0].lp_makespan == 1.0 and sols[1] is None
        assert sols[2].lp_makespan == 3.0
        assert st.hits == 2 and st.misses == 1


def test_store_ttl_expiry(tmp_path):
    clk = [0.0]
    with PlanStore(tmp_path / "p.sqlite", ttl_s=10.0, clock=lambda: clk[0]) as st:
        st.put("k", _sol())
        clk[0] = 5.0
        assert st.get("k") is not None
        clk[0] = 20.0
        assert st.get("k") is None  # expired rows read as a miss and delete
        assert st.expirations == 1 and len(st) == 0
        st.put("k2", _sol())
        clk[0] = 40.0
        assert st.sweep_expired() == 1
        assert len(st) == 0


def test_store_lru_eviction_over_restarts(tmp_path):
    clk = [0.0]
    path = tmp_path / "p.sqlite"
    with PlanStore(path, max_entries=3, clock=lambda: clk[0]) as st:
        for i in range(3):
            clk[0] += 1
            st.put(f"k{i}", _sol(float(i)))
        clk[0] += 1
        st.get("k0")  # touch: k0 becomes most recent, k1 is now LRU
    # the access order survives the restart
    with PlanStore(path, max_entries=3, clock=lambda: clk[0]) as st:
        clk[0] += 1
        st.put("k3", _sol(3.0))
        assert st.evictions == 1
        assert st.get("k1") is None  # the LRU row went
        assert st.get("k0") is not None and st.get("k3") is not None


@pytest.mark.parametrize("kw,match", [({"max_entries": 0}, "max_entries"),
                                      ({"ttl_s": 0.0}, "ttl_s")])
def test_store_rejects_bad_bounds(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        PlanStore(tmp_path / "p.sqlite", **kw)


def test_store_thread_hammer_8_threads(tmp_path):
    # >= 8 threads share ONE store: no write may be lost to a race, no read
    # may crash, and the hit/miss counters must exactly cover the lookups
    st = PlanStore(tmp_path / "p.sqlite", max_entries=4096)
    n_threads, per_thread = 8, 50
    barrier = threading.Barrier(n_threads)
    errors: list = []

    def worker(tid):
        try:
            barrier.wait()
            for k in range(per_thread):
                key = f"t{tid}-{k}"
                st.put(key, _sol(float(tid * 1000 + k)))
                got = st.get(key)
                assert got is not None, key  # own write always visible
                assert got.lp_makespan == float(tid * 1000 + k)
                st.lookup_many([f"t{(tid + 1) % n_threads}-{k}", "absent"])
        except BaseException as e:  # pragma: no cover - the assertion target
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(st) == n_threads * per_thread
    assert st.quarantines == 0 and st.corrupt_rows == 0
    assert st.hits + st.misses == n_threads * per_thread * 3  # get + 2-key lookup_many
    st.close()


def test_store_two_process_hammer(tmp_path):
    # a sibling process writes the same file while this one does: sqlite's
    # transaction atomicity must leave every row from both sides readable
    path = tmp_path / "p.sqlite"
    n = 40
    script = (
        "import sys, numpy as np\n"
        "from repro_torch.serve import PlanStore\n"
        "from repro_torch.engine.cache import CachedSolution\n"
        "st = PlanStore(sys.argv[1])\n"
        f"for i in range({n}):\n"
        "    st.put(f'proc-b-{i}', CachedSolution(gamma=np.full((2, 2), float(i)),"
        " lp_makespan=float(i), backend='torch'))\n"
        "st.close()\n"
        "print('done')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen([sys.executable, "-c", script, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    st = PlanStore(path)
    for i in range(n):
        st.put(f"proc-a-{i}", _sol(float(i)))
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    assert "done" in out
    assert len(st) == 2 * n
    for i in range(n):
        assert st.get(f"proc-a-{i}").lp_makespan == float(i)
        assert st.get(f"proc-b-{i}").lp_makespan == float(i)
    assert st.quarantines == 0
    st.close()


def _truncate(path):
    with open(path, "r+b") as f:  # tear the header off
        f.truncate(7)


def _garbage(path):
    Path(path).write_bytes(b"this is not a sqlite database at all--------")


def _future_schema(path):
    con = sqlite3.connect(path)
    con.execute("UPDATE meta SET value=? WHERE key='schema_version'",
                (str(STORE_SCHEMA_VERSION + 1),))
    con.commit()
    con.close()


@pytest.mark.parametrize("damage", [_truncate, _garbage, _future_schema],
                         ids=["truncated", "garbage", "newer_schema"])
def test_store_unreadable_file_quarantines(tmp_path, damage):
    path = tmp_path / "p.sqlite"
    with PlanStore(path) as st:
        st.put("k", _sol())
    damage(path)
    st2 = PlanStore(path)  # must not raise
    assert st2.quarantines == 1
    assert st2.get("k") is None  # fresh store: the unreadable data is gone...
    st2.put("k2", _sol(5.0))
    assert st2.get("k2").lp_makespan == 5.0  # ...and the path serves again
    assert os.path.exists(str(path) + ".quarantined-0")  # evidence kept
    st2.close()


def test_store_corrupt_row_reads_as_miss(tmp_path):
    path = tmp_path / "p.sqlite"
    with PlanStore(path) as st:
        st.put("good", _sol(1.0))
        st.put("bad", _sol(2.0))
    con = sqlite3.connect(path)
    con.execute("UPDATE plans SET payload='{not json' WHERE key='bad'")
    con.commit()
    con.close()
    with PlanStore(path) as st2:
        assert st2.get("bad") is None  # deleted + counted, not raised
        assert st2.corrupt_rows == 1
        assert st2.get("good").lp_makespan == 1.0  # neighbours unharmed
        assert len(st2) == 1


def test_store_quarantine_names_never_collide(tmp_path):
    path = tmp_path / "p.sqlite"
    for expected in range(2):
        path.write_bytes(b"garbage-" * 8)
        st = PlanStore(path)
        st.close()
        assert os.path.exists(f"{path}.quarantined-{expected}")


def test_store_older_schema_migrates_in_place(tmp_path):
    path = tmp_path / "p.sqlite"
    with PlanStore(path):
        pass  # create the schema
    con = sqlite3.connect(path)
    con.execute("UPDATE meta SET value='0' WHERE key='schema_version'")
    payload = json.dumps({"g": [[0.25, 0.75], [0.5, 0.5]], "mk": 4.0})
    con.execute("INSERT INTO plans (key, schema, payload, created, last_access) "
                "VALUES ('old', 0, ?, 1.0, 1.0)", (payload,))
    con.commit()
    con.close()
    with PlanStore(path) as st2:  # no quarantine: migrate
        assert st2.quarantines == 0
        got = st2.get("old")  # row upgrades lazily on read
        np.testing.assert_array_equal(got.gamma, np.asarray([[0.25, 0.75], [0.5, 0.5]]))
        assert got.lp_makespan == 4.0 and got.backend == "unknown"
    con = sqlite3.connect(path)
    stamp = con.execute("SELECT value FROM meta WHERE key='schema_version'").fetchone()[0]
    con.close()
    assert int(stamp) == STORE_SCHEMA_VERSION  # store stamp bumped now


def test_store_unknown_old_record_is_corrupt_not_crash(tmp_path):
    path = tmp_path / "p.sqlite"
    with PlanStore(path):
        pass
    con = sqlite3.connect(path)
    con.execute("INSERT INTO plans (key, schema, payload, created, last_access) "
                "VALUES ('weird', 99, ?, 1.0, 1.0)",
                (json.dumps({"schema": 99, "mystery": True}),))
    con.commit()
    con.close()
    with PlanStore(path) as st2:
        assert st2.get("weird") is None
        assert st2.corrupt_rows == 1


def test_tiered_cache_promotes_and_writes_through(tmp_path):
    a = TieredSolutionCache(tmp_path / "p.sqlite")
    a.put("k", _sol(7.0))
    assert len(a) == 1 and len(a.store) == 1  # write-through
    b = TieredSolutionCache(a.store)  # cold memory, shared disk
    got = b.get("k")
    assert got is not None and got.lp_makespan == 7.0
    assert b.store_hits == 1
    assert b.misses == 0  # a store hit is not a cache miss
    b.store.hits, b.store.misses = 0, 0
    assert b.get("k") is not None
    assert b.store.hits == 0  # second read served from promoted memory
    assert b.hits >= 1


def test_tiered_cache_validation_and_stats(tmp_path):
    c = TieredSolutionCache(tmp_path / "p.sqlite")
    assert c.get("absent") is None
    c.put("k", _sol())
    s = c.stats()
    assert s["store_hits"] == 0 and s["store"]["entries"] == 1
    assert c.evictions == 0


def test_session_store_hit_artifact_diffs_clean(tmp_path):
    # an artifact replayed from a store row is indistinguishable (diff() ==
    # {}) from a fresh solve of the same spec
    path = str(tmp_path / "plans.sqlite")
    problems = [_problem(1.0 + 0.1 * k) for k in range(4)]
    first = _session(store=path)
    arts1 = [first.solve(p) for p in problems]
    assert all(a.ok and not a.cache_hit for a in arts1)
    second = _session(store=path)  # the restarted "process"
    arts2 = [second.solve(p) for p in problems]
    assert all(a.cache_hit for a in arts2)
    assert second.cache.store_hits == len(problems)
    fresh = _session()  # no store at all: ground truth
    for a2, p in zip(arts2, problems):
        ref = fresh.solve(p)
        assert a2.diff(ref) == {}
        assert a2.makespan == pytest.approx(ref.makespan, abs=1e-12)


def test_session_rejects_cache_and_store_together(tmp_path):
    with pytest.raises(ValueError, match="either cache= or store="):
        Session(Policy(), cache=SolutionCache(), store=str(tmp_path / "p.sqlite"))


# ================================================================ the server


def _blocked_server(**kw):
    """A 1-worker server whose (single) session blocks until released —
    the deterministic way to test queue behaviour."""
    server = PlanServer(workers=1, policy=_POLICY, device="cpu", **kw)
    release = threading.Event()
    entered = threading.Event()
    real = server.sessions[0].solve_bulk

    def blocking(problems, *a, **k):
        entered.set()
        assert release.wait(timeout=60), "test forgot to release the worker"
        return real(problems, *a, **k)

    server.sessions[0].solve_bulk = blocking
    return server, release, entered


def test_plan_matches_direct_session():
    with PlanServer(workers=2, policy=_POLICY, device="cpu") as server:
        p = _problem()
        art = server.plan(p)
        assert art.ok and art.backend == "torch"
        assert art.diff(_session().solve(p)) == {}


def test_submit_burst_resolves_everything():
    with PlanServer(workers=2, policy=_POLICY, max_batch=8, device="cpu") as server:
        futs = [server.submit(_problem(1.0 + 0.05 * k)) for k in range(16)]
        arts = [f.result(timeout=120) for f in futs]
        assert all(a.ok for a in arts)
        for k, a in enumerate(arts):  # each artifact answers its own problem
            assert a.problem.v_comp[0] == pytest.approx(3.0 * (1.0 + 0.05 * k))


def test_mixed_policy_batch_groups_correctly():
    with PlanServer(workers=1, policy=_POLICY, max_batch=16, device="cpu") as server:
        p1 = Policy(installments=1, backend="torch")
        futs = [server.submit(_problem(1.0 + 0.1 * k), policy=p1 if k % 2 else None)
                for k in range(6)]
        arts = [f.result(timeout=120) for f in futs]
        assert all(a.ok for a in arts)
        for k, a in enumerate(arts):
            assert a.q == ((1,) if k % 2 else (2,))


def test_workers_share_one_cache():
    with PlanServer(workers=2, policy=_POLICY, device="cpu") as server:
        p = _problem()
        first = server.plan(p)
        assert not first.cache_hit
        hits = [server.plan(p) for _ in range(4)]
        assert all(a.cache_hit for a in hits)
        assert all(a.diff(first) == {} for a in hits)


def test_store_backed_server_restart_serves_hits(tmp_path):
    path = str(tmp_path / "plans.sqlite")
    p = _problem()
    with PlanServer(store=path, policy=_POLICY, device="cpu") as first:
        a1 = first.plan(p)
        assert a1.ok and not a1.cache_hit
    with PlanServer(store=path, policy=_POLICY, device="cpu") as second:  # "restart"
        a2 = second.plan(p)
        assert a2.cache_hit
        assert a2.diff(a1) == {}
        assert second.cache.store_hits == 1


def test_server_sharded_workers_match_single():
    problems = [_problem(1.0 + 0.1 * k) for k in range(6)]
    with PlanServer(workers=1, policy=_POLICY, n_shards=2, device="cpu") as server:
        assert server.sessions[0].backend("torch").n_shards == 2
        futs = [server.submit(p) for p in problems]
        arts = [f.result(timeout=120) for f in futs]
    direct = _session().solve_bulk(problems)
    for a, d in zip(arts, direct):
        assert a.diff(d) == {}


def test_backpressure_rejects_when_queue_full():
    server, release, entered = _blocked_server(queue_limit=2)
    try:
        first = server.submit(_problem())  # occupies the worker
        assert entered.wait(timeout=60)
        q1 = server.submit(_problem(1.1))  # fills the queue...
        q2 = server.submit(_problem(1.2))
        with pytest.raises(ServerBusy, match="queue full"):
            server.submit(_problem(1.3))  # ...and the bound holds
        release.set()
        for f in (first, q1, q2):
            assert f.result(timeout=120).ok  # nothing admitted was lost
    finally:
        release.set()
        server.close()


def test_deadline_expired_in_queue_never_solves():
    server, release, entered = _blocked_server(queue_limit=8)
    try:
        first = server.submit(_problem())
        assert entered.wait(timeout=60)
        doomed = server.submit(_problem(1.1), deadline_s=0.05)
        alive = server.submit(_problem(1.2), deadline_s=600)
        time.sleep(0.2)  # let the doomed job's deadline lapse while queued
        release.set()
        assert first.result(timeout=120).ok
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=120)
        assert alive.result(timeout=120).ok
    finally:
        release.set()
        server.close()


def test_close_drains_admitted_work():
    server, release, entered = _blocked_server(queue_limit=8)
    futs = [server.submit(_problem(1.0 + 0.1 * k)) for k in range(4)]
    assert entered.wait(timeout=60)
    closer = threading.Thread(target=server.close)
    closer.start()
    deadline = time.monotonic() + 30
    while not server.draining and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server.draining
    with pytest.raises(ServerClosed):
        server.submit(_problem())  # no new work while draining
    release.set()
    closer.join(timeout=120)
    assert not closer.is_alive()
    assert all(f.result(timeout=1).ok for f in futs)  # every admitted job ran


def test_close_without_drain_fails_pending_futures():
    server, release, entered = _blocked_server(queue_limit=8)
    running = server.submit(_problem())
    assert entered.wait(timeout=60)
    queued = server.submit(_problem(1.1))
    release.set()
    server.close(drain=False)
    assert running.result(timeout=120).ok  # in-flight work still lands
    with pytest.raises(ServerClosed):
        queued.result(timeout=1)


def test_close_is_idempotent_and_healthz_reports_draining():
    server = PlanServer(workers=1, policy=_POLICY, device="cpu")
    assert server.healthz()["status"] == "ok"
    server.close()
    server.close()  # second close is a no-op, not an error
    assert server.healthz()["status"] == "draining"
    with pytest.raises(ServerClosed):
        server.plan(_problem())


@pytest.mark.parametrize("kw,match", [({"workers": 0}, "workers"),
                                      ({"queue_limit": 0}, "queue_limit")])
def test_server_rejects_bad_sizes(kw, match):
    with pytest.raises(ValueError, match=match):
        PlanServer(policy=_POLICY, device="cpu", **kw)


def test_http_round_trip_parity_and_observability():
    with PlanServer(workers=1, policy=_POLICY, port=0, device="cpu") as server:
        assert server.port and server.port > 0
        client = PlanClient(f"http://localhost:{server.port}")
        h = client.healthz()
        assert h["status"] == "ok" and h["workers"] == 1
        p = _problem(1.3)
        art = client.plan(p)
        assert art.ok and art.problem == p
        assert art.diff(_session().solve(p)) == {}  # the wire round trip loses nothing
        text = client.metrics_text()
        assert "repro_serve_requests_total" in text
        assert "repro_serve_admitted_total" in text


def test_http_error_mapping():
    import urllib.request

    with PlanServer(workers=1, policy=_POLICY, port=0, device="cpu") as server:
        base = f"http://localhost:{server.port}"
        client = PlanClient(base)
        # bad request: unparseable problem -> 400 PlanRequestError
        req = urllib.request.Request(
            base + "/v1/plan", data=json.dumps({"problem": {"w": "x"}}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(Exception):
            urllib.request.urlopen(req, timeout=30)
        with pytest.raises(PlanRequestError) as ei:
            client._post("/v1/plan", {"problem": {"nonsense": 1}})
        assert ei.value.status == 400
        with pytest.raises(PlanRequestError) as ei:  # unknown endpoint -> 404
            client._post("/v1/other", {})
        assert ei.value.status == 404


# ================================================================ the shards


def _population(n: int = 24, seed: int = 5) -> list:
    # three distinct shapes -> three arena buckets with different costs
    rng = np.random.default_rng(seed)
    return [random_instance(rng, m=2 + (k % 3), n_loads=1 + (k % 2), q=2) for k in range(n)]


def _buckets(insts: list) -> list:
    return InstanceArena(insts, pad_shapes=False).buckets


def _flatten(shards: list) -> list:
    return [[(c.key, tuple(c.indices)) for c in shard] for shard in shards]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("seed", [5, 9])
def test_plan_shards_equal_the_references_over_the_same_buckets(seed, n_shards):
    from repro.serve.shard import plan_shards as ref_plan_shards

    buckets = _buckets(_population(n=24 + seed, seed=seed))
    assert _flatten(plan_shards(buckets, n_shards)) == _flatten(
        ref_plan_shards(buckets, n_shards))


def test_plan_shards_is_deterministic():
    insts = _population()
    assert _flatten(plan_shards(_buckets(insts), 3)) == _flatten(
        plan_shards(_buckets(insts), 3))


def test_plan_shards_covers_every_row_exactly_once():
    buckets = _buckets(_population())
    want = sorted((b.key, i) for b in buckets for i in b.indices)
    for n_shards in (1, 2, 3, 5):
        got = sorted((c.key, i) for shard in plan_shards(buckets, n_shards) for c in shard
                     for i in c.indices)
        assert got == want, f"n_shards={n_shards} lost or duplicated rows"


def test_plan_shards_splits_one_big_bucket():
    rng = np.random.default_rng(0)
    (bucket,) = _buckets([random_instance(rng, m=3, n_loads=2, q=2) for _ in range(8)])
    shards = plan_shards([bucket], 2)
    assert all(shard for shard in shards)  # both shards got work
    assert sorted(sum(c.B for c in shard) for shard in shards) == [4, 4]


def test_plan_shards_single_instance_cannot_split():
    rng = np.random.default_rng(0)
    (bucket,) = _buckets([random_instance(rng, m=3, n_loads=1, q=1)])
    shards = plan_shards([bucket], 4)
    assert sum(len(s) for s in shards) == 1  # B=1 is indivisible
    assert len(shards) == 4


def test_plan_shards_rejects_bad_count():
    with pytest.raises(ValueError, match="n_shards"):
        plan_shards([], 0)


def test_sliced_bucket_carries_its_parent_rows():
    rng = np.random.default_rng(3)
    (bucket,) = _buckets([random_instance(rng, m=3, n_loads=2, q=2) for _ in range(6)])
    for shard in plan_shards([bucket], 2):
        for chunk in shard:
            rows = [list(bucket.indices).index(i) for i in chunk.indices]
            np.testing.assert_array_equal(chunk.w_cell, bucket.w_cell[rows])
            np.testing.assert_array_equal(chunk.z, bucket.z[rows])
            assert chunk.key == bucket.key
            assert chunk.m == bucket.m and chunk.T == bucket.T


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_parity_logical_shards(n_shards):
    insts = _population()
    single = solve_bulk(insts, device="cpu")
    sharded = solve_bulk_sharded(insts, n_shards=n_shards, device="cpu")
    for r1, r2 in zip(single, sharded):
        assert r2.ok and r2.backend == r1.backend
        np.testing.assert_allclose(r2.schedule.gamma, r1.schedule.gamma, atol=1e-9, rtol=0)
        assert r2.lp_makespan == pytest.approx(r1.lp_makespan, abs=1e-9)
        assert r2.telemetry["lp"]["status"] == r1.telemetry["lp"]["status"]


def test_sharded_parity_with_shared_cache():
    insts = _population(n=12, seed=9)
    cache = SolutionCache()
    first = solve_bulk_sharded(insts, n_shards=2, cache=cache, device="cpu")
    assert all(r.ok for r in first)
    assert len(cache) > 0
    hits_before = cache.hits  # every slot is now a hit; replayed identically
    again = solve_bulk_sharded(insts, n_shards=2, cache=cache, device="cpu")
    assert cache.hits == hits_before + len(insts)
    for r1, r2 in zip(first, again):
        np.testing.assert_allclose(r2.schedule.gamma, r1.schedule.gamma, atol=1e-9, rtol=0)


def test_sharded_single_shard_is_solve_bulk():
    insts = _population(n=6)
    a = solve_bulk(insts, device="cpu")
    b = solve_bulk_sharded(insts, n_shards=1, device="cpu")
    for r1, r2 in zip(a, b):
        np.testing.assert_array_equal(r2.schedule.gamma, r1.schedule.gamma)


def test_sharded_rejects_disagreeing_device_args():
    with pytest.raises(ValueError, match="disagree"):
        solve_bulk_sharded(_population(n=2), devices=["cpu"], n_shards=3)


def test_sharded_warm_starts_ride_the_slices():
    insts = _population(n=12, seed=11)
    cold = solve_bulk(insts, device="cpu")
    bases = [r.telemetry["lp"]["final_basis"] for r in cold]
    warm = solve_bulk_sharded(insts, n_shards=3, device="cpu", warm_starts=bases)
    for r1, r2 in zip(cold, warm):
        assert r2.telemetry["lp"]["warm"]
        assert r2.telemetry["lp"]["pivots_phase1"] == 0
        assert r2.makespan == pytest.approx(r1.makespan, rel=1e-9)


def test_shard_error_reraises_after_join(monkeypatch):
    from repro_torch.engine import service

    real = service._solve_bucket

    def failing(bucket, *a, **k):
        if bucket.m == 3:
            raise RuntimeError("shard boom")
        return real(bucket, *a, **k)

    monkeypatch.setattr(service, "_solve_bucket", failing)
    with pytest.raises(RuntimeError, match="shard boom"):
        solve_bulk_sharded(_population(n=9), n_shards=3, device="cpu")


def test_engine_hook_solve_bulk_n_shards():
    insts = _population(n=12, seed=11)
    single = solve_bulk(insts, device="cpu")
    sharded = solve_bulk(insts, n_shards=2, device="cpu")
    for r1, r2 in zip(single, sharded):
        assert r2.ok
        np.testing.assert_allclose(r2.schedule.gamma, r1.schedule.gamma, atol=1e-9, rtol=0)


# ================================================================ PlanService


def _plan_service(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return PlanService(backend="torch", device="cpu", **kw)


def _instances(n, seed):
    rng = np.random.default_rng(seed)
    return [random_instance(rng, m=3, n_loads=2, q=1) for _ in range(n)]


def test_plan_service_shim_warns_and_matches_session():
    insts = _instances(4, seed=5)
    with pytest.warns(DeprecationWarning, match="repro_torch.api.Session"):
        svc = PlanService(backend="torch", device="cpu")
    tickets = [svc.submit(i) for i in insts]
    # result() on an UNFLUSHED ticket auto-flushes; a later flush() is a no-op
    assert svc.result(tickets[2]).ok
    assert svc.flush() == []
    arts = _session(Policy(backend="torch")).solve_bulk(insts)
    for t, art in zip(tickets, arts):
        assert svc.result(t).makespan == pytest.approx(art.makespan, rel=1e-9, abs=1e-9)


def test_plan_service_double_flush_and_interleaved_submits():
    insts = _instances(3, seed=6)
    svc = _plan_service()
    t0 = svc.submit(insts[0])
    first = svc.flush()
    assert len(first) == 1 and svc.flush() == []  # idempotent
    t1, t2 = svc.submit(insts[1]), svc.submit(insts[2])
    assert svc.result(t2).ok  # auto-flush resolves both
    assert svc.result(t1).ok and svc.result(t0).ok
    assert svc.flush() == []


def test_plan_service_bounded_retention():
    svc = _plan_service(max_results=4)
    tickets = [svc.submit(i) for i in _instances(6, seed=0)]
    assert len(svc.flush()) == 6
    assert svc.result(tickets[-1]).ok  # recent tickets stay addressable
    with pytest.raises(KeyError):  # old ones are evicted, loudly
        svc.result(tickets[0])


def test_plan_service_flush_failure_keeps_queue_and_indices():
    svc = _plan_service()
    t = svc.submit(_instances(1, seed=13)[0])
    real_flush, calls = svc._session.flush, []

    def flaky_flush():
        if not calls:
            calls.append(1)
            raise RuntimeError("transient")
        return real_flush()

    svc._session.flush = flaky_flush
    with pytest.raises(RuntimeError, match="transient"):
        svc.flush()
    assert svc.result(t).ok  # retry succeeds, same ticket


def test_plan_service_accepts_requests_and_solve_many():
    from repro_torch.core.backends import SolveRequest

    insts = _instances(3, seed=3)
    svc = _plan_service()
    t1 = svc.submit(insts[0])
    t2 = svc.submit(SolveRequest(instance=insts[1]))
    svc.flush()
    assert svc.result(t1).ok and svc.result(t2).ok
    assert svc.result(t2).request is not None
    (rep,) = svc.solve_many([insts[2]])
    assert rep.ok and svc.stats()["hits"] >= 0


@pytest.mark.parametrize("backend,label", [("batched", "torch"), ("torch", "torch")])
def test_plan_service_maps_the_reference_backend_names(backend, label):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        svc = PlanService(backend=backend, device="cpu")
        assert svc.backend.name == label
        with pytest.raises(ValueError, match="engine backends"):
            PlanService(backend="auto", device="cpu")


# ================================================================ guards


def test_import_serve_and_runtime_leave_jax_and_the_reference_out():
    script = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.runtime.replan, repro_torch.runtime.ft\n"
        "from repro_torch.engine import PlanService\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_launch_counts_lose_no_update_under_threads():
    # the wrappers count a launch through count_launch, under one lock: 16
    # threads (more than this box's cores) with a short switch interval
    # must lose no increment
    from repro_torch.kernels import asap_replay, launch_counts, reset_launch_counts
    from repro_torch.kernels.build import count_launch

    n_threads, per_thread = 16, 2000
    barrier = threading.Barrier(n_threads)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reset_launch_counts()

        def worker():
            barrier.wait()
            for _ in range(per_thread):
                count_launch(asap_replay)

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert launch_counts()["asap_replay"] == n_threads * per_thread
    finally:
        sys.setswitchinterval(old)
        reset_launch_counts()


def test_autotune_memo_keeps_one_entry_under_threads(monkeypatch):
    # threads that probe one tableau shape at once all run the first entry
    # stored, so every solve of a shape runs one schedule
    import torch

    from repro_torch.engine import autotune

    monkeypatch.setattr(autotune, "_CACHE", {})
    rng = np.random.default_rng(4)
    T = torch.from_numpy(rng.uniform(0.1, 1.0, size=(4, 6, 9)))
    T[:, -1, :] = torch.from_numpy(rng.uniform(-1.0, 0.5, size=(4, 9)))
    basis = torch.from_numpy(np.tile(np.arange(5, dtype=np.int32), (4, 1)))
    n_threads = 8
    barrier = threading.Barrier(n_threads)
    got: list = [None] * n_threads

    def worker(i):
        barrier.wait()
        got[i] = autotune.pivot_schedule(T, basis, 8, 200, 50, sweep=(1, 4))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(g is got[0] for g in got)
    assert autotune._CACHE[(6, 9, "cpu")] is got[0]


# ================================================================ on the card


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available() or shutil.which("nvcc") is None:
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernels are built from source)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_launch_counts_stay_exact_under_four_threads_on_four_streams(card):
    import torch

    from repro_torch.kernels import (asap_replay, asap_replay_plain, launch_counts,
                                     reset_launch_counts)

    rng = np.random.default_rng(7)
    insts = [random_instance(rng, m=6, n_loads=3, q=2, return_ratio=0.5) for _ in range(64)]
    (bucket,) = _buckets(insts)
    g = rng.uniform(0.0, 1.0, size=(bucket.B, bucket.m, bucket.T))
    g /= g.sum(axis=1, keepdims=True)
    host = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)) for a in (
        bucket.w_cell, bucket.z, bucket.latency, bucket.tau, bucket.vcomm_cell,
        bucket.vcomp_cell, bucket.rel_cell, bucket.cell_valid, g, bucket.ret_cell)]
    want = asap_replay_plain(*host[:-1], host[-1], topology=bucket.topology)
    dev_args = [x.to(card) for x in host]
    n_threads, per_thread = 4, 200
    outs: list = [[] for _ in range(n_threads)]
    errors: list = []
    barrier = threading.Barrier(n_threads)
    torch.cuda.synchronize()
    reset_launch_counts()

    def worker(i):
        try:
            stream = torch.cuda.Stream(card)
            with torch.cuda.stream(stream):
                barrier.wait()
                for _ in range(per_thread):
                    outs[i].append(asap_replay(*dev_args[:-1], dev_args[-1],
                                               topology=bucket.topology))
                stream.synchronize()
        except BaseException as e:  # pragma: no cover - the assertion target
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert launch_counts()["asap_replay"] == n_threads * per_thread
    for per in outs:
        for got in per:
            for gg, w in zip(got, want):
                if w is not None:
                    torch.testing.assert_close(gg.cpu(), w, rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_sharded_solve_on_two_streams_matches_single_on_card(card):
    insts = _population(n=48, seed=21)
    single = solve_bulk(insts, device=card)
    sharded = solve_bulk(insts, device=card, n_shards=2)
    for r1, r2 in zip(single, sharded):
        assert r2.ok and r2.backend == r1.backend
        assert r2.makespan == pytest.approx(r1.makespan, rel=1e-9)


@pytest.mark.cuda
def test_plan_server_on_card_matches_direct_session(card, tmp_path):
    policy = Policy(installments=2, backend="cuda")
    problems = [_problem(1.0 + 0.05 * k) for k in range(12)]
    with PlanServer(workers=2, policy=policy, store=str(tmp_path / "p.sqlite"),
                    port=0) as server:
        client = PlanClient(f"http://localhost:{server.port}")
        arts = [client.plan(p) for p in problems]
    direct = Session(policy).solve_bulk(problems)
    for a, d in zip(arts, direct):
        assert a.ok and a.backend.startswith("cuda")
        assert a.makespan == pytest.approx(d.makespan, rel=1e-9)
