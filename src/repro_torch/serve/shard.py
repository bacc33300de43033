"""Sharded solve fan-out: one bulk solve's buckets across CUDA streams or cards.

The port of ``repro/serve/shard.py``.  ``repro_torch.engine.solve_bulk``
packs a population into exact arena buckets and solves them one after the
other on one stream.  This module partitions that bucket list into shards
and runs each shard in its own host thread, on its own CUDA stream (and
card, where there are several), so the buckets' launches and host work
overlap.  The per-bucket machinery is exactly the engine's
(``_solve_bucket``, ``_replay_hits``): a sharded solve runs the same
operations in the same order per element, so results are parity-locked to
the single path (held to 1e-9 in the tests).

Assignment is **deterministic** and the reference's rule, bit for bit
(tests hold the shard lists equal to the reference's): every bucket gets a
work cost ``B * m * T``; buckets are split in half along the batch axis
until there are at least as many chunks as shards (splitting the costliest
splittable chunk first); the chunks are then LPT-assigned — sorted by (cost
desc, bucket key, batch offset), each placed on the least-loaded shard,
ties toward the lowest shard index.

Two shard granularities:

* ``devices`` — ``torch.device("cuda:i")`` cards (default: every local
  card, :func:`local_devices`); each shard's thread enters
  ``torch.cuda.device(dev)`` and a ``torch.cuda.Stream`` of its own there.
* ``n_shards`` — logical shards on the one ``device`` the call names
  (``None``: the card).  On the card every shard gets its own stream, so
  ``n_shards=N`` is N streams of one card; on the CPU (``device="cpu"``) a
  shard is a plain thread.

A shard's results reach the shared result list and the cache only after
its own stream is synchronised (``_solve_bucket`` does so before it writes
them); nothing on this path synchronises the whole device, which would
serialise the shards.  Each shard's page-locked input buffers are copied on
its own stream, and PyTorch's host allocator frees them after that
stream's copy.  A shard that raises re-raises in the caller after every
shard has joined.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import span

__all__ = ["local_devices", "plan_shards", "solve_bulk_sharded"]


def local_devices() -> list:
    """The local CUDA cards as ``torch.device``s (empty without a card)."""
    import torch  # deferred: serve stays importable without torch until a solve

    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


# ---------------- deterministic bucket -> shard assignment ----------------


def _cost(bucket) -> int:
    """Work proxy for one packed bucket (batch x tableau footprint)."""
    return bucket.B * bucket.m * bucket.T


def _slice_bucket(bucket, lo: int, hi: int):
    """The [lo:hi) batch rows of ``bucket`` as a standalone PackedBucket.

    Only the batch-leading arrays and the member lists slice; the shared
    per-bucket metadata (key, dims, cell maps) is identical by construction,
    so a sliced bucket solves exactly as its rows did in the parent.
    """
    return dataclasses.replace(
        bucket,
        instances=bucket.instances[lo:hi],
        indices=bucket.indices[lo:hi],
        w_cell=bucket.w_cell[lo:hi],
        z=bucket.z[lo:hi],
        latency=bucket.latency[lo:hi],
        tau=bucket.tau[lo:hi],
        vcomm_cell=bucket.vcomm_cell[lo:hi],
        vcomp_cell=bucket.vcomp_cell[lo:hi],
        rel_cell=bucket.rel_cell[lo:hi],
        ret_cell=bucket.ret_cell[lo:hi],
    )


def plan_shards(buckets: list, n_shards: int) -> list:
    """Partition ``buckets`` into ``n_shards`` deterministic work lists.

    Returns a list of ``n_shards`` lists of (possibly batch-sliced)
    ``PackedBucket``s.  See the module docstring for the exact rule; the
    invariants tests pin are (a) every input batch row appears in exactly
    one output chunk, (b) the assignment is a pure function of the bucket
    keys/sizes and ``n_shards``, and (c) no chunk is ever empty while a
    shard with work for it exists.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    # chunks: (key, lo, bucket) — lo is the batch offset within the parent
    chunks = [(b.key, 0, b) for b in sorted(buckets, key=lambda b: b.key)]
    if n_shards > 1:
        # split the costliest splittable chunk in half until there are
        # enough chunks to feed every shard (or nothing can split further)
        while len(chunks) < n_shards:
            splittable = [i for i, c in enumerate(chunks) if c[2].B >= 2]
            if not splittable:
                break
            at = max(splittable,
                     key=lambda i: (_cost(chunks[i][2]), chunks[i][0],
                                    -chunks[i][1]))
            key, lo, big = chunks.pop(at)
            mid = big.B // 2
            chunks.append((key, lo, _slice_bucket(big, 0, mid)))
            chunks.append((key, lo + mid, _slice_bucket(big, mid, big.B)))
    # LPT assignment: costliest first onto the least-loaded shard
    chunks.sort(key=lambda c: (-_cost(c[2]), c[0], c[1]))
    loads = [0] * n_shards
    shards: list = [[] for _ in range(n_shards)]
    for key, lo, chunk in chunks:
        i = min(range(n_shards), key=lambda j: (loads[j], j))
        shards[i].append(chunk)
        loads[i] += _cost(chunk)
    return shards


# ---------------- the sharded bulk solve ----------------


def solve_bulk_sharded(
    instances: list,
    objective: str = "makespan",
    cache=None,
    fallback: bool = True,
    validate: bool = True,
    warm_starts: list | None = None,
    device=None,
    devices: list | None = None,
    n_shards: int | None = None,
) -> list:
    """``solve_bulk`` with the arena buckets fanned out across shards.

    ``devices`` pins explicit cards (default, with ``n_shards`` unset: every
    local card); ``n_shards`` instead runs that many logical shards on
    ``device`` (``None``: the card; one stream a shard there, one thread a
    shard on the CPU).  With one shard in all this IS ``solve_bulk`` (same
    code path, no threads).  Results are in caller order and parity-locked
    to the single path; the shared solution cache and the metrics registry
    are both thread-safe, so shards write concurrently without coordination.
    """
    from repro_torch.convert import resolve_device
    from repro_torch.engine.service import _replay_hits, _solve_bucket, solve_bulk

    if devices is not None and n_shards is not None:
        if len(devices) != n_shards:
            raise ValueError(
                f"devices ({len(devices)}) and n_shards ({n_shards}) disagree")
    if devices is None and n_shards is not None:
        shard_devices = [resolve_device(device)] * n_shards  # logical shards, one device
    else:
        shard_devices = [resolve_device(d) for d in
                         (devices if devices is not None else local_devices())]
    n_dev = len(shard_devices)
    if n_dev < 1:
        raise ValueError("need at least one device/shard (no CUDA card: pass "
                         "n_shards with device='cpu')")
    if len({d.type for d in shard_devices}) != 1:
        raise ValueError(f"shards must all be cards or all the CPU; got {shard_devices}")
    if n_dev == 1 or objective != "makespan":
        return solve_bulk(
            instances, objective=objective, cache=cache, fallback=fallback,
            validate=validate, warm_starts=warm_starts, device=shard_devices[0],
        )

    from repro_torch.engine.arena import InstanceArena

    label = "cuda" if shard_devices[0].type == "cuda" else "torch"
    met = obs_metrics.get_registry()
    met.inc("repro_engine_bulk_solves_total", path=label)
    met.inc("repro_serve_sharded_solves_total", shards=n_dev)
    with span("serve.shard_solve", n=len(instances), shards=n_dev, path=label):
        n = len(instances)
        results: list = [None] * n
        t0 = time.perf_counter()
        with span("engine.cache_lookup", n=n):
            if cache is not None:
                keys = cache.keys(instances, objective)
                sols = cache.lookup_many(keys)
            else:
                keys = [None] * n
                sols = [None] * n
            pending = [i for i, sol in enumerate(sols) if sol is None]
            hit_idx = [i for i in range(n) if sols[i] is not None]
        cache_s = time.perf_counter() - t0
        if hit_idx:
            _replay_hits(instances, hit_idx, sols, results, label,
                         shard_devices[0], cache_s, met)
        if not pending:
            return results

        t0 = time.perf_counter()
        with span("engine.pack", n=len(pending)):
            arena = InstanceArena(
                [instances[i] for i in pending], pad_shapes=False)
        pack_s = time.perf_counter() - t0
        shards = plan_shards(arena.buckets, n_dev)
        shared_stages = {"cache_lookup_s": cache_s, "pack_s": pack_s}

        errors: list = [None] * n_dev

        def worker(i: int) -> None:
            dev = shard_devices[i]
            buckets = shards[i]
            elems = sum(b.B for b in buckets)
            dev_label = f"{dev}:stream{i}" if dev.type == "cuda" else f"cpu:{i}"
            t_dev = time.perf_counter()
            try:
                with span("serve.shard", shard=i, device=dev_label,
                          n_buckets=len(buckets), n=elems):
                    with _device_ctx(dev):
                        for bucket in buckets:
                            _solve_bucket(
                                bucket, instances, results, keys, pending,
                                cache, label, dev, fallback, validate,
                                met, shared_stages, warm_starts)
            except BaseException as e:  # surfaced after join, first wins
                errors[i] = e
            finally:
                met.observe("repro_serve_shard_seconds",
                            time.perf_counter() - t_dev,
                            shard=i, path=label)
                met.inc("repro_serve_shard_elements_total", elems, shard=i)

        threads = [
            threading.Thread(target=worker, args=(i,),
                             name=f"serve-shard-{i}", daemon=True)
            for i in range(n_dev)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
    return results


@contextlib.contextmanager
def _device_ctx(dev):
    """On a card: ``torch.cuda.device(dev)`` and a new stream of the shard's
    own, synchronised (that stream alone) on the way out; on the CPU a
    no-op."""
    if dev.type != "cuda":
        yield
        return
    import torch

    with torch.cuda.device(dev):
        stream = torch.cuda.Stream(dev)
        # the stream starts after the work already queued on the caller's
        # stream (the tensors this thread reads were made there)
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                yield stream
        finally:
            stream.synchronize()
