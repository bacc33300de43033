"""Per-shape pivot-schedule autotuner for the compaction-epoch simplex driver.

The port of ``repro/engine/autotune.py``.  Two knobs matter per tableau
shape:

* ``k_pivots`` — how many pricing→ratio→update rounds fuse into one kernel
  launch.  Larger K amortizes the launch; a lane that finishes inside a
  launch costs nothing more (its blocks exit at once).
* ``n_launches`` — launches per epoch before the host reads how many lanes
  still run and drops the finished ones.  Derived so each epoch covers
  roughly ``_EPOCH_PIVOTS`` pivots regardless of K.

:func:`pivot_schedule` times a sweep over K on a probe stack: copies of the
first lanes of the bucket's own set-up stack (:func:`probe_stack`), which
are exactly as sparse as the tableaux the solve pivots — the kernel updates
only the rows an entering column changes, so a dense synthetic stack would
time its worst case.  Each K runs ``_PROBE_PIVOTS`` pivots' worth of
launches from the set-up, ended by one read of the iteration counts, on the
host clock; the cost is per pivot made.  The winner is memoized in-process
under ``(n_rows, n_cols, device type)`` (first entry wins when threads probe
one shape at once).  Results are timing decisions
only: every K gives the same bits (the kernel's per-round active mask), so
a "wrong" tune costs time, never correctness.
"""

from __future__ import annotations

import math
import time

import torch

from repro_torch.kernels import simplex_pivot
from repro_torch.kernels.build import STATE_LOCK
from repro_torch.obs.trace import span

__all__ = ["pivot_schedule", "probe_stack"]

_EPOCH_PIVOTS = 256  # target pivots per epoch between compaction passes
_SWEEP = (1, 4, 16, 64)  # candidate k_pivots values for the timed probe
_PROBE_B = 4  # lanes of the set-up stack the probe copies
_PROBE_PIVOTS = 64  # nominal pivots each candidate runs: _PROBE_PIVOTS // K launches

# (n_rows, n_cols, device type) -> {"k_pivots", "n_launches", "probe_s_per_pivot"}
_CACHE: dict[tuple[int, int, str], dict] = {}


def probe_stack(T, basis):
    """Copies of the first ``_PROBE_B`` lanes of the set-up stack ``T``,
    ``basis``, with their iteration counts at 0 and their statuses running."""
    n = min(_PROBE_B, T.shape[0])
    return (T[:n].clone(), basis[:n].clone(),
            torch.zeros(n, dtype=torch.int32, device=T.device),
            torch.full((n,), -1, dtype=torch.int32, device=T.device))


def pivot_schedule(T, basis, ncols_price: int, bland_after: int, max_iter: int,
                   sweep: tuple[int, ...] = _SWEEP) -> dict:
    """Pick (k_pivots, n_launches) for the set-up stack ``T`` [B, R, C] and
    its ``basis``, on the device they lie on; neither is changed.

    Returns the memoized ``{"k_pivots", "n_launches", "probe_s_per_pivot"}``
    entry; the first call per shape runs the timed sweep, later calls are a
    dict hit.
    """
    _, n_rows, n_cols = T.shape
    key = (int(n_rows), int(n_cols), T.device.type)
    with STATE_LOCK:
        hit = _CACHE.get(key)
    if hit is not None:
        return hit

    per_pivot: dict[int, float] = {}
    with span("engine.autotune", rows=int(n_rows), cols=int(n_cols)):
        for k in sweep:
            stack = probe_stack(T, basis)
            kw = dict(ncols_price=ncols_price, bland_after=bland_after, max_iter=max_iter)
            simplex_pivot(*stack, k_pivots=1, **kw)  # warm-up: one pivot
            before = int(stack[2].sum())  # waits for the card
            t0 = time.perf_counter()
            for _ in range(max(1, _PROBE_PIVOTS // k)):
                simplex_pivot(*stack, k_pivots=int(k), **kw)
            made = int(stack[2].sum()) - before  # waits for the card
            seconds = time.perf_counter() - t0
            per_pivot[int(k)] = seconds / made if made else math.inf
    # the cheapest pivot; with no pivot made (every probe lane finished) the
    # largest K, which needs the fewest launches
    best = min(per_pivot, key=lambda k: (per_pivot[k], -k))
    entry = {
        "k_pivots": best,
        "n_launches": max(1, _EPOCH_PIVOTS // best),
        "probe_s_per_pivot": per_pivot,
    }
    # two threads that probed the same shape at once keep the first entry,
    # so every solve of a shape runs one schedule
    with STATE_LOCK:
        return _CACHE.setdefault(key, entry)
