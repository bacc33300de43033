"""Per-shape pivot-schedule autotuner for the compaction-epoch simplex driver.

The port of ``repro/engine/autotune.py``.  Two knobs matter per tableau
shape:

* ``k_pivots`` — how many pricing→ratio→update rounds fuse into one kernel
  launch.  Larger K amortizes the launch (and the host's check between
  launches) but keeps a converged lane's block alive for nothing.
* ``n_launches`` — launches per epoch before the host drops the finished
  lanes.  Derived so each epoch covers roughly ``_EPOCH_PIVOTS`` pivots
  regardless of K.

:func:`pivot_schedule` times a small sweep over K on a synthetic probe
stack of the same tableau shape, on the device that will run the solve
(CUDA events on the card, the host clock on the CPU), and memoizes the
winner in-process under ``(n_rows, n_cols, device type)``.  Results are
timing decisions only: every K gives the same bits (the kernel's per-round
active mask), so a "wrong" tune costs time, never correctness.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.kernels import simplex_pivot

__all__ = ["pivot_schedule"]

_EPOCH_PIVOTS = 32  # target pivots per epoch between compaction passes
_SWEEP = (1, 2, 4)  # candidate k_pivots values for the timed probe
_PROBE_B = 8  # probe stack batch size
_PROBE_LAUNCHES = 2  # timed launches per candidate (after one warmup)

# (n_rows, n_cols, device type) -> {"k_pivots", "n_launches", "probe_s_per_pivot"}
_CACHE: dict[tuple[int, int, str], dict] = {}


def _probe_stack(n_rows: int, n_cols: int, device):
    """A synthetic [_PROBE_B, R, C] tableau stack that keeps pivoting: random
    positive body, negative objective row, so Dantzig always finds work."""
    rng = np.random.default_rng(n_rows * 1_000_003 + n_cols)
    T = rng.uniform(0.1, 1.0, size=(_PROBE_B, n_rows, n_cols))
    T[:, -1, :] = -rng.uniform(0.1, 1.0, size=(_PROBE_B, n_cols))
    T[:, :, -1] = rng.uniform(0.5, 1.5, size=(_PROBE_B, n_rows))
    basis = np.tile(np.arange(n_rows - 1, dtype=np.int32)[None, :], (_PROBE_B, 1))
    return (torch.from_numpy(T).to(device), torch.from_numpy(basis).to(device),
            torch.zeros(_PROBE_B, dtype=torch.int32, device=device),
            torch.full((_PROBE_B,), -1, dtype=torch.int32, device=device))


def _time_launches(device, stacks, launch) -> float:
    """Seconds for ``launch`` on each stack but the first, after one warmup
    launch on the first."""
    launch(stacks[0])
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for s in stacks[1:]:
            launch(s)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for s in stacks[1:]:
        launch(s)
    return time.perf_counter() - t0


def pivot_schedule(n_rows: int, n_cols: int, device=None,
                   sweep: tuple[int, ...] = _SWEEP) -> dict:
    """Pick (k_pivots, n_launches) for tableaux of shape [R=n_rows, C=n_cols]
    on ``device`` (None: the card).

    Returns the memoized ``{"k_pivots", "n_launches", "probe_s_per_pivot"}``
    entry; the first call per shape runs the timed sweep, later calls are a
    dict hit.
    """
    dev = resolve_device(device)
    key = (int(n_rows), int(n_cols), dev.type)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit

    max_iter = _EPOCH_PIVOTS * 4  # plenty of headroom for the probe
    per_pivot: dict[int, float] = {}
    for k in sweep:
        # a fresh stack per launch (copied before the clock starts) keeps
        # every lane pivoting
        base = _probe_stack(n_rows, n_cols, dev)
        stacks = [[x.clone() for x in base] for _ in range(_PROBE_LAUNCHES + 1)]

        def launch(stack, k=k):
            simplex_pivot(*stack, ncols_price=n_cols - 1, bland_after=max_iter,
                          max_iter=max_iter, k_pivots=int(k))

        per_pivot[int(k)] = _time_launches(dev, stacks, launch) / (_PROBE_LAUNCHES * k)
    best = min(per_pivot, key=per_pivot.get)
    entry = {
        "k_pivots": best,
        "n_launches": max(1, _EPOCH_PIVOTS // best),
        "probe_s_per_pivot": per_pivot,
    }
    _CACHE[key] = entry
    return entry
