"""Where the batched simplex's time goes on the card, stage by stage.

    python scripts/pivot_stages.py            # from the repo root, one card

Solves three §6 buckets of ``chip_smoke.py`` (same seed: chain 256, star
256, returns + release chain 64) through
``repro_torch.engine.batched_simplex.solve_simplex_batched`` on the card,
after one warm-up solve of a small bucket (the first use of cuBLAS and
cuSOLVER), with a synchronised host clock around each stage (set-up, the
autotuner's probe, each phase's compaction epochs, the step between the
phases, extraction, the re-solve of the values), and under
``torch.profiler`` for the device time of the pivot kernel.  It counts the
kernel's launches by the number of lanes they carry.  One JSON line per
bucket; the card's name and power limit first.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.engine import autotune  # noqa: E402
from repro_torch.engine import batched_simplex as bs  # noqa: E402
from repro_torch.engine.arena import InstanceArena  # noqa: E402
from repro_torch.engine.batched_lp import build_lp_bucket  # noqa: E402

STAGES = ("_setup", "_phase_compact", "_between_phases", "_extract", "_refine")


def instrument(seconds: dict, lanes: list) -> None:
    """Wrap the simplex's stages with synchronised timers, and its kernel
    entry with a count of the lanes each launch carries."""
    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    for name in STAGES:
        setattr(bs, name, timed(name, getattr(bs, name)))
    autotune.pivot_schedule = timed("pivot_schedule", autotune.pivot_schedule)
    launch = bs.simplex_pivot_lanes

    def counted(*args, **kwargs):
        lanes.append(args[4].numel())
        return launch(*args, **kwargs)

    bs.simplex_pivot_lanes = counted


def solve(insts, dev):
    (bucket,) = InstanceArena(insts).buckets
    lp = build_lp_bucket(bucket)
    c = np.tile(lp.c, (bucket.B, 1))
    return bs.solve_simplex_batched(c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq, device=dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script times the simplex on the card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    buckets = {"chain": cs.population(rng, 256, "chain", False),
               "star": cs.population(rng, 256, "star", False),
               "chain_ret_rel": cs.population(rng, 64, "chain", True)}
    solve(cs.population(np.random.default_rng(1), 4, "chain", False), dev)  # warm-up
    seconds, lanes = {}, []
    instrument(seconds, lanes)
    for name, insts in buckets.items():
        seconds.clear()
        lanes.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve(insts, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernel_s = sum(e.device_time_total for e in prof.key_averages()
                       if "simplex_pivot_kernel" in e.key) / 1e6
        by_lanes = {"1": 0, "2-8": 0, "9-64": 0, ">64": 0}
        for n in lanes:
            by_lanes["1" if n == 1 else "2-8" if n <= 8 else "9-64" if n <= 64 else ">64"] += 1
        print(json.dumps(dict(bucket=name, simplex_wall_s=wall, stage_s=seconds,
                              pivot_kernel_device_s=kernel_s,
                              phases_busy_share=kernel_s / seconds["_phase_compact"],
                              launches=len(lanes), launches_by_lanes=by_lanes,
                              pivots=int(res.iterations.sum()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
