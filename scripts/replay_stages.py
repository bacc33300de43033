"""Where the engine's replay stage spends its time on the card, by step, at
the replay kernel's seven shapes in ``chip_smoke.py``'s phase 2 (the §6
buckets, m = 1, the chain bucket ladder-padded as warm hits pack it, and
the campaign's largest bucket).

    python scripts/replay_stages.py          # from the repo root, one card

Each step is timed on the host clock with the card synchronised at both
ends (median of ``REPS`` runs after a warm-up): padding the fractions
(``gamma_padded``); the inputs to the card as ten tensors, one copy each,
and as one packed buffer in one copy, pageable or page-locked (the last is
what ``simulate_bucket`` does); the kernel's call; the outputs back as
seven copies and in one copy (``outputs_to_numpy``); and
``simulate_bucket`` whole, beside the same steps done with one copy a
tensor.  Prints the card's name and power limit,
then one JSON line per shape.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.core.instance import random_instance  # noqa: E402
from repro_torch.engine.arena import InstanceArena  # noqa: E402
from repro_torch.engine.batched_sim import simulate_bucket  # noqa: E402
from repro_torch.kernels import asap_replay  # noqa: E402
from repro_torch.kernels.asap_replay import outputs_to_numpy  # noqa: E402

REPS = 21


def wall_ms(fn) -> float:
    """Median host ms of ``fn()`` with the card synchronised before and after."""
    fn()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def fields(bucket, gamma):
    out = [bucket.w_cell, bucket.z, bucket.latency, bucket.tau, bucket.vcomm_cell,
           bucket.vcomp_cell, bucket.rel_cell, bucket.cell_valid, gamma]
    if bucket.has_returns and bucket.m > 1:
        out.append(bucket.ret_cell)
    return [np.asarray(a, dtype=np.float64) for a in out]


def separate_inputs(host, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host]


def packed_inputs(host, dev, pinned):
    """One host buffer, pageable or page-locked (``simulate_bucket``'s), in
    one copy."""
    buf = torch.empty(sum(a.size for a in host), dtype=torch.float64, pin_memory=pinned)
    np.concatenate([a.ravel() for a in host], out=buf.numpy())
    flat = buf.to(dev, non_blocking=pinned)
    return [x.view(a.shape) for x, a in zip(flat.split([a.size for a in host]), host)]


def replay(args, topology):
    ret = args[9] if len(args) == 10 else None
    return asap_replay(*args[:9], ret, topology=topology)


def main() -> int:
    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    chain = cs.population(rng, 256, "chain", False)
    shapes = [("chain", chain, False), ("star", cs.population(rng, 256, "star", False), False),
              ("chain_ret_rel", cs.population(rng, 64, "chain", True), False),
              ("star_ret_rel", cs.population(rng, 64, "star", True), False),
              ("m1", [random_instance(rng, m=1, n_loads=5, q=5) for _ in range(256)], False),
              ("chain_hit", chain, True),
              ("campaign", [random_instance(rng, m=8, n_loads=3, q=4, return_ratio=0.75)
                            for _ in range(64)], False)]
    for name, insts, ladder in shapes:
        (bucket,) = InstanceArena(insts, pad_shapes=ladder).buckets
        g = rng.uniform(0.0, 1.0, size=(bucket.B, bucket.m_real, bucket.T_real))
        g /= g.sum(axis=1, keepdims=True)
        gl = list(g)
        gamma = bucket.gamma_padded(gl)
        host = fields(bucket, gamma)
        args = packed_inputs(host, dev, True)
        out = replay(args, bucket.topology)
        row = dict(
            pad_ms=wall_ms(lambda: bucket.gamma_padded(gl)),
            h2d_separate_ms=wall_ms(lambda: separate_inputs(host, dev)),
            h2d_packed_pageable_ms=wall_ms(lambda: packed_inputs(host, dev, False)),
            h2d_packed_ms=wall_ms(lambda: packed_inputs(host, dev, True)),
            kernel_call_ms=wall_ms(lambda: replay(args, bucket.topology)),
            d2h_separate_ms=wall_ms(lambda: [o.cpu().numpy() for o in out if o is not None]),
            d2h_packed_ms=wall_ms(lambda: outputs_to_numpy(out)),
            simulate_bucket_ms=wall_ms(lambda: simulate_bucket(bucket, gamma, device=dev)),
            separate_copies_ms=wall_ms(lambda: [
                o.cpu().numpy() for o in replay(separate_inputs(host, dev), bucket.topology)
                if o is not None]),
            input_bytes=8 * sum(a.size for a in host),
            output_bytes=8 * sum(o.numel() for o in out if o is not None))
        print(json.dumps(dict(shape=name, B=bucket.B, m=bucket.m, T=bucket.T, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
