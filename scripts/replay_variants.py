"""Time variants of the ASAP replay kernel on the card, at the seven shapes
of ``chip_smoke.py``'s phase 2, to split its time by part.

    python scripts/replay_variants.py          # from the repo root, one card
    python scripts/replay_variants.py --baseline build/parent/src/repro_torch/csrc/asap_replay.cu

A variant is ``src/repro_torch/csrc/asap_replay.cu`` with one edit, built by
``nvcc`` into ``build/replay_variants/`` (all variants in parallel) and
called through its C entry point with ctypes:

* ``design``: the source as it is;
* ``no_recurrence``: lane 0's recurrence left out (staging, durations,
  write-back and the launch remain; outputs wrong);
* ``empty``: every block returns at once (the launch alone);
* ``returns_first``: a cell's ``rel`` read after the previous cell's
  returns, so the sends cannot start before those returns are stored (the
  two chains run one after the other);
* ``branchy_max``: ``mx`` with an early return for NaN, a branch in every
  max, as the kernel had it before.

Each is timed by ``chip_smoke.device_ms`` (CUDA events around each call,
all enqueued behind a sleep kernel; mean of 50).  Prints the card's name and
power limit, a line per variant with its build seconds and ptxas's
registers and spills, then one JSON line per shape with each variant's ms
and the chain's floor (``chip_smoke.chain_floor_ms``).  The inputs are
``chip_smoke.py``'s (same seed, same order).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
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
from repro_torch.kernels.build import NVCC_FLAGS, SOURCE_DIR, _nvcc, _SIGNATURES  # noqa: E402

OUT = REPO / "build" / "replay_variants"
RECURRENCE = "      // ---- the recurrence, lane 0 ----\n      if (lane == 0) {"
INSTANCES = "  for (int b = blockIdx.x; b < B; b += gridDim.x) {"
MX = "__device__ __forceinline__ double mx(double a, double b) {"
REL = "          const double rel_t = s_rel[tt];\n"
RETURNS = "          if (RET) returns(tt - 1, dret);\n"
VARIANTS = {
    "design": [],
    "no_recurrence": [(RECURRENCE, RECURRENCE.replace("lane == 0", "lane < 0"))],
    "empty": [(INSTANCES, INSTANCES.replace("b < B", "b < 0"))],
    "returns_first": [(REL + "          auto dret", "          auto dret"),
                      (RETURNS, RETURNS + REL)],
    "branchy_max": [(re.compile(re.escape(MX) + r".*?\n"),
                     MX + "\n  if (isnan(a) || isnan(b)) return nan(\"\");\n"
                     "  return a > b ? a : b;\n}\n")],
}


def build_variants(baseline: Path | None) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    src = (SOURCE_DIR / "asap_replay.cu").read_text()
    variants = dict(VARIANTS)
    if baseline is not None:
        variants["baseline"] = []
    procs = {}
    for name, edits in variants.items():
        text = baseline.read_text() if name == "baseline" else src
        for old, new in edits:
            if isinstance(old, re.Pattern):
                text, n = old.subn(lambda _: new, text, count=1)
            else:
                n = text.count(old)
                text = text.replace(old, new)
            if n != 1:
                raise RuntimeError(f"variant {name}: an edit matched {n} times")
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SOURCE_DIR), "-Xptxas", "-v", "-shared",
               "-o", str(OUT / f"{name}.so"), str(cu)]
        procs[name] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (t0, proc) in procs.items():
        log, _ = proc.communicate()
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
        print(json.dumps(dict(variant=name, build_s=build_s, max_registers=max(regs),
                              spill_store_bytes=spills)), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.repro_asap_replay.argtypes = _SIGNATURES["repro_asap_replay"]
        libs[name] = lib
    return libs


def call(lib, args, ret, outs, star):
    B, m, T = args[-1].shape
    ptr = [a.data_ptr() for a in args]
    code = lib.repro_asap_replay(
        *ptr[:7], None if ret is None else ret.data_ptr(), ptr[7], ptr[8],
        *[None if o is None else o.data_ptr() for o in outs], B, m, T, int(star),
        torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"launch failed: CUDA error {code}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", type=Path, default=None,
                        help="another asap_replay.cu (say, the parent commit's) to time beside "
                             "the variants, as variant 'baseline'")
    opts = parser.parse_args()
    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    libs = build_variants(opts.baseline)
    rng = np.random.default_rng(cs.SEED)
    chain = cs.population(rng, 256, "chain", False)
    star = cs.population(rng, 256, "star", False)
    chain_rr = cs.population(rng, 64, "chain", True)
    star_rr = cs.population(rng, 64, "star", True)
    shapes = [("chain", chain, False), ("star", star, False), ("chain_ret_rel", chain_rr, False),
              ("star_ret_rel", star_rr, False),
              ("m1", [random_instance(rng, m=1, n_loads=5, q=5) for _ in range(256)], False),
              ("chain_hit", chain, True),
              ("campaign", [random_instance(rng, m=8, n_loads=3, q=4, return_ratio=0.75)
                            for _ in range(64)], False)]
    for name, insts, ladder in shapes:
        (bucket,) = InstanceArena(insts, pad_shapes=ladder).buckets
        args, ret = cs.replay_args(bucket, dev, rng)
        B, m, T = args[-1].shape
        new = dict(dtype=torch.float64, device=dev)
        outs = [torch.empty(B, m - 1, T, **new), torch.empty(B, m - 1, T, **new),
                torch.empty(B, m, T, **new), torch.empty(B, m, T, **new)]
        outs += [torch.empty(B, m - 1, T, **new) if ret is not None else None for _ in range(2)]
        outs.append(torch.empty(B, **new))
        star_ = bucket.topology == "star"
        row = {v: cs.device_ms(lambda lib=lib: call(lib, args, ret, outs, star_), lambda: (),
                               reps=50)
               for v, lib in libs.items()}
        row["chain_floor"] = cs.chain_floor_ms(cs.chain_steps(m, T, ret is not None), dev)
        print(json.dumps(dict(shape=name, B=B, m=m, T=T, returns=ret is not None,
                              ms=row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
