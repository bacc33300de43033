"""Time variants of the simplex pivot kernel on the card, at the stacks where
its design choices matter.

    python scripts/pivot_variants.py          # from the repo root, one card

A variant is ``src/repro_torch/csrc/simplex_pivot.cu`` with three constants
edited — threads a block, 16-byte loads in flight per lane in the update,
blocks an SM in its launch bound — built by ``nvcc`` into
``build/pivot_variants/`` and called through its C entry point with ctypes.
Each is timed, by CUDA events over one K-pivot launch from a fresh copy of
the stack (mean of 3 after a warm-up), at explicit cluster sizes:

* ``dense64``: the 64 returns + release chain lanes (§6 scale, 1789 x 2736)
  after 300 plain rounds, K = 16, clusters of 2, 4 and 8 blocks;
* ``tail6``: their first 6 lanes, K = 16, clusters of 8 and 16;
* ``chain256``: the 256 chain lanes' set-up stack (1089 x 1811), K = 64,
  one block a lane.

One JSON line per (stack, variant, cluster): ms, elements the kernel wrote,
pivots, and the update's rate (16 bytes an element) in GB/s; first a line
per variant with ptxas's registers and spills.  Prints the card's name and
power limit first.  The inputs are ``chip_smoke.py``'s (same seed).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.engine.arena import InstanceArena  # noqa: E402
from repro_torch.kernels import simplex_pivot_plain  # noqa: E402
from repro_torch.kernels.build import NVCC_FLAGS, SOURCE_DIR, _nvcc  # noqa: E402

OUT = REPO / "build" / "pivot_variants"
# name -> (threads a block, 16-byte loads in flight a lane, blocks an SM)
VARIANTS = {"t512_v4_b2": (512, 4, 2), "t512_v8_b2": (512, 8, 2), "t1024_v4_b1": (1024, 4, 1),
            "t1024_v8_b1": (1024, 8, 1), "t256_v8_b3": (256, 8, 3)}


def build_variants() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    src = (SOURCE_DIR / "simplex_pivot.cu").read_text()
    procs = {}
    for name, (threads, vec, per_sm) in VARIANTS.items():
        text = re.sub(r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};", src)
        text = re.sub(r"constexpr int kVec = \d+;", f"constexpr int kVec = {vec};", text)
        text = re.sub(r"__launch_bounds__\(kThreads, \d+\)",
                      f"__launch_bounds__(kThreads, {per_sm})", text)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(json.dumps(dict(variant=name, registers=re.findall(r"Used (\d+) registers", log),
                              spill_store_bytes=re.findall(r"(\d+) bytes spill stores", log))),
              flush=True)
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).repro_simplex_pivot
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_launch(fn, stack, kw, k, cluster, counter, reps=3) -> dict:
    T = stack[0]
    B, R, C = T.shape
    times = []
    for rep in range(reps + 1):
        st = [x.clone() for x in stack]
        counter.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        code = fn(st[0].data_ptr(), st[1].data_ptr(), st[2].data_ptr(), st[3].data_ptr(), None,
                  B, B, R, C, kw["ncols_price"], kw["bland_after"], kw["max_iter"], k, cluster,
                  counter.data_ptr(), torch.cuda.current_stream().cuda_stream)
        end.record()
        end.synchronize()
        cs.check(code == 0, f"launch returned CUDA error {code}")
        if rep:
            times.append(start.elapsed_time(end))
    elements = int(counter.item())
    ms = sum(times) / reps
    return dict(ms=ms, elements=elements, pivots=int((st[2] - stack[2]).sum().item()),
                update_gb_per_s=16 * elements / ms / 1e6)


def bucket_stack(insts, dev):
    (bucket,) = InstanceArena(insts).buckets
    T, basis, kw = cs.setup_stack(bucket, dev)
    B = T.shape[0]
    return [T, basis, torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full((B,), -1, dtype=torch.int32, device=dev)], kw


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card", file=sys.stderr)
        return 2
    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    fns = build_variants()
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    rng = np.random.default_rng(cs.SEED)
    chain = cs.population(rng, 256, "chain", False)
    cs.population(rng, 256, "star", False)  # keep chip_smoke's draws
    chain_rr = cs.population(rng, 64, "chain", True)

    def emit(stack_name, stack, kw, k, clusters):
        for name, fn in fns.items():
            for cluster in clusters:
                row = time_launch(fn, stack, kw, k, cluster, counter)
                print(json.dumps(dict(stack=stack_name, variant=name, cluster=cluster, k_pivots=k,
                                      **row)), flush=True)

    stack, kw = bucket_stack(chain_rr, dev)
    simplex_pivot_plain(*stack, k_pivots=300, **kw)
    emit("dense64", stack, kw, 16, (2, 4, 8))
    tail = [x[:6].clone() for x in stack]
    del stack
    torch.cuda.empty_cache()
    emit("tail6", tail, kw, 16, (8, 16))
    del tail
    torch.cuda.empty_cache()
    stack, kw = bucket_stack(chain, dev)
    emit("chain256", stack, kw, 64, (1,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
