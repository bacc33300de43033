"""Split the SSD scan's time by stage on the card: time variants of
``src/repro_torch/csrc/ssd_scan.cu`` with one part of the work cut out.

    python scripts/ssd_stages.py          # from the repo root, one card

A variant is the source with one edit (below), built by ``nvcc`` with the
library's flags into ``build/ssd_variants/<name>/`` (one ``nvcc`` each, all
started together) and called through the port's wrapper with its library
swapped in.  A variant's output is wrong by design: only its time is read.

* ``base``: the source as it is;
* ``no_intra_mma``: the output kernel skips the decayed scores times xbar;
* ``no_carried``: the output kernel skips the carried state's term (its
  staging and product);
* ``one_pass_tf32``: every product one TF32 pass (hi * hi), not the split;
* ``no_diag_exp``: the diagonal tile's decay from the off-diagonal product;
* ``no_state_mma``: the states kernel skips its product.

At mamba2-2.7b's and hymba-1.5b's prefill shapes (``chip_smoke.py``'s
inputs, float32): one JSON line per shape with each variant's device ms
(CUDA events, two rounds of 10 calls, the variants in turn) and its three
kernels' ms from the profiler.  Prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import chip_smoke as cs  # noqa: E402
import repro_torch.kernels.ssd_scan  # noqa: E402,F401  (the package's name for it is the function)
from repro_torch.kernels import build  # noqa: E402

mod = sys.modules["repro_torch.kernels.ssd_scan"]
SRC = REPO / "src" / "repro_torch" / "csrc"
OUT = REPO / "build" / "ssd_variants"
VARIANTS = {
    "base": [],
    "no_intra_mma": [("      warp_mma<WG::kTM, WG::kTN, true, true>(\n"
                      "          acc, m0, n0, kT, [&](int r, int k) { return ps[r * kPS + k]; },",
                      "      if (L < 0) warp_mma<WG::kTM, WG::kTN, true, true>(\n"
                      "          acc, m0, n0, kT, [&](int r, int k) { return ps[r * kPS + k]; },")],
    "no_carried": [("  if (c > 0) {  // the state entering", "  if (L < 0 && c > 0) {  // the state entering")],
    "one_pass_tf32": [("        if (SA) mma_tf32(acc[i][j], al[i], bh0, bh1);\n"
                       "        if (SB) mma_tf32(acc[i][j], ah[i], bl0, bl1);", "")],
    "no_diag_exp": [("const double f = diag ? exp(cum[l] - cum[sl]) : ul[r] * vs[c2];",
                     "const double f = ul[r] * vs[c2];")],
    "no_state_mma": [("    if (warp < WG::kBusy)\n      warp_mma<WG::kTM, WG::kTN, true, kSplitB>(",
                      "    if (L < 0 && warp < WG::kBusy)\n      warp_mma<WG::kTM, WG::kTN, true, kSplitB>(")],
}


def start_build(name, edits):
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    s = (SRC / "ssd_scan.cu").read_text()
    for old, new in edits:
        if old not in s:
            raise RuntimeError(f"variant {name}: the source no longer holds {old[:60]!r}")
        s = s.replace(old, new)
    (d / "ssd_scan.cu").write_text(s)
    for f in ("common.cuh", "errors.cu"):
        (d / f).write_text((SRC / f).read_text())
    nvcc, flags = build._nvcc(), " ".join(build.NVCC_FLAGS)
    return subprocess.Popen(
        f"{nvcc} {flags} -c {d}/ssd_scan.cu -o {d}/ssd.o && {nvcc} {flags} -c {d}/errors.cu "
        f"-o {d}/err.o && {nvcc} -shared {' '.join(build.NVCC_FLAGS[:2])} -o {d}/lib.so "
        f"{d}/ssd.o {d}/err.o", shell=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def load(name):
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    for fn_name, argtypes in build._SIGNATURES.items():
        if fn_name.startswith("repro_ssd_scan"):
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = build._RESTYPES.get(fn_name, ctypes.c_int)
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    print(cs.smi(), flush=True)
    procs = {n: start_build(n, e) for n, e in VARIANTS.items()}
    libs = {}
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {n} did not build:\n{out[-3000:]}")
        libs[n] = load(n)
    dev = torch.device("cuda")
    for case, heads in (("mamba2_f32", cs.MAMBA2), ("hymba_f32", cs.HYMBA)):
        args = cs.ssd_inputs(dev, 4, 512, heads["H"], heads["P"], heads["N"], torch.float32,
                             1.0, cs.SEED)
        row = {}
        for rnd in range(2):
            for n, lib in libs.items():
                mod.library = lambda lib=lib: lib
                ms = cs.device_ms(lambda *a: mod.ssd_scan(*a, chunk=cs.SSD_CHUNK), lambda: args,
                                  reps=10)
                row.setdefault(n, {}).setdefault("ms", []).append(ms)
                if rnd == 0:
                    row[n]["stage_ms"] = cs.kernel_stage_ms(
                        lambda: mod.ssd_scan(*args, chunk=cs.SSD_CHUNK), reps=5)
        print(json.dumps(dict(case=case, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
