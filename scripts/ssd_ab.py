"""Time the SSD scan of one tree of the port on the card, through its own
wrapper, at the served models' prefill shapes (``chip_smoke.py``'s inputs:
mamba2-2.7b's 80 heads of 64 with state 128 in float32 and bfloat16,
hymba-1.5b's 50 heads with state 16; B 4, S 512, chunk 256), in a fresh
process.

    python scripts/ssd_ab.py --src build/parent/src --label parent
    python scripts/ssd_ab.py --src src --label change

``--src`` is the ``src`` directory of the tree to time (its kernels built
from its own sources), so two versions (say a parent commit unpacked with
``git archive``) are timed in turns in one call on one card: parent,
change, change, parent.  Prints one JSON line: the card, the build seconds,
and per shape the device ms of a call (``chip_smoke.device_ms``, mean of
20) and of each of its kernels (``chip_smoke.kernel_stage_ms``).  With
``--ptxas`` it first builds the tree's ``ssd_scan.cu`` once more with
``-Xptxas -v`` (into ``build/ssd_ab/``) and adds, for the served sizes'
instantiations (P 64 with N 128 or 16), ptxas's registers, spill-store
bytes and stack frame bytes per kernel.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENTRY = re.compile(r"Compiling entry function '(\S+)'")
# the served sizes' instantiations: P 64 with N 128 (mamba2) or 16 (hymba)
SERVED = re.compile(r"(ssd_chunk_(?:state|scan)_kernel)I(f|13__nv_bfloat16)Li64ELi(128|16)E"
                    r"(Lb[01]E)?")


def ptxas_report(src: Path, label: str) -> dict:
    """ptxas's registers, spill stores and stack frame for the served
    sizes' instantiations of ``src``'s ``ssd_scan.cu``."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    cu = src / "repro_torch" / "csrc" / "ssd_scan.cu"
    out = ROOT / "build" / "ssd_ab" / f"{label}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(cu.parent), "-Xptxas", "-v", "-shared",
                          "-o", str(out), str(cu)], capture_output=True, text=True,
                         check=True).stderr
    per, key = {}, None
    for line in log.splitlines():
        entry = ENTRY.search(line)
        if entry:
            m = SERVED.search(entry.group(1))
            key = (f"{m.group(1)}_{'bf16' if m.group(2) != 'f' else 'f32'}_N{m.group(3)}"
                   + {"Lb0E": "", "Lb1E": "_gen", None: ""}[m.group(4)]) if m else None
            if key:
                per[key] = {}
        elif key and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)):
            per[key].update(stack_frame=int(m.group(1)), spill_store_bytes=int(m.group(2)))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            per[key]["registers"] = int(m.group(1))
    return per


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--ptxas", action="store_true",
                    help="also report ptxas's registers, spills and stack of the served sizes")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    # the tree under test first: chip_smoke puts this tree's src on the path
    # when imported, and a package once imported is the one every later
    # import of it finds
    sys.path.insert(0, str(src))
    import repro_torch.kernels

    if not Path(repro_torch.kernels.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.kernels.__file__}, not from {src}")
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.build import build_seconds, library

    if not torch.cuda.is_available():
        print("no CUDA device: this timing needs the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    ptxas = ptxas_report(src, args.label) if args.ptxas else None
    library()
    rows = {}
    for name, heads, dtype in (("mamba2_f32", cs.MAMBA2, torch.float32),
                               ("mamba2_bf16", cs.MAMBA2, torch.bfloat16),
                               ("hymba_f32", cs.HYMBA, torch.float32)):
        args_ = cs.ssd_inputs(dev, 4, 512, heads["H"], heads["P"], heads["N"], dtype, 1.0,
                              cs.SEED + 512 + heads["N"])
        ssd_scan(*args_, chunk=cs.SSD_CHUNK)
        rows[name] = dict(
            ms=cs.device_ms(lambda *a: ssd_scan(*a, chunk=cs.SSD_CHUNK), lambda: args_, reps=20),
            stage_ms=cs.kernel_stage_ms(lambda: ssd_scan(*args_, chunk=cs.SSD_CHUNK), reps=10))
    print(json.dumps({"label": args.label, "src": str(src), "card": cs.smi(),
                      "build_s": build_seconds(), "rows": rows,
                      **({"ptxas": ptxas} if ptxas is not None else {})}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
