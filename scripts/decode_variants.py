"""Time variants of the decode-attention kernel on the card, at the decode
steps' shapes of ``chip_smoke.py``'s phase 2 (a 544-entry cache; llama3.2-3b's
heads, hymba-1.5b's and paligemma-3b's at head dim 256), over the splits
the kernel takes.

    python scripts/decode_variants.py          # from the repo root, one card

A variant is ``src/repro_torch/csrc/decode_attention.cu`` with one edit,
built by ``nvcc`` into ``build/decode_variants/`` (all variants in parallel)
and called through its C entry point with ctypes:

* ``design``: the source as it is;
* ``serial_combine``: the last block's combine as it was before head dim
  256 came in: each thread walks all splits of each of its outputs twice
  (the max, then the weighted sums), the weights recomputed per output;
* ``unroll2``, ``unroll1``: the combine's loop over splits unrolled 2 or 1
  times instead of 4 (fewer loads in flight, fewer registers).

Each call is timed by ``chip_smoke.device_ms`` with the L2 cache flushed
before it (as phase 2 does; mean of 50), at the split the wrapper picks
(``decode_split``) and at every other split the kernel takes (16 to 64), and
its output is held against ``decode_attention_plain`` within phase 2's
tolerance.  Prints the card's name and power limit, a line per variant with
its build seconds and ptxas's registers and spill stores per instantiation
(dtype, head dim), then one JSON line per (shape, cache length) with each
variant's ms by split.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import decode_attention_plain  # noqa: E402
from repro_torch.kernels.build import NVCC_FLAGS, SOURCE_DIR, _SIGNATURES, _nvcc  # noqa: E402
from repro_torch.kernels.decode_attention import decode_split  # noqa: E402

OUT = REPO / "build" / "decode_variants"
COMBINE = re.compile(r"  // Each head's largest split max.*?(?=  if \(tid == 0\) \*counter = 0;)",
                     re.S)
SERIAL_COMBINE = """  for (int i = tid; i < Gc * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    const long long base = ((long long)b * H + h0 + g) * n_split;
    float m = -INFINITY;
    for (int s = s_lo; s < s_hi; ++s) m = fmaxf(m, __ldcg(part_m + base + s));
    float l = 0.f, a = 0.f;
    for (int s = s_lo; s < s_hi; ++s) {
      const float w = expf(__ldcg(part_m + base + s) - m);
      l = fmaf(__ldcg(part_l + base + s), w, l);
      a = fmaf(__ldcg(part_acc + (base + s) * D + d), w, a);
    }
    from_f32(o + b * osb + (h0 + g) * osh + d, a / fmaxf(l, 1e-30f));
  }
"""
SPLIT_LOOP = re.compile(r"#pragma unroll 4(?=\n    for \(int s = 0; s < nc; \+\+s\) \{)")
VARIANTS = {"design": [], "serial_combine": [(COMBINE, SERIAL_COMBINE)],
            "unroll2": [(SPLIT_LOOP, "#pragma unroll 2")],
            "unroll1": [(SPLIT_LOOP, "#pragma unroll 1")]}
ENTRY = re.compile(r"Compiling entry function "
                   r"'.*?decode_attention_kernelI(f|13__nv_bfloat16)Li(\d+)")
SHAPES = [("llama", cs.LLAMA), ("hymba", cs.HYMBA_ATTN), ("paligemma", cs.PALIGEMMA)]


def build_variants() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    src = (SOURCE_DIR / "decode_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            text, n = old.subn(lambda _: new, text, count=1)
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
        per, key = {}, None
        for line in log.splitlines():
            entry = ENTRY.search(line)
            if entry:
                key = ("float32" if entry.group(1) == "f" else "bfloat16") + "_D" + entry.group(2)
                per[key] = {}
            elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
                per[key]["spill_store_bytes"] = int(m.group(1))
            elif key and (m := re.search(r"Used (\d+) registers", line)):
                per[key]["registers"] = int(m.group(1))
        print(json.dumps(dict(variant=name, build_s=build_s, ptxas=per)), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.repro_decode_attention.argtypes = _SIGNATURES["repro_decode_attention"]
        libs[name] = lib
    return libs


def caller(lib, q, kc, vc, n_t, split):
    """A call of ``lib``'s kernel at ``split`` with a workspace of its own."""
    B, _, H, D = q.shape
    Smax, KVH = kc.shape[1], kc.shape[2]
    n_split = -(-Smax // split)
    part = torch.empty(B * H * n_split * (D + 2), device=q.device)
    counters = torch.zeros(B * KVH * -(-(H // KVH) // 8), dtype=torch.int32, device=q.device)
    o = torch.empty_like(q)
    n = B * H * n_split

    def call():
        code = lib.repro_decode_attention(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), n_t.data_ptr(), part.data_ptr(),
            part[n:].data_ptr(), part[2 * n:].data_ptr(), counters.data_ptr(), o.data_ptr(),
            B, H, KVH, Smax, D, split, 0, q.stride(0), q.stride(2), *kc.stride()[:3],
            o.stride(0), o.stride(2), 0, ctypes.c_float(D ** -0.5),
            torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return o

    return call


def main() -> int:
    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    libs = build_variants()
    B, Smax = 4, 544
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(2 * cs.L2_BYTES // 4, device=dev)

    def cold(*args):
        flush.zero_()
        return args

    for tag, heads in SHAPES:
        H, KVH, D = heads["H"], heads["KVH"], heads["D"]
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
        q, kc, vc = (torch.randn(s, generator=gen, device=dev)
                     for s in ((B, 1, H, D), (B, Smax, KVH, D), (B, Smax, KVH, D)))
        picked = decode_split(B, KVH, H // KVH, Smax, n_sms)
        for n in (1, 300, Smax):
            n_t = torch.tensor([n], dtype=torch.int32, device=dev)
            want = decode_attention_plain(q, kc, vc, n_t)
            row = {}
            for name, lib in libs.items():
                for split in (16, 32, 48, 64):
                    call = caller(lib, q, kc, vc, n_t, split)
                    err = (call() - want).abs().max().item()
                    cs.check(err <= cs.ATTN_TOL[torch.float32],
                             f"{name} {tag} len {n} split {split}: max |err| {err}")
                    row[f"{name}_split{split}"] = cs.device_ms(lambda: call(), lambda: cold(),
                                                               reps=50)
            print(json.dumps(dict(shape=tag, H=H, KVH=KVH, D=D, Smax=Smax, cache_len=n,
                                  picked_split=picked, ms=row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
