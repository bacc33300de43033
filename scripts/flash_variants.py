"""Build geometry variants of the head-dim-256 flash-attention kernels and
time them on the card at paligemma-3b's prefill shape (B 4, 8 query heads on
one kv head, causal), beside PyTorch's SDPA, all in one process.

    python scripts/flash_variants.py                      # from the repo root, one card
    python scripts/flash_variants.py --baseline build/parent/src/repro_torch/csrc/flash_attention.cu
    python scripts/flash_variants.py --variants design --baseline build/parent/src/repro_torch/csrc/flash_attention.cu

A variant is ``src/repro_torch/csrc/flash_attention.cu`` with edits, built
by ``nvcc`` with ``-Xptxas -v`` into ``build/flash_variants/`` (all in
parallel) and called through its C entry point with ctypes.  The first
variant is the source as it is; the geometry variants set the kv tile's
keys, the stages and the warpgroups of ``Geo256Of<float>`` or
``Geo256Of<__nv_bfloat16>``.  A probe is a variant edited so that it
computes something else; it is timed, not checked:

* ``probe_no_reload``: the head-dim-256 kernel loads only its first
  ``kStages`` K and V tiles and reuses them for every later tile (no wait on
  the copies after the first ones): the time of the products, the softmax
  and the warpgroups' meeting without the stream of tiles from L2;
* ``probe_no_s``, ``probe_no_pv``, ``probe_no_softmax``: its S products,
  its P V products or its online softmax left out: what each costs.

``order_by_head`` is the design with its blocks in the grid's order from
before it (each head's q tiles heaviest first, head after head) in place of
its own (every head's heaviest q tiles first, the blocks resident at once
paired heavy with light); ``order_heavy_first`` keeps every head's heaviest
q tiles first but does not pair the resident blocks.

``--baseline`` adds an older source built as it is (its entry point
without a workspace, or without the q offset, is detected), so the designs before and after a
change are timed in the same run on the same card; then both are also timed
at the served models' head dims up to 128 (llama3.2-3b's heads,
hymba-1.5b's with its window of 1,024, kimi-k2-1t-a32b's at head dim 112;
B 4, S 512, causal, both types) in the order baseline, design, design,
baseline.  ``--variants`` builds only the named variants (``design`` is
always built).

Prints the card's name and power limit, a line per build with its seconds
and, per kernel instantiation, ptxas's registers, spill-store bytes and any
C7514 warning (wgmma serialised), then a JSON line per (dtype, S) with each
variant's device ms (``chip_smoke.device_ms``, mean of 20), the float32
split kernel's share of the call from the profiler, SDPA's ms and the
bound, every output held against ``flash_attention_plain`` at
``chip_smoke.ATTN_TOL``.
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

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import flash_attention_plain  # noqa: E402
from repro_torch.kernels.build import NVCC_FLAGS, SOURCE_DIR, _SIGNATURES, _nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import _tma_strides, workspace_bytes  # noqa: E402

OUT = REPO / "build" / "flash_variants"
NO_RELOAD = [
    (re.compile(r"^( *)mbar_wait\((kfull0|vfull0) \+ 8 \* s, parity\);", re.M),
     r"\1if (i < kStages) mbar_wait(\2 + 8 * s, parity);"),
    (re.compile(r"^ *if \(threadIdx.x == 0 && i \+ kStages < n\) load_k\(i \+ kStages\);\n", re.M),
     ""),
    (re.compile(r"^ *if \(threadIdx.x == 0\) load_v\(i \+ kStages\);\n", re.M), ""),
]
# the head-dim-256 kernel's S products, its P V products or its softmax left out
NO_S = [(re.compile(r"^ *wgmma_s_(tf32_rs|tf32_ss|bf16_ss)<G::kBK>\(d, [^;]*;\n", re.M), "")]
NO_PV = [(re.compile(r"^ *wgmma_m64n128k8_tf32_rs\(acc, [^;]*;\n", re.M), ""),
         (re.compile(r"^ *wgmma_m64n128k16_rs\(\n[^;]*;\n", re.M), "{}\n")]
NO_SOFTMAX = [(re.compile(r"    if \(edge\)\n      online_softmax<kNB, true>\(sc, m, l, alpha, k0, nk, "
                          r"q0 \+ r0, [^;]*;\n    else\n[^;]*;\n"),
               "    alpha[0] = alpha[1] = 1.f;\n")]
# blocks in the order of the grid before this design: each head's q tiles
# heaviest first, head after head
BY_HEAD = [(re.compile(r"  const int rank = first >= n_sm && first < end [^;]*;\n"),
            "  const int rank = first % (n_blocks / (H * B)) * (H * B) + first / (n_blocks / (H * B));\n")]
# every head's heaviest q tiles first, without pairing the resident blocks
HEAVY_FIRST = [(re.compile(r"  const int rank = first >= n_sm && first < end [^;]*;\n"),
                "  const int rank = first;\n")]


def geometry(dtype: str, bk: int, stages: int, wgs: int) -> list:
    """The edit that gives ``Geo256Of<dtype>`` this kv tile, stage count and
    warpgroup count."""
    return [(re.compile(rf"(using G = Geo256<{re.escape(dtype)}, )\d+, \d+, \d+>;"),
             rf"\g<1>{bk}, {stages}, {wgs}>;")]


F32, BF16 = "float", "__nv_bfloat16"
# name: the source edits; the first is the source as it is, a name starting
# with "probe" is not checked
VARIANTS = {
    "design": [],
    "order_by_head": BY_HEAD,
    "order_heavy_first": HEAVY_FIRST,
    "f32_bk16_st2+bf16_1wg_bk32_st2": geometry(F32, 16, 2, 2) + geometry(BF16, 32, 2, 1),
    "f32_bk16_st1+bf16_1wg_bk64_st2": geometry(F32, 16, 1, 2) + geometry(BF16, 64, 2, 1),
    "bf16_2wg_bk64_st2": geometry(BF16, 64, 2, 2),
    "probe_no_reload": NO_RELOAD,
    "probe_no_s": NO_S,
    "probe_no_pv": NO_PV,
    "probe_no_softmax": NO_SOFTMAX,
}
ENTRY = re.compile(r"Compiling entry function '(\S+)'")
OLD_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
# the entry point with a workspace, before the q offset
NO_OFFSET_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [
    ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def kernel_name(mangled: str) -> str:
    """A short name for an instantiation: the kernel, its type and (head dim
    256) its geometry."""
    for name in ("flash_attention_d256_kernel", "flash_attention_split_kv_kernel",
                 "flash_attention_wide_kernel", "flash_attention_kernel"):
        if name in mangled:
            dtype = "bfloat16" if "nv_bfloat16" in mangled else "float32"
            geo = re.search(r"Geo256I(?:f|13__nv_bfloat16|S\d*_)Li(\d+)ELi(\d+)ELi(\d+)E", mangled)
            d = re.search(r"kernelI(?:f|13__nv_bfloat16)Li(\d+)E", mangled)
            tag = (f"_bk{geo.group(1)}_st{geo.group(2)}_wg{geo.group(3)}" if geo
                   else (f"_D{d.group(1)}" if d else ""))
            if re.search(r"kernelI(?:f|13__nv_bfloat16)Li\d+ELb0E", mangled):
                tag += "_narrow"  # o's columns stored with a test of each pair
            return f"{name}_{dtype}{tag}"
    return mangled


def ptxas_report(log: str) -> dict:
    per, key = {}, None
    for line in log.splitlines():
        entry = ENTRY.search(line)
        if entry:
            key = kernel_name(entry.group(1))
            per[key] = {"c7514": []}
        elif "C7514" in line:
            per.setdefault(key or "?", {"c7514": []})["c7514"].append(line.strip())
        elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
            per[key]["spill_store_bytes"] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            per[key]["registers"] = int(m.group(1))
    return per


def build(baseline: Path | None, names) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    source = (SOURCE_DIR / "flash_attention.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        if name not in names:
            continue
        text = source
        for pattern, repl in edits:
            text, count = pattern.subn(repl, text)
            if count == 0:
                raise RuntimeError(f"variant {name}: an edit matched nothing")
        src = OUT / (name.replace("+", "__") + ".cu")
        src.write_text(text)
        jobs[name] = (src, SOURCE_DIR)
    if baseline is not None:
        jobs["baseline"] = (baseline, baseline.parent)
    procs = {}
    for name, (src, inc) in jobs.items():
        so = OUT / (name.replace("+", "__") + ".so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(inc), "-Xptxas", "-v", "-shared",
               "-o", str(so), str(src)]
        procs[name] = (so, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, t0, proc) in procs.items():
        log, _ = proc.communicate()
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        warnings = [ln.strip() for ln in log.splitlines() if "warning" in ln.lower()]
        print(json.dumps(dict(variant=name, build_s=build_s, ptxas=ptxas_report(log),
                              warnings=warnings)), flush=True)
        lib = ctypes.CDLL(str(so))
        lib.takes_offset = "q_offset" in Path(jobs[name][0]).read_text()
        if lib.takes_offset:
            lib.repro_flash_attention.argtypes = _SIGNATURES["repro_flash_attention"]
        elif hasattr(lib, "repro_flash_attention_split_tile"):
            lib.repro_flash_attention.argtypes = NO_OFFSET_SIGNATURE
        else:  # an entry point from before the workspace
            lib.repro_flash_attention.argtypes = OLD_SIGNATURE
        if hasattr(lib, "repro_flash_attention_split_tile"):
            lib.repro_flash_attention_split_tile.argtypes = []
        libs[name] = lib
    return libs


def caller(lib, q, k, v, causal: bool, window: int = 0):
    """One kernel call of ``lib`` (with a workspace of its own where it takes one)."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    new = hasattr(lib, "repro_flash_attention_split_tile")
    nbytes = workspace_bytes(B, KVH, Sk, D, q.dtype, lib.repro_flash_attention_split_tile()) \
        if new else 0
    ws = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=q.device)
    o = torch.empty_like(q)
    tail = (B, H, KVH, Sq, Sk, D, int(q.dtype == torch.bfloat16), *_tma_strides(q),
            *_tma_strides(k), *o.stride()[:3], int(causal), window,
            *((0,) if lib.takes_offset else ()), ctypes.c_float(D ** -0.5))

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        if new:
            code = lib.repro_flash_attention(*ptrs, ws.data_ptr(), nbytes, *tail, stream)
        else:
            code = lib.repro_flash_attention(*ptrs, *tail, stream)
        if code != 0:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return o

    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another flash_attention.cu to build and time beside the variants")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to build (design always)")
    args = ap.parse_args()
    import torch.nn.functional as F

    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    libs = build(args.baseline, {"design", *args.variants.split(",")})
    B, H, KVH, D = 4, cs.PALIGEMMA["H"], cs.PALIGEMMA["KVH"], cs.PALIGEMMA["D"]
    for dtype in (torch.float32, torch.bfloat16):
        for S in (512, 1024):
            gen = torch.Generator(device=dev).manual_seed(cs.SEED + S)
            q, k, v = (cs._rand(gen, s, dtype, dev)
                       for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
            want = flash_attention_plain(q, k, v, causal=True)
            row, split_share = {}, {}
            for name, lib in libs.items():
                call = caller(lib, q, k, v, causal=True)
                err = (call().float() - want.float()).abs().max().item()
                if not name.startswith("probe"):
                    cs.check(err <= cs.ATTN_TOL[dtype], f"{name} {dtype} S {S}: max |err| {err}")
                row[name] = cs.device_ms(lambda: call(), lambda: (), reps=20)
                if dtype == torch.float32 and hasattr(lib, "repro_flash_attention_split_tile"):
                    stage = cs.kernel_stage_ms(call, reps=10, kernels=cs.FLASH_D256_KERNELS)
                    total = sum(stage.values())  # 0 where the profiler saw no kernel
                    split_share[name] = stage[cs.FLASH_D256_KERNELS[0]] / total if total else None
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa_ms = cs.device_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True), lambda: (), reps=20)
            pairs = S * (S + 1) // 2
            flops = 4 * B * H * D * pairs
            nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, want))
            if dtype == torch.bfloat16:
                bound_ms, bound_by = cs._bound(nbytes, flops, cs.BF16_FLOP_PER_S)
            else:
                bound_ms, bound_by = cs._bound(nbytes, cs.SPLIT_TF32_PRODUCTS * flops,
                                               cs.TF32_FLOP_PER_S)
            print(json.dumps(dict(dtype=str(dtype), B=B, S=S, H=H, KVH=KVH, D=D, causal=True,
                                  ms=row, split_share=split_share, sdpa_ms=sdpa_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)), flush=True)
            del q, k, v, qt, kt, vt, want

    # the served head dims up to 128: the source against the baseline
    if "baseline" in libs:
        B, S = 4, 512
        for tag, heads, window in (("llama", cs.LLAMA, 0), ("hymba", cs.HYMBA_ATTN, 1024),
                                   ("kimi", cs.KIMI, 0)):
            H, KVH, D = heads["H"], heads["KVH"], heads["D"]
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device=dev).manual_seed(cs.SEED + S)
                q, k, v = (cs._rand(gen, s, dtype, dev)
                           for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
                want = flash_attention_plain(q, k, v, causal=True, window=window)
                row = {}
                for name in ("baseline", "design", "design", "baseline"):
                    call = caller(libs[name], q, k, v, causal=True, window=window)
                    err = (call().float() - want.float()).abs().max().item()
                    cs.check(err <= cs.ATTN_TOL[dtype], f"{name} {tag} {dtype}: max |err| {err}")
                    row.setdefault(name, []).append(cs.device_ms(lambda: call(), lambda: (),
                                                                 reps=20))
                print(json.dumps(dict(shape=tag, dtype=str(dtype), B=B, S=S, H=H, KVH=KVH, D=D,
                                      window=window, ms=row,
                                      change=sum(row["design"]) / sum(row["baseline"]) - 1)),
                      flush=True)
                del q, k, v, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
