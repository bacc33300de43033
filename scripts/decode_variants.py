"""Build variants of the head-dim-256 decode-attention kernel and time them on
the card at paligemma-3b's decode shape (B 4, 8 query heads on one kv head, a
544-entry cache; also a 32,768-entry one), beside PyTorch's SDPA and an
older source, all in one process.

    python scripts/decode_variants.py                      # from the repo root, one card
    python scripts/decode_variants.py --baseline build/parent/src/repro_torch/csrc/decode_attention.cu
    python scripts/decode_variants.py --variants design --baseline build/parent/src/repro_torch/csrc/decode_attention.cu

A variant is ``src/repro_torch/csrc/decode_attention.cu`` with edits, built
by ``nvcc`` with ``-Xptxas -v`` into ``build/decode_variants/`` (all in
parallel) and called through its C entry points with ctypes.  The first
variant is the source as it is; it is also called with other clusters than
the wrapper picks (``design_c<blocks>``: clusters of 16, 8, 4 or 1 blocks).
The others:

* ``h4``: two clusters a (b, kv head) pair, each serving 4 of its 8 query
  heads (each reads the pair's K and V), called on clusters of 16 and 8;
* ``cp_async``: warp 0's lanes copy q and the cache with 16-byte
  ``cp.async`` in place of bulk copies;
* ``f32_w<e>_s<n>``, ``bf16_w<e>_s<n>``: ``Geo256Of<float>`` or
  ``Geo256Of<__nv_bfloat16>`` with ``e`` entries a warp of a stage and a
  ring of ``n`` stages;
* ``one_an_sm``: the launch asks for at least 116 KB of shared memory, so
  no two blocks share an SM (bfloat16's 111 KB blocks otherwise can);

and probes, which compute something else and are timed, not checked:
``probe_no_copies`` (no copy issued or waited for: the loop runs on stale
shared memory), ``probe_no_combine`` (each block stores its state into its
own shared memory in place of its peers': no remote store, no cluster
barrier after the start), ``probe_neither`` (both), ``probe_no_q`` (q's
rows not read from shared memory), ``probe_no_block_combine`` (the warps' accumulators not
merged through shared memory) and ``probe_empty`` (every block returns at
once: the launch of the clusters).

``--baseline`` adds an older source built as it is (its entry points
without a shard's ``kv_start`` and ``lse``, or without the head dim, are
detected), called through its head-dim-256 entry point on the cluster the
wrapper picks (a source without one: through the split-KV kernel's at the
split ``decode_split`` picks), so the designs before and after a change are
timed in the same run on the same card; its split-KV kernel is timed beside
the source's at llama3.2-3b's, hymba-1.5b's and kimi-k2-1t-a32b's shapes in
both types, in the order baseline, design, design, baseline.
``--variants`` builds only the named variants (``design`` is always built).

Each call is timed by ``chip_smoke.device_ms`` (mean of 30) with the L2 cache
flushed by a 100 MB write before it (``write``, phase 2's method) and warm
(``warm``), at cache lengths 1, 300 and 544 with and without a window of 64,
and at 8,192 and 32,768 of a 32,768-entry cache, beside the method's floor
(a one-element add timed the same way).  Prints the card's name and power
limit, a line per build with its seconds and ptxas's registers and
spill-store bytes per instantiation, the clusters the card holds at once
per size and type, then a JSON line per (dtype, cache, cache length,
window) with each variant's ms, SDPA's and the bound, every non-probe
output held against ``decode_attention_plain`` at ``chip_smoke.ATTN_TOL``.
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
from repro_torch.kernels import decode_attention_plain  # noqa: E402
from repro_torch.kernels.build import NVCC_FLAGS, SOURCE_DIR, _SIGNATURES, _nvcc  # noqa: E402
from repro_torch.kernels.decode_attention import decode_cluster_on, decode_split  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_width  # noqa: E402

OUT = REPO / "build" / "decode_variants"
F32, BF16 = "float", "__nv_bfloat16"


def geometry(dtype: str, we: int, stages: int) -> list:
    """The edit that gives ``Geo256Of<dtype>`` ``we`` entries a warp of a
    stage and ``stages`` stages."""
    return [(re.compile(rf"(using G = Geo256<{re.escape(dtype)}, )\d+, \d+>;"),
             rf"\g<1>{we}, {stages}>;")]


# warp 0's lanes copy q, K and V with 16-byte cp.async, each lane's arrival
# on the stage's barrier counted once its copies land: the kernel's own path
# for rows that bulk copies cannot take, here at every row
CP_ASYNC = [(re.compile(r"const bool bulk = unit == 16;"), "const bool bulk = false;")]
NO_COPIES = [
    (re.compile(r"^  if \(warp == 0\)\n    for \(int t = 0; t < min\(kStages, nt\); \+\+t\) "
                r"issue\(t\);\n", re.M), ""),
    (re.compile(r"^    mbar_wait\((kfull|vfull) \+ 8 \* s, par\);\n", re.M), ""),
    (re.compile(r"^  if \(nt > 0\) mbar_wait\(kfull, 0\);\n", re.M), ""),
    (re.compile(r"^    if \(warp == 0 && t \+ kStages < nt\) \{\n.*?\n    \}\n", re.M | re.S), ""),
]
NO_COMBINE = [
    (re.compile(r"^    // the block's state, pushed into its peers'.*?"
                r"^  cluster_wait\(\);    // acquire[^\n]*\n", re.M | re.S),
     "    cluster_wait();\n"
     "    store8f(in + g * kD256, lane, x);\n"
     "    if (lane == 0) in_ml[g] = M, in_ml[kHeads256 + g] = L;\n"
     "  }\n"),
]
NO_Q = [(re.compile(r"row8\(qs \+ g \* kD256, lane, qr\[g\]\);"),
         "for (int i = 0; i < 8; ++i) qr[g][i] = 1e-3f * (g + i);")]
NO_BLOCK_COMBINE = [
    (re.compile(r"^  for \(int g = 0; g < kHeads256; \+\+g\) store8f\(wacc[^\n]*\n", re.M), ""),
    (re.compile(r"load8f\(wacc \+ \(w \* kHeads256 \+ g\) \* kD256, lane, y\);"),
     "for (int i = 0; i < 8; ++i) y[i] = c;"),
]
EMPTY = [(re.compile(r"^(  cg::cluster_group cluster = cg::this_cluster\(\);\n)", re.M),
          r"  if (csize > 0) return;\n\1")]
# name: the source edits; the first is the source as it is, a name starting
# with "probe" is not checked
VARIANTS = {
    "design": [],
    "cp_async": CP_ASYNC,
    "h4": [(re.compile(r"constexpr int kGroupHeads = kHeads256;"),
            "constexpr int kGroupHeads = 4;")],
    "f32_w2_s4+bf16_w2_s4": geometry(F32, 2, 4) + geometry(BF16, 2, 4),
    "f32_w4_s1+bf16_w4_s1": geometry(F32, 4, 1) + geometry(BF16, 4, 1),
    "f32_w2_s2+bf16_w2_s8": geometry(F32, 2, 2) + geometry(BF16, 2, 8),
    "f32_w1_s4+bf16_w1_s8": geometry(F32, 1, 4) + geometry(BF16, 1, 8),
    "one_an_sm": [(re.compile(r"(ensure_smem\(kernel, |cfg->dynamicSmemBytes = )Gm::kSmem"),
                   r"\g<1>(Gm::kSmem > 116 * 1024 ? Gm::kSmem : 116 * 1024)")],
    "probe_no_copies": NO_COPIES,
    "probe_no_combine": NO_COMBINE,
    "probe_neither": NO_COPIES + NO_COMBINE,
    "probe_no_q": NO_Q,
    "probe_no_block_combine": NO_BLOCK_COMBINE,
    "probe_empty": EMPTY,
}
# the builds called with clusters of other sizes than the wrapper picks
CLUSTERS = {"design": (16, 8, 4, 1), "h4": (16, 8)}
ENTRY = re.compile(r"Compiling entry function '(\S+)'")
# the entry points before a shard's kv_start and lse
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
OLD_SIGNATURES = {"repro_decode_attention": [_P] * 9 + [_I] * 7 + [_L] * 7 + [_I, _F, _P],
                  "repro_decode_attention_d256": [_P] * 5 + [_I] * 5 + [_L] * 7 + [_I, _F, _I, _P]}
# the head-dim-256 entry point with a shard's kv_start and lse, before it
# took the head dim (it ran D = 256 only)
NO_DIM_D256 = [_P] * 6 + [_I] * 6 + [_L] * 7 + [_I, _F, _I, _P]


def kernel_name(mangled: str) -> str:
    """A short name for an instantiation: the kernel, its type and its
    geometry (head dim 256) or head dim."""
    dtype = "bfloat16" if "nv_bfloat16" in mangled else "float32"
    geo = re.search(r"Geo256I(?:f|13__nv_bfloat16|S\d*_)Li(\d+)ELi(\d+)E", mangled)
    if "decode_attention_d256_kernel" in mangled and geo:
        return f"d256_{dtype}_w{geo.group(1)}_s{geo.group(2)}"
    d = re.search(r"decode_attention_kernelI(?:f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?", mangled)
    if d is None:
        return mangled
    return f"split_{dtype}_D{d.group(1)}" + (f"_u{d.group(2)}" if d.group(2) else "")


def ptxas_report(log: str) -> dict:
    per, key = {}, None
    for line in log.splitlines():
        entry = ENTRY.search(line)
        if entry:
            key = kernel_name(entry.group(1))
            per[key] = {}
        elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
            per[key]["spill_store_bytes"] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            per[key]["registers"] = int(m.group(1))
    return per


def build(baseline: Path | None, names) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    source = (SOURCE_DIR / "decode_attention.cu").read_text()
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
        print(json.dumps(dict(variant=name, build_s=build_s, ptxas=ptxas_report(log))),
              flush=True)
        lib = ctypes.CDLL(str(so))
        text = Path(jobs[name][0]).read_text()
        lib.shards = "kv_start" in text
        lib.head_dim = "int Smax, int D, int bf16, int kv_start" in text
        signatures = _SIGNATURES if lib.shards else {**_SIGNATURES, **OLD_SIGNATURES}
        if lib.shards and not lib.head_dim:
            signatures = {**signatures, "repro_decode_attention_d256": NO_DIM_D256}
        lib.repro_decode_attention.argtypes = signatures["repro_decode_attention"]
        if hasattr(lib, "repro_decode_attention_d256"):
            for fn in ("repro_decode_attention_d256", "repro_decode_attention_d256_max_clusters"):
                getattr(lib, fn).argtypes = signatures[fn]
        libs[name] = lib
    return libs


def caller256(lib, q, kc, vc, n_t, window: int, cluster: int):
    """One call of ``lib``'s head-dim-256 kernel on clusters of ``cluster``
    blocks."""
    B, _, H, D = q.shape
    Smax, KVH = kc.shape[1], kc.shape[2]
    o = torch.empty_like(q)
    shard = (None,) if lib.shards else ()  # no lse
    tail = (B, H, KVH, Smax, *((D,) if lib.head_dim else ()), int(q.dtype == torch.bfloat16),
            *((0,) if lib.shards else ()),
            q.stride(0), q.stride(2), *kc.stride()[:3], o.stride(0), o.stride(2), window,
            ctypes.c_float(D ** -0.5), cluster)

    def call():
        code = lib.repro_decode_attention_d256(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), n_t.data_ptr(), o.data_ptr(), *shard,
            *tail, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return o

    return call


def caller_split(lib, q, kc, vc, n_t, window: int, split: int):
    """One call of ``lib``'s split-KV kernel at ``split`` with a workspace of
    its own."""
    B, _, H, D = q.shape
    Smax, KVH = kc.shape[1], kc.shape[2]
    n_split = -(-Smax // split)
    part = torch.empty(B * H * n_split * (kernel_width(D) + 2), device=q.device)
    counters = torch.zeros(B * KVH * -(-(H // KVH) // 8), dtype=torch.int32, device=q.device)
    o = torch.empty_like(q)
    n = B * H * n_split

    def call():
        code = lib.repro_decode_attention(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), n_t.data_ptr(), part.data_ptr(),
            part[n:].data_ptr(), part[2 * n:].data_ptr(), counters.data_ptr(), o.data_ptr(),
            *((None,) if lib.shards else ()), B, H, KVH, Smax, D, split,
            int(q.dtype == torch.bfloat16), *((0,) if lib.shards else ()), q.stride(0),
            q.stride(2), *kc.stride()[:3], o.stride(0), o.stride(2), window,
            ctypes.c_float(D ** -0.5), torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return o

    return call


def timed(call, flush) -> dict:
    def write():
        flush.zero_()
        return ()

    return {"write": cs.device_ms(lambda: call(), write, reps=30),
            "warm": cs.device_ms(lambda: call(), lambda: (), reps=30)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another decode_attention.cu to build and time beside the variants")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to build (design always)")
    args = ap.parse_args()
    import torch.nn.functional as F

    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    libs = build(args.baseline, {"design", *args.variants.split(",")})
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fits = {}
    for bf16 in (0, 1):
        for c in (1, 2, 4, 8, 16):
            out = ctypes.c_int(0)
            code = libs["design"].repro_decode_attention_d256_max_clusters(bf16, c,
                                                                          ctypes.byref(out))
            fits[f"{'bfloat16' if bf16 else 'float32'}_c{c}"] = out.value if code == 0 else code
    print(json.dumps(dict(max_active_clusters=fits, sms=n_sms)), flush=True)
    flush = torch.empty(2 * cs.L2_BYTES // 4, device=dev)
    one = torch.zeros(1, device=dev)
    print(json.dumps(dict(floor_add_ms=timed(lambda: one.add_(1.0), flush))), flush=True)

    B, H, KVH, D = 4, cs.PALIGEMMA["H"], cs.PALIGEMMA["KVH"], cs.PALIGEMMA["D"]
    for dtype, Smax in ((torch.float32, 544), (torch.bfloat16, 544), (torch.float32, 32768),
                        (torch.bfloat16, 32768)):
        picked = decode_cluster_on(dev, B, KVH, H // KVH, Smax)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
        q, kc, vc = (cs._rand(gen, s, dtype, dev)
                     for s in ((B, 1, H, D), (B, Smax, KVH, D), (B, Smax, KVH, D)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
        cases = (((1, 0), (300, 0), (544, 0), (1, 64), (300, 64), (544, 64)) if Smax == 544
                 else ((8192, 0), (32768, 0)))
        for n, window in cases:
            n_t = torch.tensor([n], dtype=torch.int32, device=dev)
            want = decode_attention_plain(q, kc, vc, n_t, window=window)
            calls = {}
            for name, lib in libs.items():
                if name == "baseline" and not hasattr(lib, "repro_decode_attention_d256"):
                    split = decode_split(B, KVH, H // KVH, Smax, n_sms)
                    calls[name] = caller_split(lib, q, kc, vc, n_t, window, split)
                elif name in CLUSTERS:
                    for c in CLUSTERS[name]:
                        calls[f"{name}_c{c}"] = caller256(lib, q, kc, vc, n_t, window, c)
                else:
                    calls[name] = caller256(lib, q, kc, vc, n_t, window, picked)
            row, errs = {}, {}
            for name, call in calls.items():
                errs[name] = (call().float() - want.float()).abs().max().item()
                if not name.startswith("probe"):
                    cs.check(errs[name] <= cs.ATTN_TOL[dtype],
                             f"{name} {dtype} len {n} window {window}: max |err| {errs[name]}")
                row[name] = timed(call, flush)
            idx = torch.arange(Smax, device=dev)
            valid = (idx < n) & ((idx > n - 1 - window) if window else True)
            n_valid = int(valid.sum().item())
            row["sdpa"] = timed(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=valid[None, :], enable_gqa=True), flush)
            nbytes = q.element_size() * (2 * B * KVH * n_valid * D + 2 * q.numel())
            rate = cs.BF16_FLOP_PER_S if dtype == torch.bfloat16 else cs.FP32_FLOP_PER_S
            bound_ms, bound_by = cs._bound(nbytes, 4 * B * H * D * n_valid, rate)
            print(json.dumps(dict(dtype=str(dtype), B=B, H=H, KVH=KVH, D=D, Smax=Smax,
                                  cache_len=n, window=window, picked_cluster=picked,
                                  entries_a_block=-(-n_valid // picked), ms=row,
                                  max_abs_err=errs, bound_ms=bound_ms, bound_by=bound_by)),
                  flush=True)
        del q, kc, vc, qt, kt, vt

    # the split-KV kernel at head dims <= 128: the source against the baseline
    Smax = 544
    if "baseline" in libs:
        for tag, heads, dtype in ((t, h, d) for t, h in (("llama", cs.LLAMA),
                                                         ("hymba", cs.HYMBA_ATTN),
                                                         ("kimi", cs.KIMI))
                                  for d in (torch.float32, torch.bfloat16)):
            H, KVH, D = heads["H"], heads["KVH"], heads["D"]
            gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
            q, kc, vc = (cs._rand(gen, s, dtype, dev)
                         for s in ((B, 1, H, D), (B, Smax, KVH, D), (B, Smax, KVH, D)))
            split = decode_split(B, KVH, H // KVH, Smax, n_sms)
            for n in (1, Smax):
                n_t = torch.tensor([n], dtype=torch.int32, device=dev)
                want = decode_attention_plain(q, kc, vc, n_t)
                row = {}
                for name in ("baseline", "design", "design", "baseline"):
                    call = caller_split(libs[name], q, kc, vc, n_t, 0, split)
                    err = (call().float() - want.float()).abs().max().item()
                    cs.check(err <= cs.ATTN_TOL[dtype], f"{name} {tag} {dtype} len {n}: {err}")
                    row.setdefault(name, []).append(timed(call, flush))
                change = {k: (sum(r[k] for r in row["design"])
                              / sum(r[k] for r in row["baseline"]) - 1) for k in ("write", "warm")}
                print(json.dumps(dict(shape=tag, dtype=str(dtype), H=H, KVH=KVH, D=D, Smax=Smax,
                                      cache_len=n, split=split, ms=row, change=change)),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
