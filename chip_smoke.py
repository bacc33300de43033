"""Smoke run of the port on one CUDA card: builds the kernels, holds each
against its plain PyTorch version, drives the engine's bulk solve at the
paper's §6 scale, the serving paths of llama3.2-3b, mamba2-2.7b and
hymba-1.5b at full width and depth, and the golden campaign's full tier
through the planner's front door, and checks what comes out.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printing one JSON line:

1. ``device``: the card (``nvidia-smi``), torch and CUDA versions, the
   kernels' build time;
2. ``kernel``: each kernel against its plain version on the card, at the
   main paths' shapes (m = 10 processors, 5 loads, q = 5 installments:
   chain tableau 1089 x 1811, star 705 x 1427; attention at llama3.2-3b's
   and hymba-1.5b's heads with a batch of 4 prompts of 512 tokens and a
   544-entry cache; the
   SSD scan at mamba2-2.7b's and hymba-1.5b's heads over the same prompts,
   plus a ragged chunk and a weak decay under which the carried state
   matters; RMSNorm at the served models' norm shapes, which no path of the
   port runs yet), with times from CUDA events;
3. ``solve_bulk``: 256 chain + 256 star instances, 64 + 64 with returns and
   release dates, and two goldens, through ``repro_torch.engine.solve_bulk``
   on the card; the launch counts are set to 0 just before each call and
   read just after;
4. ``warm_hits``: the same population again through the solution cache;
   every hit replays through the replay kernel;
5. ``serve``, once per model: llama3.2-3b (28 layers, d_model 3072),
   mamba2-2.7b (64 Mamba-2 layers, d_model 2560) and hymba-1.5b (32 parallel
   attention + Mamba layers, d_model 1600), float32, seeded weights, through
   ``repro_torch.launch.serve``: 4 prompts of 512 ``make_batch`` tokens, 32
   greedy decode steps, with the launch counts set to 0 just before and read
   just after (each must be exactly the model's: one flash-attention and one
   SSD-scan launch per layer in the prefill, whichever the model has, one
   decode-attention launch per layer and step); then the prefill and the 32
   steps again through the plain path (``"naive"``: materialised attention,
   the step-by-step SSD recurrence), fed the same tokens, against the kernel
   path's logits and final cache (KV, Mamba state and conv window).  Each
   model is freed before the next is loaded;
6. ``campaign``: the golden campaign's full tier (``full_spec``, 1,296
   instances) through ``repro_torch.eval.run_campaign`` and a
   ``repro_torch.api.Session`` on the ``"cuda"`` backend, with the launch
   counts set to 0 just before and read just after, held against the
   committed ``bench_out/campaign.json`` and
   ``benchmarks/campaign_baseline.json`` (data files of the reference
   package, read here, not imported): 0 anomalies, domination 1.0, the same
   content keys in the same order, 1,080 ``heuristic-infeasible``, the same
   labels (save a flip between ``lp-fallback`` and ``lp-wins``/``tie`` on an
   instance one side served off its requested backend, each listed), ratios
   within 1e-9; then ``Session.evaluate_gammas`` on 256 solved artifacts
   against the serial simulator within 1e-9.

Then the ``{"kernels": [...]}`` line, the card's name and power limit, and
the final ``{"ok": true, ...}`` line.  Any failed check raises, so the
script exits non-zero before that line.  With no card, or without the
repository's ``src/`` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
FP64_FLOP_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12  # H100 SXM bfloat16 tensor cores, dense (NVIDIA data sheet)
L2_BYTES = 50 << 20
SEED = 20261017
GOLDEN_976 = 976.1527780792386  # star/ret0.75/rel0/m2/n3/q4/het1/cc0.02 (HiGHS)
GOLDEN_Q2 = 781.0 / 653.0 * 0.75  # the paper's §3 example at lambda = 3/4, Q = 2
RTOL = 1e-9
REPLAY_TOL = 1e-6  # the engine's certificate: replay <= LP * (1 + tol) + 1e-9


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, prepare, reps: int) -> float:
    """Mean milliseconds of ``fn(*prepare())`` by CUDA events, after one
    warm-up call; ``prepare`` (untimed) makes fresh inputs for each call."""
    fn(*prepare())
    total = 0.0
    for _ in range(reps):
        args = prepare()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(fn, prepare, reps: int) -> float:
    """Mean device milliseconds of ``fn(*prepare())``: CUDA events around
    each call, all enqueued while a sleep kernel holds the card, so no host
    gap falls between a pair of events (a call of a few microseconds would
    otherwise time the host's launch overhead).  ``prepare`` runs before
    each call's first event, untimed."""
    fn(*prepare())
    torch.cuda.synchronize()
    hold_s = 0.1
    torch.cuda._sleep(int(hold_s * 2.0e9))  # cycles; the H100's clock is at most 1.98 GHz
    t0 = time.perf_counter()
    events = []
    for _ in range(reps):
        args = prepare()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    check(enqueue_s < 0.5 * hold_s, f"device_ms: enqueueing took {enqueue_s:.3f} s, the hold "
          f"{hold_s} s; the events may include host gaps")
    return sum(a.elapsed_time(b) for a, b in events) / reps


# ---------------------------------------------------------------- inputs


def population(rng, n, topology, returns_and_release):
    from repro_torch.core.instance import Instance, Loads, random_instance

    out = []
    for _ in range(n):
        inst = random_instance(rng, m=10, n_loads=5, q=5, topology=topology,
                               return_ratio=0.5 if returns_and_release else 0.0)
        if returns_and_release:
            # release dates against the instance's own all-parallel makespan
            # scale, as the campaign draws them
            scale = float(np.mean(inst.platform.w) * inst.loads.v_comp.sum()) / inst.m
            ld = inst.loads
            inst = Instance(inst.platform, Loads(
                v_comm=ld.v_comm, v_comp=ld.v_comp,
                release=rng.uniform(0.0, 0.3 * scale, size=inst.N),
                return_ratio=ld.return_ratio), q=inst.q)
        out.append(inst)
    return out


def goldens():
    from repro_torch.core.instance import Chain, Instance, Loads, Star

    mis = Instance(
        Star(w=[2.306126709357919e-08, 1.7265569726405336e-08],
             z=[9.289405095685187e-08], tau=0.0, latency=[0.001]),
        Loads(v_comm=[990409583.4589807, 370593864.8133155, 616276888.6382855],
              v_comp=[49520479172.949036, 18529693240.665775, 30813844431.914276],
              release=0.0, return_ratio=0.75),
        q=4)
    example = Instance(Chain(w=[0.75, 0.75], z=[1.0]),
                       Loads(v_comm=[1.0, 1.0], v_comp=[1.0, 1.0]), q=2)
    return [mis, example], [GOLDEN_976, GOLDEN_Q2]


# ---------------------------------------------------------------- phase 2


def setup_stack(bucket, dev):
    from repro_torch.convert import to_tensor
    from repro_torch.engine import batched_simplex as bs
    from repro_torch.engine.batched_lp import build_lp_bucket

    lp = build_lp_bucket(bucket)
    c = np.tile(lp.c, (bucket.B, 1))
    T, basis, _, _ = bs._setup(*(to_tensor(a, dev, torch.float64)
                                 for a in (c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)))
    n, m_ub = c.shape[1], lp.A_ub.shape[1]
    m_rows = m_ub + lp.A_eq.shape[1]
    kw = dict(ncols_price=n + m_ub, bland_after=max(200, 4 * (m_rows + 1)), max_iter=20_000)
    return T, basis, kw


def pivot_work(T, basis, it, status, kw, k):
    """Pivots made, and rows of T an update must change (nonzero entries of
    the entering column), by one K-pivot launch on this stack — counted by
    running the plain version one round at a time."""
    from repro_torch.kernels import simplex_pivot_plain

    B, R, _ = T.shape
    touched = 0
    for _ in range(k):
        obj = T[:, -1, :kw["ncols_price"]]
        neg = obj < -1e-9
        first_neg = torch.where(neg, torch.arange(obj.shape[1], device=T.device),
                                obj.shape[1]).argmin(dim=1)
        col = torch.where(it < kw["bland_after"], obj.argmin(dim=1), first_neg)
        colv = T.gather(2, col[:, None, None].expand(B, R, 1))[:, :, 0]
        before = it.clone()
        simplex_pivot_plain(T, basis, it, status, k_pivots=1, **kw)
        touched += int(((colv != 0) & (it > before)[:, None]).sum().item())
    return int(it.sum().item()), touched


def pivot_phase(name, bucket, dev, n_compare=16, n_launches=6):
    from repro_torch.kernels import simplex_pivot, simplex_pivot_plain

    T0, basis0, kw = setup_stack(bucket, dev)
    B, R, C = T0.shape
    scale = T0.abs().max().item()
    zeros = lambda: torch.zeros(B, dtype=torch.int32, device=dev)  # noqa: E731
    running = lambda: torch.full((B,), -1, dtype=torch.int32, device=dev)  # noqa: E731
    rows = {}
    for k in (1, 4):
        # N launches of each from the same set-up stack, on a slice of lanes
        sub = [T0[:n_compare].clone(), basis0[:n_compare].clone(),
               zeros()[:n_compare].clone(), running()[:n_compare].clone()]
        ker = [x.clone() for x in sub]
        for _ in range(n_launches):
            simplex_pivot_plain(*sub, k_pivots=k, **kw)
            simplex_pivot(*ker, k_pivots=k, **kw)
        torch.cuda.synchronize()
        for a, b, what in zip(ker[1:], sub[1:], ("basis", "it", "status")):
            check(torch.equal(a, b), f"simplex_pivot {name} K={k}: {what} differs from plain")
        err = (ker[0] - sub[0]).abs().max().item()
        check(err <= 1e-12 * scale, f"simplex_pivot {name} K={k}: |dT| {err} > 1e-12 max|T|")

        # times: one launch over the whole bucket from its set-up stack
        def prepare():
            return T0.clone(), basis0.clone(), zeros(), running()

        def run(fn):
            return lambda T, b, it, st: fn(T, b, it, st, k_pivots=k, **kw)

        ms = cuda_ms(run(simplex_pivot), prepare, reps=5)
        plain_ms = cuda_ms(run(simplex_pivot_plain), prepare, reps=3)
        pivots, touched = pivot_work(*prepare(), kw, k)
        # the least work for these pivots: read the objective row, the
        # entering and rhs columns and the pivot row, and read + write only
        # the rows whose entering-column entry is nonzero (the rest are
        # unchanged by the rank-1 update); one fma per updated element
        nbytes = 8 * (2 * touched * C + pivots * 2 * (R + C))
        flops = 2 * touched * C
        bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP64_FLOP_PER_S)
        dense_bound_ms = 1e3 * 2 * R * C * 8 * pivots / HBM_BYTES_PER_S
        rows[k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP64_FLOP_PER_S
                       else "operations", max_abs_err=err, exact=err == 0.0)
        emit(phase="kernel", kernel="simplex_pivot", bucket=name, B=B, R=R, C=C, k_pivots=k,
             compared_lanes=n_compare, compared_launches=n_launches, max_abs_err=err,
             exact=err == 0.0, pivots_per_launch=pivots, touched_rows=touched, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, dense_bound_ms=dense_bound_ms,
             library_ms=None)
    del T0
    torch.cuda.empty_cache()
    return rows


def replay_args(bucket, dev, rng):
    from repro_torch.convert import to_tensor

    f64 = torch.float64
    g = rng.uniform(0.0, 1.0, size=(bucket.B, bucket.m, bucket.T))
    g /= g.sum(axis=1, keepdims=True)
    args = [to_tensor(a, dev, f64) for a in (
        bucket.w_cell, bucket.z, bucket.latency, bucket.tau, bucket.vcomm_cell,
        bucket.vcomp_cell, bucket.rel_cell, bucket.cell_valid, g)]
    ret = to_tensor(bucket.ret_cell, dev, f64) if bucket.has_returns and bucket.m > 1 else None
    return args, ret


def replay_cost(args, ret, outs, star):
    """Bytes each input read once and each output written once; float64
    operations of the recurrence (durations, maxes, adds) for these shapes."""
    B, m, T = args[-1].shape
    L = m - 1
    nbytes = 8 * (sum(a.numel() for a in args) + (ret.numel() if ret is not None else 0)
                  + sum(o.numel() for o in outs if o is not None))
    vol = 0 if star else L * (L - 1) // 2  # suffix sums per cell
    per_cell = vol + L * (4 + 4) + m * (3 + 1)
    if ret is not None:
        per_cell += vol + L * (4 + 4) + L
    return nbytes, B * T * (per_cell + 1) + B * m


def replay_phase(name, bucket, dev, rng):
    from repro_torch.kernels import asap_replay, asap_replay_plain

    args, ret = replay_args(bucket, dev, rng)
    want = asap_replay_plain(*args, ret, topology=bucket.topology)
    got = asap_replay(*args, ret, topology=bucket.topology)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if w is None:
            check(g is None, "replay slot")
            continue
        if w.numel():
            rel = ((g - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
            err = max(err, rel)
    check(err <= 1e-12, f"asap_replay {name}: relative error {err} > 1e-12")
    ms = cuda_ms(lambda *a: asap_replay(*a[:-1], a[-1], topology=bucket.topology),
                 lambda: (*args, ret), reps=20)
    plain_ms = cuda_ms(lambda *a: asap_replay_plain(*a[:-1], a[-1], topology=bucket.topology),
                       lambda: (*args, ret), reps=3)
    nbytes, flops = replay_cost(args, ret, got, bucket.topology == "star")
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP64_FLOP_PER_S)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP64_FLOP_PER_S
               else "operations", max_abs_err=max(
                   ((g - w).abs().max().item() for g, w in zip(got, want)
                    if w is not None and w.numel()), default=0.0))
    emit(phase="kernel", kernel="asap_replay", bucket=name, B=bucket.B, m=bucket.m, T=bucket.T,
         returns=ret is not None, max_rel_err=err, max_abs_err=row["max_abs_err"], ms=ms,
         plain_ms=plain_ms, bound_ms=bound_ms, library_ms=None)
    return row


# ---------------------------------------------------------------- phases 3, 4


def serial_makespan(inst) -> float:
    """The port's serial path (LP build, HiGHS, ASAP replay) with HiGHS's
    feasibility tolerances at 1e-10: at the default 1e-7 its optimum can sit
    ~1e-8 away from the exact one at this size, and the dense NumPy simplex
    (the other serial backend) can take minutes on a degenerate instance."""
    from scipy.optimize import linprog

    from repro_torch.core.lp import build_lp, extract_schedule
    from repro_torch.core.simulator import simulate

    lp = build_lp(inst)
    out = linprog(lp.c, A_ub=lp.sparse_ub(), b_ub=np.asarray(lp.b_ub),
                  A_eq=lp.sparse_eq(), b_eq=np.asarray(lp.b_eq), bounds=(0, None),
                  method="highs", options=dict(primal_feasibility_tolerance=1e-10,
                                               dual_feasibility_tolerance=1e-10))
    check(out.status == 0, f"serial HiGHS solve: {out.message}")
    return simulate(inst, extract_schedule(lp, out.x).gamma).makespan


def progress(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def bulk_phase(groups, dev, cache, phase):
    from repro_torch.core.solver import solve
    from repro_torch.engine import solve_bulk
    from repro_torch.kernels import launch_counts, reset_launch_counts

    totals = {"simplex_pivot": 0, "asap_replay": 0}
    for name, insts, golden in groups:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve_bulk(insts, cache=cache, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        progress(f"{phase} {name}: {len(insts)} instances in {wall:.2f} s")
        for k in totals:
            totals[k] += counts[k]
        hits = sum(bool(r.telemetry.get("cache_hit")) for r in res)
        statuses: dict = {}
        for r in res:
            statuses[r.telemetry["lp"]["status"]] = statuses.get(r.telemetry["lp"]["status"], 0) + 1
        rescues = sum("serial_rescue" in r.telemetry for r in res)
        pivots = sum(r.telemetry["lp"]["pivots_phase1"] + r.telemetry["lp"]["pivots_phase2"]
                     for r in res)
        for i, r in enumerate(res):
            check(r.ok, f"{name}[{i}] status {r.status}")
            check(r.makespan <= r.lp_makespan * (1 + REPLAY_TOL) + 1e-9,
                  f"{name}[{i}] has no replay certificate")
            check(r.backend.startswith("cuda") or "serial_rescue" in r.telemetry,
                  f"{name}[{i}] backend {r.backend}")
        if phase == "warm_hits":
            check(hits == len(insts), f"{name}: {hits} of {len(insts)} hits")
            check(counts["asap_replay"] > 0 and counts["simplex_pivot"] == 0,
                  f"{name}: warm launches {counts}")
        else:
            check(counts["simplex_pivot"] > 0 and counts["asap_replay"] > 0,
                  f"{name}: launches {counts}")
        if golden is not None:
            for r, g in zip(res, golden):
                check(abs(r.makespan - g) <= RTOL * g, f"{name}: {r.makespan} vs golden {g}")
        sample = list(range(0, len(insts), max(1, len(insts) // 16)))[:16]
        worst = 0.0
        if phase == "solve_bulk":
            for i in sample:
                # a rescued result *is* the serial solve (HiGHS at its
                # default tolerances at this size); the engine's own results
                # are held against the serial path at tight tolerances
                if "serial_rescue" in res[i].telemetry:
                    want = solve(insts[i]).makespan
                else:
                    want = serial_makespan(insts[i])
                worst = max(worst, abs(res[i].makespan - want) / want)
        # where the wall time went: the engine's per-bucket stage timings
        # (each bucket's results share them) and the serial rescues
        stages: dict = {}
        seen = set()
        for r in res:
            key = json.dumps(r.telemetry["bucket"], sort_keys=True)
            if key not in seen:
                seen.add(key)
                for k, v in r.telemetry["stages"].items():
                    if k not in ("cache_lookup_s", "pack_s") or len(seen) == 1:
                        stages[k] = stages.get(k, 0.0) + v
        if hits == len(res):  # one hit replay covers every bucket
            stages = dict(res[0].telemetry["stages"])
        stages["serial_rescue_s"] = sum(r.telemetry["serial_rescue"]["seconds"]
                                        for r in res if "serial_rescue" in r.telemetry)
        emit(phase=phase, bucket=name, B=len(insts), statuses=statuses, pivots=pivots,
             rescues=rescues, hits=hits, wall_s=wall, stages=stages, launches=counts,
             serial_max_rel_diff=worst if phase == "solve_bulk" else None,
             sample_rescued=sum("serial_rescue" in res[i].telemetry for i in sample))
        if phase == "solve_bulk":
            check(worst <= RTOL, f"{name}: serial solve differs by {worst}")
    return totals


# ---------------------------------------------------------------- attention kernels

LLAMA = dict(H=24, KVH=8, D=128)  # llama3.2-3b's attention heads
HYMBA_ATTN = dict(H=25, KVH=5, D=64)  # hymba-1.5b's (window 1024)
# kernel vs plain on the card: float32 computes the same function with sums
# in another order (~1e-6 at these lengths); bfloat16 rounds inputs and
# outputs to 8 bits of mantissa, both sides computing in float32 in between
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _bound(nbytes, flops, flop_rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_phase(dev):
    """flash_attention against its plain version at the prefills' shapes
    (llama3.2-3b's heads, and hymba-1.5b's with its 1024 window), plus
    bfloat16, a window and a length no tile divides; times of the kernel,
    the plain version and PyTorch's SDPA (the yardstick)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, flash_attention_plain

    B, S = 4, 512
    cases = [("causal_f32", LLAMA, S, torch.float32, 0),
             ("causal_bf16", LLAMA, S, torch.bfloat16, 0),
             ("window96_f32", LLAMA, S, torch.float32, 96),
             ("ragged500_f32", LLAMA, 500, torch.float32, 0),
             ("hymba_window1024_f32", HYMBA_ATTN, S, torch.float32, 1024)]
    rows = {}
    for name, heads, L, dtype, window in cases:
        H, KVH, D = heads["H"], heads["KVH"], heads["D"]
        gen = torch.Generator(device=dev).manual_seed(SEED + L + window)
        q, k, v = (_rand(gen, s, dtype, dev) for s in ((B, L, H, D), (B, L, KVH, D),
                                                       (B, L, KVH, D)))
        got = flash_attention(q, k, v, causal=True, window=window)
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= ATTN_TOL[dtype], f"flash_attention {name}: max |err| {err}")
        qi = torch.arange(L, device=dev)[:, None]
        ki = torch.arange(L, device=dev)[None, :]
        mask = (ki <= qi) & ((ki > qi - window) if window else True)
        pairs = int(mask.sum().item())
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def library(qt, kt, vt, mask=mask, window=window):
            if window:
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        lib_err = (library(qt, kt, vt).transpose(1, 2).float() - want.float()).abs().max().item()
        ms = device_ms(lambda *a: flash_attention(*a, causal=True, window=window),
                       lambda: (q, k, v), reps=20)
        call_ms = cuda_ms(lambda *a: flash_attention(*a, causal=True, window=window),
                          lambda: (q, k, v), reps=20)
        plain_ms = device_ms(lambda *a: flash_attention_plain(*a, causal=True, window=window),
                             lambda: (q, k, v), reps=5)
        library_ms = device_ms(library, lambda: (qt, kt, vt), reps=20)
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, got))
        flops = 4 * B * H * D * pairs  # two products over the visible pairs
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        bound_ms, bound_by = _bound(nbytes, flops, rate)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, max_abs_err=err)
        emit(phase="kernel", kernel="flash_attention", case=name, B=B, Sq=L, Sk=L, H=H,
             KVH=KVH, D=D, dtype=str(dtype), window=window, max_abs_err=err, tol=ATTN_TOL[dtype],
             ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
             library_max_abs_err=lib_err, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
             bytes=nbytes, tflops=flops / ms / 1e9)
        del q, k, v, qt, kt, vt, got, want
    return rows


def decode_phase(dev):
    """decode_attention against its plain version at the decode steps'
    shapes (a 544-entry cache, 1 to 544 entries valid, with and without a
    window; llama3.2-3b's heads, and hymba-1.5b's, whose ring of 544 slots
    the path reads with no window), the L2 cache flushed before every timed
    call, as the serving path finds each layer's cache cold."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, decode_attention_plain

    B, Smax = 4, 544
    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    rows = {}
    for tag, heads, dtype in (("", LLAMA, torch.float32), ("", LLAMA, torch.bfloat16),
                              ("hymba_", HYMBA_ATTN, torch.float32)):
        H, KVH, D = heads["H"], heads["KVH"], heads["D"]
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        q, kc, vc = (_rand(gen, s, dtype, dev) for s in ((B, 1, H, D), (B, Smax, KVH, D),
                                                         (B, Smax, KVH, D)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
        for n, window in ((1, 0), (300, 0), (544, 0), (1, 64), (300, 64), (544, 64)):
            name = f"{tag}len{n}_w{window}_{str(dtype).split('.')[-1]}"
            n_t = torch.tensor([n], dtype=torch.int32, device=dev)
            got = decode_attention(q, kc, vc, n_t, window=window)
            want = decode_attention_plain(q, kc, vc, n_t, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(err <= ATTN_TOL[dtype], f"decode_attention {name}: max |err| {err}")
            idx = torch.arange(Smax, device=dev)
            valid = (idx < n) & ((idx > n - 1 - window) if window else True)
            n_valid = int(valid.sum().item())

            def library(qt, kt, vt, valid=valid[None, :]):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid,
                                                      enable_gqa=True)

            lib_err = (library(qt, kt, vt).transpose(1, 2).float()
                       - want.float()).abs().max().item()

            def cold(*args):
                flush.zero_()
                return args

            ms = device_ms(lambda *a: decode_attention(*a, window=window),
                           lambda: cold(q, kc, vc, n_t), reps=50)
            call_ms = cuda_ms(lambda *a: decode_attention(*a, window=window),
                              lambda: cold(q, kc, vc, n_t), reps=50)
            plain_ms = device_ms(lambda *a: decode_attention_plain(*a, window=window),
                                 lambda: cold(q, kc, vc, n_t), reps=10)
            library_ms = device_ms(library, lambda: cold(qt, kt, vt), reps=50)
            elt = q.element_size()
            nbytes = elt * (2 * B * KVH * n_valid * D + 2 * q.numel())  # valid K+V, q, out
            flops = 4 * B * H * D * n_valid
            rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
            bound_ms, bound_by = _bound(nbytes, flops, rate)
            rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms, max_abs_err=err)
            emit(phase="kernel", kernel="decode_attention", case=name, B=B, H=H, KVH=KVH, D=D,
                 Smax=Smax, cache_len=n, window=window, dtype=str(dtype), max_abs_err=err,
                 tol=ATTN_TOL[dtype], ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                 library_ms=library_ms, library_max_abs_err=lib_err, bound_ms=bound_ms,
                 bound_by=bound_by, bytes=nbytes, gb_per_s=nbytes / ms / 1e6)
    del flush
    return rows


# ---------------------------------------------------------------- the SSD scan kernel

MAMBA2 = dict(H=80, P=64, N=128)  # mamba2-2.7b's SSD heads: d_inner 5120 / head_dim 64
HYMBA = dict(H=50, P=64, N=16)  # hymba-1.5b's: d_inner 3200 / 64, d_state 16
SSD_CHUNK = 256  # both models' ssm.chunk


def ssd_inputs(dev, B, S, H, P, N, dtype, decay, seed):
    """The kernel's inputs as the mixer hands them over: x, B and C strided
    slices of one [B, S, H P + 2 N] tensor; dt = softplus(N(0, 1)) (the
    seeded weights' spread); A = -(1 .. 16) over the heads (the models'
    A_log), times ``decay``; D = 1."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed)
    xbc = torch.randn(B, S, H * P + 2 * N, generator=gen, device=dev).to(dtype)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm = xbc[..., H * P:H * P + N].reshape(B, S, 1, N)
    Cm = xbc[..., H * P + N:].reshape(B, S, 1, N)
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    A = -torch.linspace(1.0, 16.0, H, device=dev) * decay
    return x, dt, A, Bm, Cm, torch.ones(H, device=dev)


def ssd_cost(args, y, L):
    """Bytes (each input read once, the output written once), and the
    float32 operations of the cheaper of two ways to compute the function:
    the chunked dual form (C B^T and the decayed scores times xbar over the
    visible pairs of every chunk, and the carried state's two products
    between chunks, not before the first or after the last), or the
    step-by-step recurrence (per step and head, s = a s + xbar B^T is a
    multiply and a multiply-add per state element and y = s C a
    multiply-add: 5 P N).  The decay factors and the D x term (O(L^2 + L P)
    per chunk) are left out of both.  Returns (bytes, flops, both counts)."""
    x, dt, A, Bm, Cm, D = args
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // L
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, A, Bm, Cm, D, y))
    pairs = L * (L + 1) // 2
    chunked = 2 * B * H * (nc * pairs * (N + P) + (nc - 1) * 2 * L * P * N)
    recurrence = 5 * B * H * S * P * N
    return nbytes, min(chunked, recurrence), dict(chunked=chunked, recurrence=recurrence)


def ssd_phase(dev):
    """ssd_scan against its plain version on the card at the prefill's
    shapes (4 prompts of 512 tokens, chunk 256), each element held to
    ``ssd_scan_tolerance`` (the derived bound of two float32 evaluations in
    different orders); plus bfloat16, a ragged chunk (480 -> 240), and a
    weak decay (|dt A| ~ 1e-3 per step, exp over a chunk ~0.8) under which
    the carried state matters: its part of y is measured against the same
    inputs cut into independent chunks."""
    from repro_torch.kernels import ssd_scan, ssd_scan_plain, ssd_scan_tolerance
    from repro_torch.kernels.ssd_scan import pick_chunk

    B = 4
    cases = [("mamba2_f32", MAMBA2, 512, torch.float32, 1.0),
             ("mamba2_bf16", MAMBA2, 512, torch.bfloat16, 1.0),
             ("mamba2_weak_f32", MAMBA2, 512, torch.float32, 1e-3),
             ("hymba_f32", HYMBA, 512, torch.float32, 1.0),
             ("ragged480_f32", MAMBA2, 480, torch.float32, 1.0)]
    rows = {}
    for name, heads, S, dtype, decay in cases:
        args = ssd_inputs(dev, B, S, heads["H"], heads["P"], heads["N"], dtype, decay,
                          SEED + S + heads["N"])
        L = pick_chunk(S, SSD_CHUNK)
        got = ssd_scan(*args, chunk=SSD_CHUNK)
        want = ssd_scan_plain(*args, chunk=L)
        tol = ssd_scan_tolerance(*args, chunk=SSD_CHUNK)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err, use = diff.max().item(), (diff / tol).max().item()
        check(bool((diff <= tol).all()), f"ssd_scan {name}: |kernel - plain| exceeds "
              f"ssd_scan_tolerance ({use:.3g} of it; max |err| {err})")
        # the carried state's part of y: y against the same chunks run alone
        x, dt, A, Bm, Cm, D = args
        nc = S // L
        cut = [t.reshape(B * nc, L, *t.shape[2:]) for t in (x, dt, Bm, Cm)]
        alone = ssd_scan_plain(cut[0], cut[1], A, cut[2], cut[3], D, chunk=L).reshape(want.shape)
        carried = (want.float() - alone.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if decay < 1.0:
            check(carried >= 0.05 * scale and err <= 1e-3 * carried,
                  f"ssd_scan {name}: the carried state is {carried} of max |y| {scale}, "
                  f"the kernel's error {err}")
        nbytes, flops, counts = ssd_cost(args, got, L)
        bound_ms, bound_by = _bound(nbytes, flops, FP32_FLOP_PER_S)
        ms = device_ms(lambda *a: ssd_scan(*a, chunk=SSD_CHUNK), lambda: args, reps=10)
        call_ms = cuda_ms(lambda *a: ssd_scan(*a, chunk=SSD_CHUNK), lambda: args, reps=10)
        plain_ms = device_ms(lambda *a: ssd_scan_plain(*a, chunk=L), lambda: args, reps=3)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None, max_abs_err=err)
        emit(phase="kernel", kernel="ssd_scan", case=name, B=B, S=S, L=L, dtype=str(dtype),
             decay=decay, **heads, max_abs_err=err, tol_use=use, max_abs_y=scale,
             carried_state_max=carried, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
             library_ms=None, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
             flops_chunked=counts["chunked"], flops_recurrence=counts["recurrence"],
             bytes=nbytes, tflops=flops / ms / 1e9)
        del args, got, want, tol, diff, alone, cut, x, dt, A, Bm, Cm, D
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- the RMSNorm kernel

# the served models' norm shapes: llama3.2-3b's prefill (4 x 512 tokens) and
# decode step, mamba2-2.7b's gated norm over d_inner, hymba-1.5b's d_model;
# bfloat16; a ragged row count
RMS_CASES = [("llama_prefill_f32", (2048, 3072), torch.float32),
             ("llama_decode_f32", (4, 3072), torch.float32),
             ("mamba2_d_inner_f32", (2048, 5120), torch.float32),
             ("hymba_f32", (2048, 1600), torch.float32),
             ("llama_prefill_bf16", (2048, 3072), torch.bfloat16),
             ("ragged2047_f32", (2047, 3072), torch.float32)]
RMS_EPS = 1e-5


def rmsnorm_phase(dev):
    """rms_norm against its plain version on the card, per element: within
    1e-5 of max(1, max |out|) of the plain version's float32 value (the sum
    of squares is taken in another order), plus, for bfloat16 output, its
    one rounding (2^-8 relative).  Times of the kernel, the plain version and
    ``torch.nn.functional.rms_norm`` (the yardstick) on the same input.
    Returns the rows and the kernel's launches in this phase."""
    import torch.nn.functional as F

    from repro_torch.kernels import launch_counts, reset_launch_counts, rms_norm, rms_norm_plain

    rows = {}
    reset_launch_counts()
    for name, shape, dtype in RMS_CASES:
        gen = torch.Generator(device=dev).manual_seed(SEED + sum(shape))
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        w = 1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device=dev)
        got = rms_norm(x, w, eps=RMS_EPS)
        want = rms_norm_plain(x.float(), w, eps=RMS_EPS)  # the plain version's float32 value
        plain = rms_norm_plain(x, w, eps=RMS_EPS)
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        scale = max(1.0, want.abs().max().item())
        tol = 1e-5 * scale + (2.0 ** -8 * want.abs() if dtype == torch.bfloat16 else 0.0)
        err = diff.max().item()
        check(got.dtype == dtype and bool((diff <= tol).all()),
              f"rms_norm {name}: max |err| {err} outside the tolerance")
        wl = w.to(dtype)

        def library(x, w=wl, d=shape[-1]):
            return F.rms_norm(x, (d,), weight=w, eps=RMS_EPS)

        lib_err = (library(x).float() - want).abs().max().item()
        ms = device_ms(lambda *a: rms_norm(*a, eps=RMS_EPS), lambda: (x, w), reps=50)
        call_ms = cuda_ms(lambda *a: rms_norm(*a, eps=RMS_EPS), lambda: (x, w), reps=50)
        plain_ms = device_ms(lambda *a: rms_norm_plain(*a, eps=RMS_EPS), lambda: (x, w), reps=20)
        library_ms = device_ms(library, lambda: (x,), reps=50)
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
        flops = 4 * x.numel() + 2 * shape[0]  # square-add, scale, weight; a mean and rsqrt per row
        bound_ms, bound_by = _bound(nbytes, flops, FP32_FLOP_PER_S)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, max_abs_err=err)
        emit(phase="kernel", kernel="rms_norm", case=name, rows=shape[0], D=shape[-1],
             dtype=str(dtype), max_abs_err=err, max_abs_out=scale, plain_max_abs_diff=(
                 (got.float() - plain.float()).abs().max().item()),
             ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
             library_max_abs_err=lib_err, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
             gb_per_s=nbytes / ms / 1e6)
        del x, w, got, want, plain, diff
    launches = launch_counts()["rms_norm"]
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------- phase 6

CAMPAIGN_GOLDEN = REPO / "bench_out" / "campaign.json"
CAMPAIGN_BASELINE = REPO / "benchmarks" / "campaign_baseline.json"
N_EVALUATE = 256


def campaign_phase(dev):
    """The golden campaign's full tier through the port's Session on the
    card, held against the reference package's committed record."""
    from repro_torch.api import Policy, Session
    from repro_torch.core.simulator import simulate
    from repro_torch.eval import build_document, full_spec, run_campaign, validate_campaign
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import trace as obs_trace

    golden = json.loads(CAMPAIGN_GOLDEN.read_text())
    baseline = json.loads(CAMPAIGN_BASELINE.read_text())
    spec = full_spec(backend="cuda")
    session = Session(policy=Policy(backend="cuda"), device=dev)
    tracer = obs_trace.Tracer()
    prev = obs_trace.activate(tracer)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = run_campaign(spec, session, progress=progress)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        obs_trace.activate(prev)
    doc = build_document(result)
    check(validate_campaign(doc) == [], f"campaign document: {validate_campaign(doc)}")
    totals = doc["totals"]
    check(totals["n"] == baseline["n"] == 1296, f"campaign n {totals['n']}")
    check(totals["counts"]["anomaly"] == 0 and result.domination_rate == 1.0,
          f"campaign anomalies {totals['counts']['anomaly']}")
    check(totals["counts"]["heuristic-infeasible"] == 1080
          == baseline["counts"]["heuristic-infeasible"],
          f"heuristic-infeasible {totals['counts']['heuristic-infeasible']}")
    mine, theirs = doc["instances"], golden["instances"]
    check([(r["cell_id"], r["index"], r["content_key"]) for r in mine]
          == [(r["cell_id"], r["index"], r["content_key"]) for r in theirs],
          "content keys differ from the committed campaign")
    events = {}
    for c in result.classifications:
        if c.lp_events:
            events[f"{c.cell_id}#{c.index}"] = c.lp_events
    check(all(set(e) == {"serial-rescue"} for e in events.values()),
          f"events other than a serial rescue: {events}")
    flips, worst = [], 0.0
    for g, w in zip(mine, theirs):
        key = f"{g['cell_id']}#{g['index']}"
        if g["label"] != w["label"]:
            pair = {g["label"], w["label"]}
            check("lp-fallback" in pair and pair - {"lp-fallback"} <= {"lp-wins", "tie"},
                  f"{key}: label {g['label']} against the committed {w['label']}")
            flips.append(dict(instance=key, port=g["label"], committed=w["label"],
                              port_events=events.get(key, [])))
        check((g["ratio"] is None) == (w["ratio"] is None), f"{key}: ratio presence")
        if w["ratio"] is not None:
            worst = max(worst, abs(g["ratio"] - w["ratio"]) / abs(w["ratio"]))
    check(worst <= RTOL, f"campaign ratios differ by {worst}")
    check(counts["simplex_pivot"] > 0 and counts["asap_replay"] > 0,
          f"campaign launches {counts}")

    # where the time went: the eval stages, the engine's buckets, rescues
    # and the autotuner's probes (its first call per tableau shape)
    def spans(name):
        evs = [e for e in tracer.events() if e["name"] == name]
        return len(evs), sum(e["dur_us"] for e in evs) / 1e6

    stage_s = {k: spans(f"eval.{k}")[1] for k in ("generate", "lp", "heuristics", "classify")}
    n_buckets, bucket_s = spans("engine.bucket")
    n_rescues, rescue_s = spans("engine.serial_rescue")
    n_probes, probe_s = spans("engine.autotune")

    # evaluate_gammas through the replay kernel on solved artifacts (cache
    # hits of the campaign's own solves), against the serial simulator
    triples = list(spec.instances())
    sample = [inst for _, _, inst in triples[::len(triples) // N_EVALUATE]][:N_EVALUATE]
    arts = session.solve_bulk(sample)
    check(all(a.ok and a.cache_hit for a in arts), "evaluate_gammas: artifacts from the cache")
    reset_launch_counts()
    got = session.evaluate_gammas(sample, [a.gamma for a in arts])
    torch.cuda.synchronize()
    eval_launches = launch_counts()["asap_replay"]
    want = np.array([simulate(i, a.gamma).makespan for i, a in zip(sample, arts)])
    eval_err = float(np.max(np.abs(got - want) / np.abs(want)))
    check(eval_launches > 0 and eval_err <= RTOL,
          f"evaluate_gammas: {eval_launches} launches, max rel. err {eval_err}")
    emit(phase="campaign", tier=spec.name, n=totals["n"], counts=totals["counts"],
         committed_counts=golden["totals"]["counts"], domination_rate=result.domination_rate,
         anomalies=totals["counts"]["anomaly"], content_keys_equal=True,
         ratio_max_rel_diff=worst, label_flips=flips, served_off_backend=events, wall_s=wall,
         stage_s=stage_s, engine_buckets=n_buckets, engine_bucket_s=bucket_s,
         serial_rescues=n_rescues, serial_rescue_s=rescue_s, autotune_probes=n_probes,
         autotune_probe_s=probe_s, launches=counts, evaluate_gammas_n=len(sample),
         evaluate_gammas_max_rel_err=eval_err, evaluate_gammas_launches=eval_launches)
    return counts


# ---------------------------------------------------------------- phase 5

SERVE_B, SERVE_PROMPT, SERVE_STEPS = 4, 512, 32
SERVE_ARCHS = ("llama3.2-3b", "mamba2-2.7b", "hymba-1.5b")
# kernel path vs plain path (both float32 on the card, the same weights and
# the same matrix products): they differ only in the summation order of
# attention and of the SSD scan (chunked against step by step), ~1e-6
# relative per layer; 1e-3 of max(1, max |value|) leaves that amplified
# through 28-64 random layers well inside, and a wrong mask, head, cache
# slot or decay (an O(1) change) far outside
SERVE_TOL = 1e-3


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


def _device_time_by_group(prof):
    """Device milliseconds of the profiled device operations (kernels,
    copies, fills), grouped: the attention and SSD-scan kernels, the matrix
    products (cuBLAS/CUTLASS) and the rest; and the number of operations."""
    groups = {"flash_attention": 0.0, "decode_attention": 0.0, "ssd_scan": 0.0, "matmul": 0.0,
              "other": 0.0}
    n_ops = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_ops += 1
        name = e.name
        if "flash_attention_kernel" in name:
            key = "flash_attention"
        elif "decode_partial_kernel" in name or "decode_combine_kernel" in name:
            key = "decode_attention"
        elif "ssd_scan_kernel" in name:
            key = "ssd_scan"
        elif any(t in name.lower() for t in ("gemm", "cutlass", "splitkreduce")):
            key = "matmul"
        else:
            key = "other"
        groups[key] += e.device_time / 1e3
    return groups, n_ops


def serve_profile(model, cfg, policy, prompt, n_steps: int, res) -> dict:
    """Where the device time of the serving path goes: one prefill and
    ``n_steps`` decode steps under torch.profiler, their kernels' device
    time by group, the device operations per decode step, and the device's
    busy share against the unprofiled run's wall times (``res``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import prefill
    from repro_torch.runtime import make_serve_step

    S = prompt.shape[1]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        logits, cache, pos = prefill(model, cfg, policy, prompt, max_len=S + n_steps)
        torch.cuda.synchronize()
    pre, pre_ops = _device_time_by_group(prof)
    nxt = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    del logits
    pos_t = torch.tensor([pos], dtype=torch.int32, device=prompt.device)
    step = make_serve_step(cfg, policy)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for i in range(n_steps):
            lg, cache = step(model, cache, nxt, pos_t + i)
            nxt = lg[:, -1:].argmax(dim=-1).to(torch.int32)
        torch.cuda.synchronize()
    dec, dec_ops = _device_time_by_group(prof)
    dec = {k: v / n_steps for k, v in dec.items()}
    attn = cfg.has_attention
    check((pre["flash_attention"] > 0) == attn and (dec["decode_attention"] > 0) == attn
          and (pre["ssd_scan"] > 0) == cfg.has_ssm and dec["matmul"] > 0,
          f"the profiler saw the serving kernels run on the card: {pre}, {dec}")
    step_wall_ms = 1e3 * res.decode_s / len(res.step_logits)
    return dict(prefill_device_ms=pre, prefill_device_total_ms=sum(pre.values()),
                prefill_busy_share=sum(pre.values()) / (1e3 * res.prefill_s),
                prefill_device_ops=pre_ops,
                decode_step_device_ms=dec, decode_step_device_total_ms=sum(dec.values()),
                decode_step_wall_ms=step_wall_ms, decode_step_device_ops=dec_ops / n_steps,
                decode_wall_us_per_device_op=1e3 * step_wall_ms * n_steps / dec_ops,
                decode_busy_share=sum(dec.values()) / step_wall_ms)


def _leaves(cache: dict, prefix: str = "") -> dict:
    """A (nested) cache's tensors by dotted name."""
    out = {}
    for k, v in cache.items():
        out.update(_leaves(v, prefix + k + ".") if isinstance(v, dict) else {prefix + k: v})
    return out


def serve_phase(dev, arch):
    from repro_torch.config import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generate, load_model, prompt_tokens, serve_policy
    from repro_torch.models import prefill
    from repro_torch.runtime import make_serve_step

    cfg = get_arch(arch)
    B, S, N = SERVE_B, SERVE_PROMPT, SERVE_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = load_model(cfg, SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompt = prompt_tokens(cfg, B, S, SEED, dev)
    policy = serve_policy(S)
    check(policy.attention_impl == "cuda", "the serve policy runs the kernels")
    warm = generate(model, cfg, policy, prompt, 2)  # first-call costs of cuBLAS and the kernels
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    res = generate(model, cfg, policy, prompt, N, keep_logits=True)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    progress(f"serve {arch}: prefill {res.prefill_s:.3f} s, {N} steps in {res.decode_s:.3f} s")
    L = cfg.num_layers
    attn = L if cfg.has_attention else 0
    want = {"simplex_pivot": 0, "asap_replay": 0, "flash_attention": attn,
            "decode_attention": attn * N, "ssd_scan": L if cfg.has_ssm else 0, "rms_norm": 0}
    check(counts == want, f"serve {arch} launches {counts}, expected {want}")
    check(tuple(res.prefill_logits.shape) == (B, S, cfg.vocab_size), "prefill logits shape")
    check(tuple(res.tokens.shape) == (B, N), "generated tokens shape")
    finite = bool(torch.isfinite(res.prefill_logits).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in res.step_logits)
    check(finite, f"serve {arch} logits finite")
    tokens = res.tokens.cpu()
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "tokens in the vocabulary")

    # the plain path on the same weights, fed the kernel run's tokens
    naive = serve_policy(S, "naive")
    t1 = time.perf_counter()
    logits, cache, pos = prefill(model, cfg, naive, prompt, max_len=S + N)
    errs = {"prefill_logits": _rel_err(res.prefill_logits, logits)}
    del logits
    step = make_serve_step(cfg, naive)
    nxt = res.prefill_logits[:, -1:].argmax(dim=-1).to(torch.int32)
    steps = []
    for i in range(N):
        lg, cache = step(model, cache, nxt, pos + i)
        steps.append(_rel_err(res.step_logits[i], lg))
        nxt = res.tokens[:, i:i + 1]
    errs["step_logits"] = max(steps)
    got = _leaves(res.cache)
    for name, leaf in _leaves(cache).items():
        errs[f"cache_{name}"] = _rel_err(got[name], leaf)
    torch.cuda.synchronize()
    naive_s = time.perf_counter() - t1
    worst = max(errs.values())
    del cache, got
    torch.cuda.empty_cache()
    breakdown = serve_profile(model, cfg, policy, prompt, 4, res)
    emit(phase="serve", arch=cfg.name, params=n_params, dtype="float32", batch=B,
         prompt_len=S, gen_len=N, init_s=init_s, prefill_s=res.prefill_s,
         prefill_tok_per_s=B * S / res.prefill_s, decode_s=res.decode_s,
         decode_tok_per_s=B * N / res.decode_s, decode_step_ms=1e3 * res.decode_s / N,
         peak_mem_gb=peak / 1e9, launches=counts, sample_tokens=tokens[0, :8].tolist(),
         naive_check_s=naive_s, naive_rel_err=errs, tol=SERVE_TOL, **breakdown)
    check(worst <= SERVE_TOL, f"serve {arch}: kernel vs plain path {errs}")
    del model, res, prompt
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.engine import SolutionCache
    from repro_torch.engine.arena import InstanceArena
    from repro_torch.kernels.build import build_seconds, library

    dev = torch.device("cuda")
    # float32 products in full float32 (the defaults, stated): the serve
    # phase holds the kernel path against the plain path at 1e-3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    library()
    progress("kernels built")
    emit(phase="device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         build_s=build_seconds())

    rng = np.random.default_rng(SEED)
    chain = population(rng, 256, "chain", False)
    star = population(rng, 256, "star", False)
    chain_rr = population(rng, 64, "chain", True)
    star_rr = population(rng, 64, "star", True)
    gold, gold_values = goldens()

    # phase 2: kernels vs plain at the main path's shapes
    piv = {}
    for name, insts in (("chain", chain), ("star", star)):
        (bucket,) = InstanceArena(insts).buckets
        piv[name] = pivot_phase(name, bucket, dev)
    rep = {}
    for name, insts in (("chain", chain), ("star", star), ("chain_ret_rel", chain_rr),
                        ("star_ret_rel", star_rr), ("m1", None)):
        if insts is None:
            from repro_torch.core.instance import random_instance

            insts = [random_instance(rng, m=1, n_loads=5, q=5) for _ in range(256)]
        (bucket,) = InstanceArena(insts).buckets
        rep[name] = replay_phase(name, bucket, dev, rng)

    # phase 3: the main path, launch counts from these calls only
    groups = [("chain", chain, None), ("star", star, None), ("chain_ret_rel", chain_rr, None),
              ("star_ret_rel", star_rr, None), ("goldens", gold, gold_values)]
    cache = SolutionCache()
    launches = bulk_phase(groups, dev, cache, "solve_bulk")
    # phase 4: every instance again, now a cache hit
    bulk_phase(groups, dev, cache, "warm_hits")
    del cache, groups
    torch.cuda.empty_cache()

    # phases 2 (attention and SSD kernels) and 5: the serving paths
    fa = flash_phase(dev)
    da = decode_phase(dev)
    ssd = ssd_phase(dev)
    rms, rms_launches = rmsnorm_phase(dev)
    torch.cuda.empty_cache()
    served = {k: 0 for k in ("flash_attention", "decode_attention", "ssd_scan")}
    for arch in SERVE_ARCHS:
        counts = serve_phase(dev, arch)
        for k in served:
            served[k] += counts[k]

    # phase 6: the planner's front door and the golden campaign
    campaign_phase(dev)

    p, r = piv["chain"][4], rep["chain"]
    f, d, m = fa["causal_f32"], da["len544_w0_float32"], ssd["mamba2_f32"]
    n = rms["llama_prefill_f32"]
    kernels = [
        dict(name="simplex_pivot", route="cuda", source="src/repro_torch/csrc/simplex_pivot.cu",
             replaces="src/repro/kernels/simplex_pivot.py:150", launches=launches["simplex_pivot"],
             max_abs_err=max(piv[t][k]["max_abs_err"] for t in piv for k in piv[t]),
             ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"],
             library_ms=None),
        dict(name="asap_replay", route="cuda", source="src/repro_torch/csrc/asap_replay.cu",
             replaces="src/repro/kernels/asap_replay.py:267", launches=launches["asap_replay"],
             max_abs_err=max(v["max_abs_err"] for v in rep.values()),
             ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=None),
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:106",
             launches=served["flash_attention"],
             max_abs_err=max(v["max_abs_err"] for v in fa.values()),
             ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"], bound_by=f["bound_by"],
             library_ms=f["library_ms"]),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:105",
             launches=served["decode_attention"],
             max_abs_err=max(v["max_abs_err"] for v in da.values()),
             ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["bound_ms"], bound_by=d["bound_by"],
             library_ms=d["library_ms"]),
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:90", launches=served["ssd_scan"],
             max_abs_err=max(v["max_abs_err"] for v in ssd.values()),
             ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
             library_ms=None),
        dict(name="rms_norm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:37", launches=rms_launches,
             launches_from="phase 2 (its checks and timed calls): no path of the port calls "
                           "rms_norm, as no path of the reference calls its kernel",
             max_abs_err=max(v["max_abs_err"] for v in rms.values()),
             ms=n["ms"], plain_ms=n["plain_ms"], bound_ms=n["bound_ms"], bound_by=n["bound_by"],
             library_ms=n["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
