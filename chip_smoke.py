"""Smoke run of the port on one CUDA card: builds the kernels, holds each
against its plain PyTorch version, drives the engine's bulk solve at the
paper's §6 scale, the replanning path and the plan server over the same
populations, the serving paths of llama3.2-3b, mamba2-2.7b, hymba-1.5b,
paligemma-3b, musicgen-medium and deepseek-v2-lite-16b at full width and
depth, the golden campaign's full tier through the planner's front door,
training of llama3.2-3b at full width and depth, alone and down the
paper's chain of stages, the sharded training path on a 1-rank mesh and
the examples, and checks what comes out.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printing one JSON line:

1. ``device``: the card (``nvidia-smi``), torch and CUDA versions, the
   kernels' build time;
2. ``kernel``: each kernel against its plain version on the card, at the
   main paths' shapes (flash attention and the SSD scan bounded by their
   route: bfloat16 on the tensor cores, float32 as split TF32, three TF32
   products each; the SSD scan's three kernels also timed one by one from
   the profiler) (m = 10 processors, 5 loads, q = 5 installments:
   chain tableau 1089 x 1811, star 705 x 1427; attention at llama3.2-3b's,
   hymba-1.5b's and paligemma-3b's heads (head dim 256) with a batch of 4
   prompts of 512 tokens (paligemma's also at 500 tokens and with a window
   of 96; float32 at head dim 256 with its split kernel's share of the
   call) and a 544-entry cache (decode at paligemma's heads in both types,
   with the cluster size and entries a block); the
   SSD scan at mamba2-2.7b's and hymba-1.5b's heads over the same prompts,
   plus a ragged chunk and a weak decay under which the carried state
   matters; RMSNorm at the served models' norm shapes, which no path of the
   port runs yet, plus three other widths), with times from CUDA events;
   the replay kernel also at m = 1, at the chain bucket ladder-padded as
   warm hits pack it (m 16, T 32) and at the campaign's largest bucket
   (64 chain instances with returns, m 8, T 12), each beside the floor of
   its dependent chain (``chain_floor_ms``); ``kernel_shards``: the
   attention kernels' model-axis arguments on one card (flash on llama's
   and paligemma's prefill problems cut into four row blocks at their
   ``q_offset``, decode on a 544-entry cache cut into four shards at their
   ``kv_start`` with ``lse``, merged as the model merges the ranks', cache
   lengths 1 and 544), against the whole call and the plain version, the
   shards' times beside the whole call's.  Shapes no registered config has,
   which the reference's kernels take (ROADMAP B): flash and decode at
   SigLIP-so400m's 16 heads of 72, at head dim 100 (bfloat16 rows of 200
   bytes, which TMA cannot address: the wrapper's padded copy is in the
   call) and at head dim 192 on paligemma-3b's 8 heads / 1 kv head (the
   head-dim-256 kernels), and their shards; the SSD scan at (P, N) = (48,
   80) and (64, 256) at mamba2-2.7b's heads, at a chunk of 4,096 (B 1, S
   8,192, 2 heads of 64, N 128) and at S 4,099 (a prime: chunks of 1, B nc
   = 65,584 past the grid's 65,535), in both types;
3. ``solve_bulk``: 256 chain + 256 star instances, 64 + 64 with returns and
   release dates, and two goldens, through ``repro_torch.engine.solve_bulk``
   on the card; the launch counts are set to 0 just before each call and
   read just after; each bucket's replay stage (``replay_s``) printed;
4. ``warm_hits``: the same population again through the solution cache;
   every hit replays through the replay kernel (``hit_replay_s``);
5. ``serve``, once per model: llama3.2-3b (28 layers, d_model 3072),
   mamba2-2.7b (64 Mamba-2 layers, d_model 2560), hymba-1.5b (32 parallel
   attention + Mamba layers, d_model 1600), paligemma-3b (18 layers, d_model
   2048, 8 heads of 256 on one kv head), musicgen-medium (48 layers, d_model
   1536, 4 codebooks) and deepseek-v2-lite-16b (27 MLA + MoE layers, 64
   experts top-6 and 2 shared, 64.8 GB), float32, seeded weights, through
   ``repro_torch.launch.serve``: 4 prompts of 512 ``make_batch`` positions
   (paligemma: 256 patch embeddings + 256 tokens), 32 greedy decode steps
   (musicgen: per codebook; deepseek: gshard experts at cf 1.25), with the
   launch counts set to 0 just before and read just after (each must be
   exactly the model's: one flash-attention and one SSD-scan launch per
   layer in the prefill, whichever the model has, one decode-attention
   launch per layer and step; none for MLA); then, for every model with a
   kernel, the prefill and the 32 steps again through the plain path
   (``"naive"``: materialised attention, the step-by-step SSD recurrence),
   fed the same tokens, against the kernel path's logits and final cache
   (KV, Mamba state and conv window); then two smoke-size variants at
   shapes no registered config has (``SERVE_VARIANTS``: hymba-1.5b's family
   at d_model 72, 3 SSD heads of 48 and state size 80, 4 attention heads
   on 2 KV heads of 72; llama3.2-3b's at head dim 192), 2 layers, the same
   traffic and checks: the model-level check of the new shapes is at smoke
   size, their kernel rows in phase 2 at full size; deepseek instead against its own
   forward with dense experts (prefill 511, decode token 512) and gshard at
   ample capacity against dense.  paligemma-3b (the largest vocabulary)
   also prefills under ``prefill_last_logit_only``: its [4, 1, V] logits
   against the whole prefill's last row within 1e-5 of max |value|, both
   prefills' peak memory printed.  Each model is freed before the next is
   loaded;
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
   against the serial simulator within 1e-9;
7. ``replan`` (run right after phase 4, over its populations): the simplex
   rung — chain 256 and star 256 each drifted by one seeded
   ``SpeedObserved`` (a worker's speed times 1 +- up to 2%, folded by
   ``repro_torch.runtime.replan``), re-solved cold and warm from phase 3's
   exit bases: objectives and makespans equal within 1e-9, accepted seeds
   with 0 phase-1 pivots, their count, pivot launches and ``simplex_s``
   printed for each mode; then an ``EventStreamReplanner`` over one chain
   instance of the same scale on ``Policy(backend="cuda")``, 24
   ``SpeedObserved`` events plus a ``LoadArrived`` and a ``ProcessorDown``,
   run warm and ``warm=False`` in two sessions: every makespan equal within
   1e-9, four sampled events within 1e-9 of the port's serial solve, warm
   on some coefficient event and on neither structural one, events/s;
8. ``plan_server``: four threads on four streams launch the replay kernel
   50 times each (the count must be exactly 200, every output the plain
   version's within 1e-12); a two-worker ``repro_torch.serve.PlanServer``
   on ``Policy(backend="cuda")`` and a fresh sqlite store takes a burst of
   256 problems (128 chain + 128 star of phase 3's) from 64 HTTP clients
   (``PlanClient``): the same content keys as a direct ``Session`` and
   makespans within 1e-9, ``/healthz`` and ``/metrics`` answering, 32 more
   requests queued when ``close()`` starts all resolved by the drain; a
   second server on the same store serves the burst as hits with the same
   makespans; then ``solve_bulk(chain 256 + star 256, n_shards=2)`` (two
   CUDA streams) against phase 3's results: statuses equal, makespans within
   1e-9; plans/s, p50/p99 latency and the sharded and single walls printed.
   Phases 7 and 8 each set the launch counts to 0 just before each of their
   runs and read them just after; their launches appear in the ``kernels``
   line as ``launches_by_path``;
9. ``train`` (after the serving models and the campaign are freed):
   (a) llama3.2-3b at full width and depth (3.213 G parameters, float32
   weights drawn from the seed on the card, float32 AdamW moments: 51.4 GB
   with the gradients) through ``repro_torch.launch.train``'s own functions:
   4 steps of batch 4 x 512 from ``SyntheticStream``, remat per block,
   chunked attention (chunk 512), lr 5e-5; each step's loss, lr, grad norm
   and synchronised wall, tokens/s, peak memory, one more step under the
   profiler (device ms of the matrix products, attention, the optimizer and
   the rest; the device's busy share), the model FLOPs a step and the
   float32 TFLOP/s reached; the same batch stepped twice lowers the loss;
   microbatches 2 against 1 from the same seed over two steps, within the
   reference's bars (loss 5e-4; parameters rtol 2e-3, atol 2e-4).  (b) The
   same model with 2 layers, batch 2 x 128: one step on the card against
   the same step on the CPU (loss and grad norm 1e-5 relative, each
   gradient leaf 1e-3 of its max |g|), and a checkpoint round trip on the
   card (2 steps, save, 1 more; a fresh state restored retakes that step:
   the restored state exact, the step's loss within 1e-6 relative and its
   parameters within 4 lr, the allowance for an Adam step turned by a
   gradient at rounding level; the measured difference and whether it was
   bitwise are printed).  Every kernel's launch count stays 0 throughout:
   training runs no kernel (none has a backward);
10. ``chain``: the paper's chain.  (a) llama3.2-3b at full width and depth
   trained through ``repro_torch.launch.train``'s chain functions
   (``run_dlt_chain``) down a 4-stage ``LocalChain`` on the card with the
   reference CLI's heterogeneous speeds: 2 loads of 4 x 512 tokens a
   super-step in 2 installments each, chunked attention (chunk 512), lr
   5e-5, 4 super-steps, stage 3 straggling (x2) from step 1 and stage 1
   lost at step 2 (the chain shrinks to 3); each super-step's plan
   (samples per cell and stage), loss, synchronised wall, tokens/s and peak
   memory; the first loss against ``loss_fn`` over the same 8 samples in one
   pass (1e-5 relative); every ``counts`` summing to loads x batch; then one
   more 4-stage super-step and a ``make_train_step`` step on the same 8
   samples back to back, and a profiled super-step (device ms a stage).
   (b) The same model with 2 layers: one chain step's gradients against
   ``make_train_step`` over the same samples (1e-3 of each leaf's max
   |g|); a failure run through ``run_dlt_chain`` whose restore from the
   checkpoint on the card is watched (the state restored exact); a
   ``DistChain`` of 2 processes on the one card (gloo, hops through host
   memory, started with ``spawn``), two steps, against the ``LocalChain``
   (loss 1e-6 relative) with the replicas bitwise equal across the ranks,
   and the hops' and the all-reduce's share of its second step.  (c)
   ``ChainReplanner`` on the ``"cuda"`` backend over phase (a)'s chain: 256
   straggler what-ifs in one bulk call, ``auto_installments(t_max=8)``,
   ``on_failure(1, ...)`` and a warm ``stream()`` of 8 ``SpeedObserved``,
   every makespan within 1e-9 of the port's serial solve, the pivot and
   replay kernels' launches counted (> 0).  Training launches no kernel.
11. ``sharding``: (a) the same model with 2 layers (batch 2 x 128) through
   ``repro_torch.launch.train.run_standard``'s sharded path on a 1-rank NCCL
   ``(data 1, model 1)`` mesh (FSDP2 over the data axis, a process group
   made inside this script), 2 steps against the unsharded
   ``make_train_step`` from the same draws (loss and grad norm within 1e-6
   relative, parameters within C.18's bar), then a sharded checkpoint round
   trip (gathered a leaf at a time, restored into a freshly sharded state:
   exact); no kernel launches.  (b) The three newest examples on the card,
   the launch counts set to 0 just before each and read just after:
   ``examples/torch_quickstart.py`` (its 28 engine solves on ``"cuda"``
   within 1e-9 of the port's serial solve; pivot and replay launches > 0),
   ``examples/torch_serve_multiload.py`` (exactly 6 flash-attention and 48
   decode-attention launches: 2 layers, 3 batches, 8 tokens; its plan
   within 1e-9 of serial) and ``examples/torch_elastic_restart.py`` (the
   restore at step 3, 2 replans, the loss falling).

Then a ``{"train": {...}}`` and a ``{"chain": {...}}`` summary line, the
``{"kernels": [...]}`` line (each kernel with its ``train_launches``,
``chain_train_launches`` and ``sharded_train_launches``, 0, its
``examples_launches``, and the engine kernels' ``launches_by_path`` with
phases 10's and 11's), the card's name and power limit, and
the final ``{"ok": true, ...}`` line.  Any failed check raises, so the
script exits non-zero before that line.  With no card, or without the
repository's ``src/`` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"
sys.path.insert(0, str(SRC))
from repro_torch.launch.mesh import HW  # noqa: E402  (the card's data-sheet constants)

HBM_BYTES_PER_S = HW.HBM_BW
FP64_FLOP_PER_S = HW.PEAK_FLOPS_FP64
FP32_FLOP_PER_S = HW.PEAK_FLOPS_FP32
BF16_FLOP_PER_S = HW.PEAK_FLOPS_BF16
TF32_FLOP_PER_S = HW.PEAK_FLOPS_TF32
SPLIT_TF32_PRODUCTS = 3  # float32 flash attention: hi*hi + hi*lo + lo*hi per product
L2_BYTES = HW.L2_BYTES
SEED = 20261017
GOLDEN_976 = 976.1527780792386  # star/ret0.75/rel0/m2/n3/q4/het1/cc0.02 (HiGHS)
GOLDEN_Q2 = 781.0 / 653.0 * 0.75  # the paper's §3 example at lambda = 3/4, Q = 2
RTOL = 1e-9
REPLAY_TOL = 1e-6  # the engine's certificate: replay <= LP * (1 + tol) + 1e-9
# phase 3 as the dense-update kernel solved it on this card (pivots, serial
# rescues, the simplex's exit statuses): the pivot sequence is the
# function's, so no design of the kernel may move it
PHASE3 = {
    "chain": (235_080, 6, {"optimal": 250, "false_optimal": 1, "iteration_limit": 5}),
    "star": (553_299, 22, {"optimal": 234, "false_optimal": 3, "iteration_limit": 19}),
    "chain_ret_rel": (1_276_031, 62, {"iteration_limit": 60, "unbounded": 2, "optimal": 2}),
    "star_ret_rel": (1_280_000, 64, {"iteration_limit": 64}),
}


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


class HoldOutrun(RuntimeError):
    """device_ms: the calls took longer to enqueue than the card was held
    (a call that waits on the host inside, or a slow host)."""


def device_ms(fn, prepare, reps: int) -> float:
    """Mean device milliseconds of ``fn(*prepare())``: CUDA events around
    each call, all enqueued while a sleep kernel holds the card, so no host
    gap falls between a pair of events (a call of a few microseconds would
    otherwise time the host's launch overhead).  ``prepare`` runs before
    each call's first event, untimed.

    The hold is sized from the host's time to enqueue one call, and the
    timing stands only if the sleep kernel was still running when the last
    event was enqueued (an event recorded just after it is not yet
    complete).  A busy host can enqueue slower than the estimate: the
    timing is then taken again under a longer hold, once."""
    fn(*prepare())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*prepare())
    per_call_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_s = min(max(0.1, 4.0 * reps * per_call_s), 5.0)
    for attempt in range(2):
        torch.cuda._sleep(int(hold_s * 2.0e9))  # cycles; the H100's clock is at most 1.98 GHz
        held = torch.cuda.Event()
        held.record()
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
        still_held = not held.query()
        torch.cuda.synchronize()
        if still_held:
            return sum(a.elapsed_time(b) for a, b in events) / reps
        hold_s = min(max(2.0 * hold_s, 4.0 * enqueue_s), 5.0)
    raise HoldOutrun(f"check failed: device_ms: enqueueing took {enqueue_s:.3f} s, longer "
                     f"than the card was held; the events may include host gaps")


def device_events(fn, reps: int) -> list:
    """The device events (kernels, copies) torch.profiler saw over ``reps``
    calls of ``fn`` (after one warm-up).  A profiling session that recorded
    no device event at all (the profiler's fault, not the kernels': it
    happened once in a dozen sessions on the card) is taken again, twice at
    most; the callers judge what was seen."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            return device
    return []


def busy_ms(fn, reps: int) -> float:
    """Mean milliseconds the device spends on ``fn()``'s kernels and copies,
    summed from torch.profiler's device events: no host gap, and none of
    the device's idle time between them either."""
    return sum(e.device_time for e in device_events(fn, reps)) / 1e3 / reps


def library_ms_of(fn, prepare, reps: int) -> tuple:
    """A library yardstick's mean device milliseconds and the timer that
    took them: ``device_ms``, or, where the call waits on the host inside
    (SDPA's fallback at a head dim its fused kernels refuse outruns the
    hold), ``busy_ms`` of ``fn(*prepare())`` less that of ``prepare()``
    alone (its flush of L2): the call's kernels' device time, without the
    gaps between them that ``device_ms`` counts, so never more than it."""
    try:
        return device_ms(fn, prepare, reps), "device_ms"
    except HoldOutrun:
        ms = busy_ms(lambda: fn(*prepare()), reps) - busy_ms(prepare, reps)
        check(ms > 0, f"library_ms_of: the profiler saw no device time of the call ({ms} ms)")
        return ms, "busy_ms"


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


def rows_changed(T, basis, it, status, kw):
    """Tableau elements one row-skipping round must write: for each lane
    that pivots, C for every row whose pcol' (the entering column, piv - 1
    at the pivot row) is nonzero, R x C when the scaled pivot row is not
    finite.  The plain version's choices, written out; CPU tensors."""
    B, R, C = T.shape
    obj = T[:, -1, :kw["ncols_price"]]
    neg = obj < -1e-9
    bland = torch.where(neg, torch.arange(obj.shape[1]), obj.shape[1]).argmin(dim=1)
    col = torch.where(it < kw["bland_after"], obj.argmin(dim=1), bland)
    pcol = T.gather(2, col[:, None, None].expand(B, R, 1))[:, :, 0]
    pos = pcol[:, :-1] > 1e-9
    ratios = torch.where(pos, T[:, :-1, -1] / torch.where(pos, pcol[:, :-1], 1.0), torch.inf)
    best = ratios.amin(dim=1)
    ties = (ratios - best[:, None]).abs() <= 1e-12
    row = torch.argmin(torch.where(ties, basis.long(), 2**31 - 1), dim=1)
    go = (status == -1) & (it < kw["max_iter"]) & neg.any(dim=1) & torch.isfinite(best)
    total = 0
    for b in go.nonzero()[:, 0].tolist():
        p = pcol[b].clone()
        piv = p[row[b]].item()
        p[row[b]] = piv - 1.0
        finite = bool(torch.isfinite(T[b, row[b]] / piv).all())
        total += C * (int((p != 0).sum()) if finite else R)
    return total


def pivot_compare(name, stack, kw, dev, k, n_lanes, n_launches):
    """``n_launches`` K-pivot launches of the kernel over ``n_lanes`` lanes
    of ``stack`` (the first that still run), against the plain version on the CPU
    from the same stack (one fused multiply-add per element there, the
    function's definition; PyTorch's addcmul on the card rounds the product
    first): basis, it and status equal, T exactly, and each launch writes
    exactly the rows a nonzero pcol' names.  Stops once no compared lane
    runs.  Returns (max |dT|, rounds compared)."""
    from repro_torch.kernels import simplex_pivot, simplex_pivot_plain, updated_elements
    from repro_torch.kernels.simplex_pivot import reset_updated

    running = ((stack[3] == -1) & (stack[2] < kw["max_iter"])).nonzero()[:, 0]
    pick = (running if running.numel() else torch.arange(stack[0].shape[0]))[:n_lanes]
    plain = [x[pick.to(x.device)].cpu() for x in stack]
    ker = [x.to(dev) for x in plain]
    rounds = 0
    for _ in range(n_launches):
        if not bool(((plain[3] == -1) & (plain[2] < kw["max_iter"])).any()):
            break
        want = 0
        for _ in range(k):
            want += rows_changed(*plain, kw)
            simplex_pivot_plain(*plain, k_pivots=1, **kw)
        reset_updated()
        simplex_pivot(*ker, k_pivots=k, **kw)
        got = updated_elements(dev)
        check(got == want, f"simplex_pivot {name} K={k}: wrote {got} elements, the nonzero "
              f"rows of the entering columns hold {want}")
        for a, b, what in zip(ker[1:], plain[1:], ("basis", "it", "status")):
            check(torch.equal(a.cpu(), b), f"simplex_pivot {name} K={k}: {what} differs from plain")
        rounds += k
    err = (ker[0].cpu() - plain[0]).abs().max().item()
    check(err == 0.0, f"simplex_pivot {name} K={k}: |dT| {err} is not 0")
    return err, rounds


MIDSOLVE_ROUNDS = 100  # plain rounds from the set-up to the mid-solve and tail stacks


def pivot_timing(stack, kw, k, cluster=None):
    """Device time of one K-pivot launch over every lane of ``stack`` (a
    fresh copy each call) and of the plain version; the elements the kernel
    wrote and the pivots it made; the bound for those elements and the dense
    bound."""
    from repro_torch.kernels import simplex_pivot, simplex_pivot_plain, updated_elements
    from repro_torch.kernels.simplex_pivot import reset_updated

    B, R, C = stack[0].shape
    reps = 5

    def prepare():
        return [x.clone() for x in stack]

    reset_updated()
    ms = cuda_ms(lambda *a: simplex_pivot(*a, k_pivots=k, cluster=cluster, **kw), prepare, reps)
    elements = updated_elements() // (reps + 1)
    plain_ms = cuda_ms(lambda *a: simplex_pivot_plain(*a, k_pivots=k, **kw), prepare, reps=3)
    after = prepare()
    simplex_pivot(*after, k_pivots=k, cluster=cluster, **kw)
    pivots = int((after[2] - stack[2]).sum().item())
    # the least work for these pivots: read the objective row, the entering
    # and rhs columns and the pivot row, and read + write only the rows whose
    # entering-column entry is nonzero (the rest are unchanged by the rank-1
    # update); one fma per updated element
    nbytes = 8 * (2 * elements + pivots * 2 * (R + C))
    bound_ms, bound_by = _bound(nbytes, 2 * elements, FP64_FLOP_PER_S)
    dense_bound_ms = 1e3 * 2 * R * C * 8 * pivots / HBM_BYTES_PER_S
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                dense_bound_ms=dense_bound_ms, pivots=pivots, touched_rows=elements / C,
                rows_per_pivot=elements / C / max(pivots, 1))


def pivot_phase(name, bucket, dev, lanes=None):
    """The pivot kernel at the bucket's set-up stack and at a mid-solve stack
    (``MIDSOLVE_ROUNDS`` plain rounds on), or, with ``lanes``, only at the
    first ``lanes`` lanes of the mid-solve stack: a tail.  At each: held to
    the plain version on the CPU at K = 1, 4 and 64, and timed at K = 4 with
    its touched rows, both bounds and the cluster size (at the tail also
    with 1 and 16 blocks a lane, and at K = 64)."""
    from repro_torch.kernels import simplex_pivot, simplex_pivot_plain
    from repro_torch.kernels.simplex_pivot import cluster_size

    T0, basis0, kw = setup_stack(bucket, dev)
    B = T0.shape[0] if lanes is None else lanes
    setup = [T0[:B].clone() if lanes else T0, basis0[:B].clone(),
             torch.zeros(B, dtype=torch.int32, device=dev),
             torch.full((B,), -1, dtype=torch.int32, device=dev)]
    del T0
    torch.cuda.empty_cache()
    mid = [x.clone() for x in setup]
    simplex_pivot_plain(*mid, k_pivots=MIDSOLVE_ROUNDS, **kw)
    stacks = [("tail", mid)] if lanes else [("set-up", setup), ("mid-solve", mid)]
    del setup
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for where, stack in stacks:
        err, compared = 0.0, {}
        for k, n_launches in ((1, 32), (4, 16), (64, 4)):
            e, r = pivot_compare(f"{name} {where}", stack, kw, dev, k, min(4, B), n_launches)
            err, compared[k] = max(err, e), r
        row = pivot_timing(stack, kw, 4)
        row.update(max_abs_err=err, cluster=cluster_size(B, sms))
        extra = {}
        if lanes:  # what the cluster buys the tail
            extra = {f"cluster{c}_ms": pivot_timing(stack, kw, 4, cluster=c)["ms"]
                     for c in (1, 16)}
            extra["k64_ms"] = pivot_timing(stack, kw, 64)["ms"]
        rows[where] = row
        emit(phase="kernel", kernel="simplex_pivot", bucket=name, stack=where, B=B,
             R=stack[0].shape[1], C=stack[0].shape[2], k_pivots=4, compared_lanes=min(4, B),
             compared_rounds=compared, library_ms=None, **row, **extra)
    del stacks, mid
    torch.cuda.empty_cache()
    simplex_pivot.clusters = {}
    return rows


def replay_args(bucket, dev, rng):
    """The kernel's inputs for ``bucket`` and random fractions that sum to 1
    over the real processors of each real cell (0 on the ladder's padding)."""
    from repro_torch.convert import to_tensor

    f64 = torch.float64
    g = rng.uniform(0.0, 1.0, size=(bucket.B, bucket.m_real, bucket.T_real))
    g /= g.sum(axis=1, keepdims=True)
    args = [to_tensor(a, dev, f64) for a in (
        bucket.w_cell, bucket.z, bucket.latency, bucket.tau, bucket.vcomm_cell,
        bucket.vcomp_cell, bucket.rel_cell, bucket.cell_valid, bucket.gamma_padded(list(g)))]
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


def chain_steps(m, T, returns):
    """Dependent max + add steps of one instance's replay that keeps the
    reference's association: T cells of m - 1 forward links and a compute
    front, and m - 1 return links with the return phase."""
    return T * (m + (m - 1 if returns else 0))


def chain_floor_ms(steps, dev):
    """Device ms of ``steps`` dependent float64 max + add steps in one
    thread's registers (the replay's own ``mx``), timed as the kernel is."""
    from repro_torch.kernels.build import check, library

    x = torch.zeros(1, dtype=torch.float64, device=dev)

    def probe(x):
        stream = torch.cuda.current_stream().cuda_stream
        check(library().repro_asap_replay_chain_floor(x.data_ptr(), 0.5, 1.0, steps, stream),
              "chain floor probe")

    return device_ms(probe, lambda: (x,), reps=20)


def replay_phase(name, bucket, dev, rng):
    """The replay kernel against its plain version on one bucket: exact
    within 1e-12 relative, its device time (``ms``), the call's time with
    the host's launch cost (``call_ms``), the chain's floor and the bound."""
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
    ms = device_ms(lambda *a: asap_replay(*a[:-1], a[-1], topology=bucket.topology),
                   lambda: (*args, ret), reps=50)
    call_ms = cuda_ms(lambda *a: asap_replay(*a[:-1], a[-1], topology=bucket.topology),
                      lambda: (*args, ret), reps=20)
    plain_ms = cuda_ms(lambda *a: asap_replay_plain(*a[:-1], a[-1], topology=bucket.topology),
                       lambda: (*args, ret), reps=3)
    steps = chain_steps(bucket.m, bucket.T, ret is not None)
    floor_ms = chain_floor_ms(steps, dev)
    nbytes, flops = replay_cost(args, ret, got, bucket.topology == "star")
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP64_FLOP_PER_S)
    row = dict(ms=ms, call_ms=call_ms, chain_floor_ms=floor_ms, plain_ms=plain_ms,
               bound_ms=bound_ms,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP64_FLOP_PER_S
               else "operations", max_abs_err=max(
                   ((g - w).abs().max().item() for g, w in zip(got, want)
                    if w is not None and w.numel()), default=0.0))
    emit(phase="kernel", kernel="asap_replay", bucket=name, B=bucket.B, m=bucket.m, T=bucket.T,
         m_real=bucket.m_real, T_real=bucket.T_real, topology=bucket.topology,
         returns=ret is not None, max_rel_err=err, max_abs_err=row["max_abs_err"], ms=ms,
         call_ms=call_ms, chain_steps=steps, chain_floor_ms=floor_ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=row["bound_by"], library_ms=None)
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


def tableau_shapes(insts):
    """(R, C) of the simplex tableaux of each bucket ``insts`` packs into."""
    from repro_torch.engine.arena import InstanceArena
    from repro_torch.engine.batched_lp import build_lp_bucket

    shapes = []
    for b in InstanceArena(insts).buckets:
        lp = build_lp_bucket(b)
        m_ub, n = lp.A_ub.shape[1], lp.c.shape[0]
        shapes.append((m_ub + lp.A_eq.shape[1] + 1, n + m_ub + 2))
    return shapes


def bulk_phase(groups, dev, cache, phase):
    from repro_torch.core.solver import solve
    from repro_torch.engine import autotune, solve_bulk
    from repro_torch.kernels import (launch_counts, reset_launch_counts, simplex_pivot,
                                     updated_elements)

    totals = {"simplex_pivot": 0, "asap_replay": 0}
    results = {}
    for name, insts, golden in groups:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve_bulk(insts, cache=cache, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        clusters = dict(sorted(simplex_pivot.clusters.items()))
        elements = updated_elements(dev)
        results[name] = (res, wall)
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
        # the pivot kernel's work: the rows it updated (its device counter),
        # the least time for those bytes against simplex_s, its schedule
        shapes = tableau_shapes(insts)
        kernel = dict(k_schedule={f"{R}x{C}": autotune._CACHE.get((R, C, "cuda"))
                                  for R, C in shapes}, clusters=clusters)
        if phase == "solve_bulk" and len(shapes) == 1:
            R, C = shapes[0]
            nbytes = 16 * elements + 16 * pivots * (R + C)
            kernel.update(rows_updated=elements / C, rows_per_pivot=elements / C / max(pivots, 1),
                          update_bound_s=nbytes / HBM_BYTES_PER_S,
                          dense_bound_s=16 * R * C * pivots / HBM_BYTES_PER_S)
        # the replay stage (the host's packing and copies, the kernel,
        # building the schedules): its own key, beside the kernel's ms
        replay = {("hit_replay_s" if phase == "warm_hits" else "replay_s"): stages["replay_s"]}
        progress(f"{phase} {name}: {json.dumps(replay)}")
        emit(phase=phase, bucket=name, B=len(insts), statuses=statuses, pivots=pivots,
             rescues=rescues, hits=hits, wall_s=wall, **replay, stages=stages, launches=counts,
             pivot_kernel=kernel, serial_max_rel_diff=worst if phase == "solve_bulk" else None,
             sample_rescued=sum("serial_rescue" in res[i].telemetry for i in sample))
        if phase == "solve_bulk":
            check(worst <= RTOL, f"{name}: serial solve differs by {worst}")
            if name in PHASE3:
                check((pivots, rescues, statuses) == PHASE3[name],
                      f"{name}: pivots, rescues, statuses {(pivots, rescues, statuses)}, "
                      f"expected {PHASE3[name]}")
    return totals, results


# ---------------------------------------------------------------- phases 7, 8

REPLAN_DRIFT = 0.02  # phase 7: a worker's speed moves by up to 2% an event
N_SPEED_EVENTS = 24  # phase 7's event stream: speed observations, plus 2 structural events
BURST_CLIENTS = 64  # phase 8: HTTP requests in flight at once
REPLAY_THREADS, REPLAY_PER_THREAD = 4, 50  # phase 8: launch counts under threads


def counted(fn, totals=None):
    """``fn()`` with the launch counts set to 0 just before and read just
    after (added into ``totals`` when given); returns (out, wall s, counts)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if totals is not None:
        for k in totals:
            totals[k] += counts[k]
    return out, wall, {k: counts[k] for k in ("simplex_pivot", "asap_replay")}


def bucket_stats(res) -> dict:
    """Pivots, rescues, warm-accepted lanes and the summed stage seconds of
    each bucket (results of one bucket share its stages) of a solve."""
    stages, seen = {}, set()
    for r in res:
        key = json.dumps(r.telemetry["bucket"], sort_keys=True)
        if key not in seen:
            seen.add(key)
            for k in ("simplex_s", "replay_s", "lp_build_s"):
                stages[k] = stages.get(k, 0.0) + r.telemetry["stages"].get(k, 0.0)
    lp = [r.telemetry["lp"] for r in res]
    return dict(stages, pivots=sum(x["pivots_phase1"] + x["pivots_phase2"] for x in lp),
                pivots_phase1=sum(x["pivots_phase1"] for x in lp),
                warm=sum(bool(x.get("warm")) for x in lp),
                rescues=sum("serial_rescue" in r.telemetry for r in res))


def rescued(res) -> bool:
    return "serial_rescue" in (res.telemetry or {})


def plan_diff(a, b, inst) -> tuple:
    """Relative difference of two solves of ``inst`` (results or artifacts):
    of their makespans and LP objectives when both or neither were rescued
    serially; otherwise of the engine-solved one's makespan against the
    tight serial solve (``serial_makespan``), since a rescue is HiGHS at its
    default tolerances, which can sit ~1e-8 off the optimum at this size.
    Returns (difference, whether only one side was rescued)."""
    if rescued(a) == rescued(b):
        return max(abs(a.makespan - b.makespan) / b.makespan,
                   abs(a.lp_makespan - b.lp_makespan) / abs(b.lp_makespan)), False
    engine = b if rescued(a) else a
    want = serial_makespan(inst)
    return abs(engine.makespan - want) / want, True


def warm_rejects() -> dict:
    """The warm entry's rejected seeds so far, by reason (the metrics
    registry's ``repro_simplex_warm_rejects_total``)."""
    from repro_torch.obs import metrics as obs_metrics

    reg = obs_metrics.get_registry()
    return {r: reg.value("repro_simplex_warm_rejects_total", reason=r) for r in (
        "ids", "singular", "not_finite", "residual", "not_a_vertex", "not_optimal")}


def drifted(rng, insts):
    """Each instance after one seeded ``SpeedObserved``: one worker's speed
    times (1 +- up to 2%), folded by the port's replanner, same q."""
    from repro_torch.api import Problem
    from repro_torch.runtime.replan import SpeedObserved, _fold

    out = []
    for inst in insts:
        p = Problem.from_instance(inst)
        i = int(rng.integers(p.m))
        ev = SpeedObserved(i, p.w[i] * (1.0 + rng.uniform(-REPLAN_DRIFT, REPLAN_DRIFT)))
        out.append(_fold(p, ev).to_instance(inst.q))
    return out


def event_stream(rng, problem):
    """24 distinct ``SpeedObserved`` events (a worker's speed times 1 +- 0.5 to
    2% of its current value), with a ``LoadArrived`` before the 13th and a
    ``ProcessorDown`` before the 19th (event indices 12 and 19), each built
    against the problem the events before it fold into."""
    from repro_torch.runtime.replan import LoadArrived, ProcessorDown, SpeedObserved, _fold

    events, p = [], problem
    for k in range(N_SPEED_EVENTS):
        if k == 12:
            events.append(LoadArrived(v_comm=float(np.mean(p.v_comm)),
                                      v_comp=float(np.mean(p.v_comp))))
            p = _fold(p, events[-1])
        elif k == 18:
            events.append(ProcessorDown(index=p.m // 2))
            p = _fold(p, events[-1])
        i = int(rng.integers(p.m))
        scale = 1.0 + rng.choice([-1.0, 1.0]) * rng.uniform(0.005, REPLAN_DRIFT)
        events.append(SpeedObserved(i, p.w[i] * scale))
        p = _fold(p, events[-1])
    return events


def replan_phase(dev, chain, star, phase3):
    """Phase 7: the replanning path on the card.  (a) the simplex rung: phase
    3's chain 256 and star 256 drifted by one seeded ``SpeedObserved`` each,
    re-solved cold and warm (seeded with phase 3's exit bases); (b) an
    ``EventStreamReplanner`` over one chain instance of the same scale,
    warm and ``warm=False``.  Returns the pivot and replay launches."""
    from repro_torch.api import Policy, Problem, Session
    from repro_torch.core.solver import solve
    from repro_torch.engine import solve_bulk
    from repro_torch.runtime.replan import EventStreamReplanner, SpeedObserved

    rng = np.random.default_rng(SEED + 7)
    totals = {"simplex_pivot": 0, "asap_replay": 0}
    for name, insts in (("chain", chain), ("star", star)):
        bases = [r.telemetry["lp"].get("final_basis") for r in phase3[name][0]]
        moved = drifted(rng, insts)
        cold, cold_wall, cold_counts = counted(lambda: solve_bulk(moved, device=dev), totals)
        before = warm_rejects()
        warm, warm_wall, warm_counts = counted(
            lambda: solve_bulk(moved, device=dev, warm_starts=bases), totals)
        rejects = {k: v - before[k] for k, v in warm_rejects().items() if v > before[k]}
        worst, mixed = 0.0, 0
        for i, (c, w) in enumerate(zip(cold, warm)):
            check(c.ok and w.ok, f"replan {name}[{i}]: statuses {c.status}, {w.status}")
            diff, was_mixed = plan_diff(w, c, moved[i])
            worst, mixed = max(worst, diff), mixed + was_mixed
            if w.telemetry["lp"].get("warm"):
                check(w.telemetry["lp"]["pivots_phase1"] == 0,
                      f"replan {name}[{i}]: an accepted seed made phase-1 pivots")
        cs, ws = bucket_stats(cold), bucket_stats(warm)
        progress(f"replan {name}: cold {cold_wall:.2f} s, warm {warm_wall:.2f} s, "
                 f"{ws['warm']} of {len(insts)} seeds accepted")
        emit(phase="replan", rung="simplex", bucket=name, B=len(insts), drift=REPLAN_DRIFT,
             accepted=ws["warm"], rejected_by=rejects, max_rel_diff=worst,
             rescued_on_one_side=mixed,
             cold=dict(cs, wall_s=cold_wall, launches=cold_counts,
                       solves_per_s=len(insts) / cold_wall),
             warm=dict(ws, wall_s=warm_wall, launches=warm_counts,
                       solves_per_s=len(insts) / warm_wall))
        check(worst <= RTOL, f"replan {name}: warm differs from cold by {worst}")

    # (b) the event stream, warm and cold, one session each
    base = Problem.from_instance(chain[0])
    policy = Policy(installments=int(chain[0].q[0]), backend="cuda")
    events = event_stream(rng, base)
    runs = {}
    for warm in (True, False):
        def stream():
            rp = EventStreamReplanner(Session(policy=policy), base, warm=warm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arts = [rp.apply(ev) for ev in events]
            torch.cuda.synchronize()
            return arts, time.perf_counter() - t0

        (arts, ev_s), _, counts = counted(stream, totals)
        runs[warm] = arts
        n_warm = sum(a.events[-1]["warm"] for a in arts)
        emit(phase="replan", rung="event_stream", warm=warm, events=len(events),
             events_per_s=len(events) / ev_s, stream_s=ev_s, warm_served=n_warm,
             cache_hits=sum(a.cache_hit for a in arts), launches=counts,
             pivots=sum((a.events[-1]["pivots_phase1"] or 0) + (a.events[-1]["pivots_phase2"] or 0)
                        for a in arts))
        progress(f"replan stream warm={warm}: {len(events) / ev_s:.2f} events/s")
    worst = 0.0
    for k, (a, b) in enumerate(zip(runs[True], runs[False])):
        check(a.ok and b.ok, f"replan stream event {k}: statuses {a.status}, {b.status}")
        worst = max(worst, plan_diff(a, b, a.instance())[0])
    check(worst <= RTOL, f"replan stream: warm and cold differ by {worst}")
    coefficient = [a.events[-1]["warm"] for a, ev in zip(runs[True], events)
                   if isinstance(ev, SpeedObserved)]
    structural = [a.events[-1]["warm"] for a, ev in zip(runs[True], events)
                  if not isinstance(ev, SpeedObserved)]
    check(any(coefficient), "replan stream: no coefficient event was served warm")
    check(len(structural) == 2 and not any(structural),
          f"replan stream: structural events served warm {structural}")
    sampled = [0, 12, 19, len(events) - 1]  # a speed, both structural, the last
    serial = []
    for k in sampled:
        art = runs[True][k]
        inst = art.instance()
        want = (solve(inst).makespan if "serial_rescue" in (art.telemetry or {})
                else serial_makespan(inst))
        serial.append(abs(art.makespan - want) / want)
    emit(phase="replan", rung="event_stream_check", max_rel_diff_warm_cold=worst,
         sampled=sampled, serial_max_rel_diff=max(serial),
         warm_on_coefficient=sum(coefficient), warm_on_structural=sum(structural))
    check(max(serial) <= RTOL, f"replan stream: serial solve differs by {serial}")
    return totals


def thread_launch_check(dev, insts):
    """Four threads, each on a stream of its own, launch the replay kernel
    50 times on one bucket: the count must come to exactly 200 and every
    output equal the plain version within 1e-12 relative.  These launches
    check the bookkeeping; they count on no path."""
    import threading

    from repro_torch.engine.arena import InstanceArena
    from repro_torch.kernels import asap_replay, asap_replay_plain, launch_counts, \
        reset_launch_counts

    (bucket,) = InstanceArena(insts).buckets
    args, ret = replay_args(bucket, dev, np.random.default_rng(SEED + 8))
    want = asap_replay_plain(*args, ret, topology=bucket.topology)
    errs, failures = [None] * REPLAY_THREADS, []
    barrier = threading.Barrier(REPLAY_THREADS)
    torch.cuda.synchronize()
    reset_launch_counts()

    def worker(i):
        try:
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.default_stream(dev))
            with torch.cuda.stream(stream):
                barrier.wait()
                err = torch.zeros((), dtype=torch.float64, device=dev)
                for _ in range(REPLAY_PER_THREAD):
                    got = asap_replay(*args, ret, topology=bucket.topology)
                    for g, w in zip(got, want):
                        if w is not None and w.numel():
                            err = torch.maximum(err, (g - w).abs().max()
                                                / w.abs().max().clamp_min(1e-300))
                errs[i] = float(err)  # waits for this stream
        except BaseException as e:
            failures.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(REPLAY_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    n = launch_counts()["asap_replay"]
    reset_launch_counts()
    check(n == REPLAY_THREADS * REPLAY_PER_THREAD,
          f"replay launches from {REPLAY_THREADS} threads: {n}, "
          f"expected {REPLAY_THREADS * REPLAY_PER_THREAD}")
    check(max(errs) <= 1e-12, f"replay under threads: relative error {max(errs)}")
    return dict(threads=REPLAY_THREADS, per_thread=REPLAY_PER_THREAD, launches=n,
                max_rel_err=max(errs))


def plan_server_phase(dev, chain, star, phase3):
    """Phase 8: the plan server on the card.  A 256-problem HTTP burst (128
    chain + 128 star from phase 3's populations) through a two-worker
    ``PlanServer`` on a fresh store, held against a direct ``Session``; a
    drain with work queued; a second server on the same store serving the
    burst as hits; then the sharded bulk solve of chain 256 + star 256 on
    two streams against phase 3's single path.  Returns the pivot and
    replay launches of the server, restart and sharded runs."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.api import Policy, Problem, Session
    from repro_torch.engine import solve_bulk
    from repro_torch.serve import PlanClient, PlanServer

    threads = thread_launch_check(dev, chain)
    totals = {"simplex_pivot": 0, "asap_replay": 0}
    policy = Policy(installments=int(chain[0].q[0]), backend="cuda")
    problems = [Problem.from_instance(i) for i in chain[:128] + star[:128]]
    queued = [Problem.from_instance(i) for i in chain[128:144] + star[128:144]]

    def serve_burst(store, drain_with=()):
        server = PlanServer(workers=2, store=store, policy=policy, port=0,
                            default_deadline_s=900.0)
        client = PlanClient(f"http://localhost:{server.port}", timeout_s=900.0)

        def one(p):
            t = time.perf_counter()
            art = client.plan(p)
            return art, time.perf_counter() - t

        t0 = time.perf_counter()
        with ThreadPoolExecutor(BURST_CLIENTS) as ex:
            out = list(ex.map(one, problems))
        wall = time.perf_counter() - t0
        health, metrics = client.healthz(), client.metrics_text()
        futures = [server.submit(p) for p in drain_with]  # queued when close() starts
        server.close()
        drained = [f.result(timeout=0) for f in futures]  # close() returned: all resolved
        check(server.healthz()["status"] == "draining", "server: not draining after close")
        return dict(arts=[a for a, _ in out], lat=[dt for _, dt in out], wall=wall,
                    health=health, metrics=metrics, drained=drained,
                    stats=server.cache.stats())

    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "plans.sqlite")
        first, _, first_counts = counted(lambda: serve_burst(store, queued), totals)
        direct, direct_wall, _ = counted(lambda: Session(policy=policy).solve_bulk(problems))
        second, _, second_counts = counted(lambda: serve_burst(store), totals)
    worst = 0.0
    for k, (a, d, h) in enumerate(zip(first["arts"], direct, second["arts"])):
        check(a.ok and d.ok and h.ok, f"served[{k}]: {a.status}, {d.status}, {h.status}")
        check(a.problem.key(a.q) == d.problem.key(d.q) == h.problem.key(h.q),
              f"served[{k}]: content keys differ")
        check(h.cache_hit, f"served[{k}]: the restarted server re-solved it")
        for x in (a, h):
            worst = max(worst, abs(x.makespan - d.makespan) / d.makespan)
    check(all(a.ok for a in first["drained"]), "drain: a queued request failed")
    check(first["health"]["status"] == "ok" and "repro_serve_requests_total" in first["metrics"],
          "healthz or metrics did not answer")
    check(worst <= RTOL, f"served vs direct: {worst}")
    lat = np.sort(np.asarray(first["lat"]))
    hit_lat = np.sort(np.asarray(second["lat"]))

    # the sharded bulk solve: chain 256 + star 256 on two streams
    sharded, sh_wall, sh_counts = counted(
        lambda: solve_bulk(chain + star, device=dev, n_shards=2), totals)
    single = phase3["chain"][0] + phase3["star"][0]
    single_wall = phase3["chain"][1] + phase3["star"][1]
    sh_worst = 0.0
    for k, (a, b) in enumerate(zip(sharded, single)):
        check(a.status == b.status, f"sharded[{k}]: status {a.status}, single {b.status}")
        sh_worst = max(sh_worst, abs(a.makespan - b.makespan) / b.makespan)
    check(sh_worst <= RTOL, f"sharded vs single: {sh_worst}")
    progress(f"plan server: {len(problems) / first['wall']:.1f} plans/s, sharded "
             f"{sh_wall:.2f} s against single {single_wall:.2f} s")
    emit(phase="plan_server", n=len(problems), workers=2, clients=BURST_CLIENTS,
         launch_counts_under_threads=threads,
         served=dict(wall_s=first["wall"], plans_per_s=len(problems) / first["wall"],
                     p50_ms=1e3 * float(np.percentile(lat, 50)),
                     p99_ms=1e3 * float(np.percentile(lat, 99)), launches=first_counts,
                     drained=len(first["drained"]), cache=first["stats"]),
         direct_wall_s=direct_wall, max_rel_diff_served_direct=worst,
         restart=dict(wall_s=second["wall"], plans_per_s=len(problems) / second["wall"],
                      p50_ms=1e3 * float(np.percentile(hit_lat, 50)),
                      p99_ms=1e3 * float(np.percentile(hit_lat, 99)),
                      hits=sum(a.cache_hit for a in second["arts"]),
                      store_hits=second["stats"]["store_hits"], launches=second_counts),
         sharded=dict(shards=2, wall_s=sh_wall, single_wall_s=single_wall,
                      max_rel_diff=sh_worst, launches=sh_counts,
                      pivots=bucket_stats(sharded)["pivots"],
                      single_pivots=bucket_stats(single)["pivots"],
                      rescues=bucket_stats(sharded)["rescues"],
                      single_rescues=bucket_stats(single)["rescues"]))
    return totals


# ---------------------------------------------------------------- attention kernels

LLAMA = dict(H=24, KVH=8, D=128)  # llama3.2-3b's attention heads
HYMBA_ATTN = dict(H=25, KVH=5, D=64)  # hymba-1.5b's (window 1024)
PALIGEMMA = dict(H=8, KVH=1, D=256)  # paligemma-3b's: head dim 256, one kv head
# kimi-k2-1t-a32b's: head dim 112, which the kernels run at width 128 (columns
# past 112 read as zeros), 8 query heads a kv head
KIMI = dict(H=64, KVH=8, D=112)
# head dims no registered config has, which the reference's kernels take:
# SigLIP-so400m's 16 heads of 72 (the encoder paligemma-3b's stub stands
# for; width 128), 100 (width 128; bfloat16 rows of 200 bytes, a layout TMA
# cannot address: flash copies q, k and v into padded rows, decode reads
# the cache in 8-byte pieces), 192 at paligemma-3b's 8 heads on one kv head
# (the head-dim-256 kernels)
SIGLIP = dict(H=16, KVH=16, D=72)
D100 = dict(H=8, KVH=2, D=100)
D192 = dict(H=8, KVH=1, D=192)
# kernel vs plain on the card: float32 computes the same function with sums
# in another order (~1e-6 at these lengths); bfloat16 rounds inputs and
# outputs to 8 bits of mantissa, both sides computing in float32 in between
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _bound(nbytes, flops, flop_rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# float32 at head dim 256 is two kernels a call: K and V split once, then
# the attention
FLASH_D256_KERNELS = ("flash_attention_split_kv_kernel", "flash_attention_d256_kernel")


def flash_phase(dev):
    """flash_attention against its plain version at the prefills' shapes
    (llama3.2-3b's heads, hymba-1.5b's with its 1024 window, paligemma-3b's
    at head dim 256, kimi-k2-1t-a32b's at head dim 112), plus bfloat16, a
    window and a length no tile divides (at llama's heads, paligemma's and
    kimi's); and, causal in both types, head dims no registered config has
    (SigLIP-so400m's 72, 100, 192); times of the kernel (the whole
    call: float32 above head dim 128 also reports its split kernel's share;
    bfloat16 at head dim 100 includes the wrapper's padded copies),
    the plain version and PyTorch's SDPA (the yardstick)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, flash_attention_plain

    B, S = 4, 512
    cases = [("causal_f32", LLAMA, S, torch.float32, 0),
             ("causal_bf16", LLAMA, S, torch.bfloat16, 0),
             ("window96_f32", LLAMA, S, torch.float32, 96),
             ("ragged500_f32", LLAMA, 500, torch.float32, 0),
             ("hymba_window1024_f32", HYMBA_ATTN, S, torch.float32, 1024),
             ("hymba_window1024_bf16", HYMBA_ATTN, S, torch.bfloat16, 1024),
             ("paligemma_causal_f32", PALIGEMMA, S, torch.float32, 0),
             ("paligemma_causal_bf16", PALIGEMMA, S, torch.bfloat16, 0),
             ("paligemma_ragged500_f32", PALIGEMMA, 500, torch.float32, 0),
             ("paligemma_window96_f32", PALIGEMMA, S, torch.float32, 96),
             ("paligemma_window96_bf16", PALIGEMMA, S, torch.bfloat16, 96),
             ("kimi_causal_f32", KIMI, S, torch.float32, 0),
             ("kimi_causal_bf16", KIMI, S, torch.bfloat16, 0),
             ("kimi_ragged500_f32", KIMI, 500, torch.float32, 0),
             ("kimi_window96_f32", KIMI, S, torch.float32, 96),
             ("siglip_causal_f32", SIGLIP, S, torch.float32, 0),
             ("siglip_causal_bf16", SIGLIP, S, torch.bfloat16, 0),
             ("d100_causal_f32", D100, S, torch.float32, 0),
             ("d100_causal_bf16", D100, S, torch.bfloat16, 0),
             ("d192_causal_f32", D192, S, torch.float32, 0),
             ("d192_causal_bf16", D192, S, torch.bfloat16, 0)]
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
        library_ms, library_timer = library_ms_of(library, lambda: (qt, kt, vt), reps=20)
        split = {}
        if D > 128 and dtype == torch.float32:
            stage = kernel_stage_ms(lambda: flash_attention(q, k, v, causal=True, window=window),
                                    reps=20, kernels=FLASH_D256_KERNELS)
            check(all(t > 0 for t in stage.values()),
                  f"flash_attention {name}: the profiler saw both kernels run: {stage}")
            split = dict(stage_ms=stage, split_share=stage[FLASH_D256_KERNELS[0]]
                         / sum(stage.values()))
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, got))
        flops = 4 * B * H * D * pairs  # two products over the visible pairs
        # the bound follows the kernel's route: bfloat16 on the tensor cores;
        # float32 as split TF32 on wgmma, three tensor-core products per
        # product (the CUDA cores' float32 figure is kept beside it)
        if dtype == torch.bfloat16:
            bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOP_PER_S)
            route = "bf16 tensor cores"
        else:
            bound_ms, bound_by = _bound(nbytes, SPLIT_TF32_PRODUCTS * flops, TF32_FLOP_PER_S)
            route = "split TF32: 3 TF32 tensor-core products per product"
        bound_cuda_cores_ms = _bound(nbytes, flops, FP32_FLOP_PER_S)[0]
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, library_timer=library_timer, max_abs_err=err,
                          **split)
        emit(phase="kernel", kernel="flash_attention", case=name, B=B, Sq=L, Sk=L, H=H,
             KVH=KVH, D=D, dtype=str(dtype), window=window, max_abs_err=err, tol=ATTN_TOL[dtype],
             ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
             library_max_abs_err=lib_err, library_timer=library_timer, bound_ms=bound_ms,
             bound_by=bound_by, bound_route=route, bound_cuda_cores_ms=bound_cuda_cores_ms, flops=flops,
             bytes=nbytes, tflops=flops / ms / 1e9, **split)
        del q, k, v, qt, kt, vt, got, want
    return rows


def decode_phase(dev):
    """decode_attention against its plain version at the decode steps'
    shapes (a 544-entry cache, 1 to 544 entries valid, with and without a
    window; llama3.2-3b's heads, hymba-1.5b's, whose ring of 544 slots the
    path reads with no window, and paligemma-3b's at head dim 256, which
    run the cluster kernel, in both types; kimi-k2-1t-a32b's at head dim
    112, and SigLIP-so400m's 72, 100 and 192, 1 and 544 entries without a
    window, in both types), the L2 cache flushed before
    every timed call, as the serving path finds each layer's cache cold.
    Head dims up to 128 report the split the wrapper picks; those above
    the cluster's blocks and the entries its largest share holds."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, decode_attention_plain
    from repro_torch.kernels.decode_attention import (decode_cluster_on, decode_shares,
                                                      decode_split)

    B, Smax = 4, 544
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    rows = {}
    every = ((1, 0), (300, 0), (544, 0), (1, 64), (300, 64), (544, 64))
    for tag, heads, dtype, lengths in (
            ("", LLAMA, torch.float32, every), ("", LLAMA, torch.bfloat16, every),
            ("hymba_", HYMBA_ATTN, torch.float32, every),
            ("paligemma_", PALIGEMMA, torch.float32, every),
            ("paligemma_", PALIGEMMA, torch.bfloat16, every),
            ("kimi_", KIMI, torch.float32, ((1, 0), (544, 0))),
            ("kimi_", KIMI, torch.bfloat16, ((1, 0), (544, 0))),
            ("siglip_", SIGLIP, torch.float32, ((1, 0), (544, 0))),
            ("siglip_", SIGLIP, torch.bfloat16, ((1, 0), (544, 0))),
            ("d100_", D100, torch.float32, ((1, 0), (544, 0))),
            ("d100_", D100, torch.bfloat16, ((1, 0), (544, 0))),
            ("d192_", D192, torch.float32, ((1, 0), (544, 0))),
            ("d192_", D192, torch.bfloat16, ((1, 0), (544, 0)))):
        H, KVH, D = heads["H"], heads["KVH"], heads["D"]
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        q, kc, vc = (_rand(gen, s, dtype, dev) for s in ((B, 1, H, D), (B, Smax, KVH, D),
                                                         (B, Smax, KVH, D)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
        for n, window in lengths:
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
            library_ms, library_timer = library_ms_of(library, lambda: cold(qt, kt, vt),
                                                      reps=50)
            elt = q.element_size()
            nbytes = elt * (2 * B * KVH * n_valid * D + 2 * q.numel())  # valid K+V, q, out
            flops = 4 * B * H * D * n_valid
            rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
            bound_ms, bound_by = _bound(nbytes, flops, rate)
            rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms, library_timer=library_timer,
                              max_abs_err=err)
            if D > 128:
                cluster = decode_cluster_on(dev, B, KVH, H // KVH, Smax)
                grid = dict(cluster=cluster, entries_a_block=max(
                    e - a for a, e in decode_shares(n, Smax, window, cluster)))
            else:
                grid = dict(split=decode_split(B, KVH, H // KVH, Smax, n_sms))
            rows[name].update(grid)
            emit(phase="kernel", kernel="decode_attention", case=name, B=B, H=H, KVH=KVH, D=D,
                 Smax=Smax, **grid, cache_len=n, window=window, dtype=str(dtype), max_abs_err=err,
                 tol=ATTN_TOL[dtype], ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                 library_ms=library_ms, library_max_abs_err=lib_err,
                 library_timer=library_timer, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                 gb_per_s=nbytes / ms / 1e6)
    del flush
    return rows


SHARDS = 4  # the model axis the shard checks cut the problems for (four cards)


def flash_shard_phase(dev):
    """flash_attention on a model axis's rows, on one card: the prefill
    problems of llama3.2-3b's, paligemma-3b's and kimi-k2-1t-a32b's heads,
    SigLIP-so400m's (head dim 72) and head dim 192's (4 x 512) cut into
    four row blocks, each run with its ``q_offset``
    (0/128/256/384) against the whole K and V, as each rank of a (1, 4)
    mesh runs its rows; held
    against the whole call's rows and the plain version's, float32 and
    bfloat16 and once with paligemma's window of 96.  Times: each block's
    call beside the whole call's."""
    from repro_torch.kernels import flash_attention, flash_attention_plain

    B, S = 4, 512
    n = S // SHARDS
    rows = {}
    for name, heads, dtype, window in (("llama_f32", LLAMA, torch.float32, 0),
                                       ("llama_bf16", LLAMA, torch.bfloat16, 0),
                                       ("paligemma_f32", PALIGEMMA, torch.float32, 0),
                                       ("paligemma_bf16", PALIGEMMA, torch.bfloat16, 0),
                                       ("paligemma_window96_f32", PALIGEMMA, torch.float32, 96),
                                       ("kimi_f32", KIMI, torch.float32, 0),
                                       ("kimi_bf16", KIMI, torch.bfloat16, 0),
                                       ("siglip_f32", SIGLIP, torch.float32, 0),
                                       ("siglip_bf16", SIGLIP, torch.bfloat16, 0),
                                       ("d192_f32", D192, torch.float32, 0),
                                       ("d192_bf16", D192, torch.bfloat16, 0)):
        H, KVH, D = heads["H"], heads["KVH"], heads["D"]
        gen = torch.Generator(device=dev).manual_seed(SEED + 7 + window)
        q, k, v = (_rand(gen, s, dtype, dev) for s in ((B, S, H, D), (B, S, KVH, D),
                                                       (B, S, KVH, D)))
        whole = flash_attention(q, k, v, causal=True, window=window)
        plain = flash_attention_plain(q, k, v, causal=True, window=window)
        blocks = [q[:, i * n:(i + 1) * n] for i in range(SHARDS)]  # strided views of q
        err_whole = err_plain = 0.0
        for i, qb in enumerate(blocks):
            got = flash_attention(qb, k, v, causal=True, window=window, q_offset=i * n)
            rows_of = slice(i * n, (i + 1) * n)
            err_whole = max(err_whole, (got.float() - whole[:, rows_of].float()).abs().max().item())
            err_plain = max(err_plain, (got.float() - plain[:, rows_of].float()).abs().max().item())
        err_plain_whole = (whole.float() - plain.float()).abs().max().item()
        check(max(err_whole, err_plain) <= ATTN_TOL[dtype],
              f"flash_attention shards {name}: max |err| {err_whole} (whole call), "
              f"{err_plain} (plain)")
        whole_ms = device_ms(lambda *a: flash_attention(*a, causal=True, window=window),
                             lambda: (q, k, v), reps=20)
        shard_ms = [device_ms(lambda qb, k, v, off=i * n: flash_attention(
            qb, k, v, causal=True, window=window, q_offset=off), lambda qb=qb: (qb, k, v),
            reps=20) for i, qb in enumerate(blocks)]
        rows[name] = dict(max_abs_err_whole=err_whole, max_abs_err_plain=err_plain,
                          whole_ms=whole_ms, shard_ms=shard_ms)
        emit(phase="kernel_shards", kernel="flash_attention", case=name, B=B, S=S, H=H, KVH=KVH,
             D=D, dtype=str(dtype), window=window, shards=SHARDS,
             q_offsets=[i * n for i in range(SHARDS)], max_abs_err_whole=err_whole,
             max_abs_err_plain=err_plain, whole_vs_plain=err_plain_whole, tol=ATTN_TOL[dtype],
             whole_ms=whole_ms, shard_ms=shard_ms, shard_max_ms=max(shard_ms),
             shard_sum_ms=sum(shard_ms))
        del q, k, v, whole, plain, blocks
    return rows


def decode_shard_phase(dev):
    """decode_attention on a model axis's cache shards, on one card: a
    544-entry cache of llama3.2-3b's, paligemma-3b's and kimi-k2-1t-a32b's
    heads, SigLIP-so400m's (head dim 72) and head dim 192's cut into four
    shards of 136, each run with its ``kv_start`` and ``lse`` as each rank
    of a (1, 4) mesh runs its shard, merged as the model merges the ranks'
    (:func:`repro_torch.models.attention.merge_splits`, the combine of
    ``combine_splits``), against the whole-cache kernel and the plain
    version; float32 and bfloat16, ``cache_len`` 1 (three shards empty:
    o = 0, lse = -1e30) and 544.  Times: each shard's call beside the whole
    call's."""
    from repro_torch.kernels import decode_attention, decode_attention_plain
    from repro_torch.kernels.flash_attention import NEG_INF
    from repro_torch.models.attention import merge_splits

    B, Smax = 4, 544
    n = Smax // SHARDS
    rows = {}
    for tag, heads in (("llama", LLAMA), ("paligemma", PALIGEMMA), ("kimi", KIMI),
                       ("siglip", SIGLIP), ("d192", D192)):
        for dtype in (torch.float32, torch.bfloat16):
            H, KVH, D = heads["H"], heads["KVH"], heads["D"]
            gen = torch.Generator(device=dev).manual_seed(SEED + 11)
            q, kc, vc = (_rand(gen, s, dtype, dev) for s in ((B, 1, H, D), (B, Smax, KVH, D),
                                                             (B, Smax, KVH, D)))
            shards = [(kc[:, i * n:(i + 1) * n], vc[:, i * n:(i + 1) * n], i * n)
                      for i in range(SHARDS)]
            for length in (1, Smax):
                name = f"{tag}_len{length}_{str(dtype).split('.')[-1]}"
                n_t = torch.tensor([length], dtype=torch.int32, device=dev)
                whole = decode_attention(q, kc, vc, n_t)
                plain = decode_attention_plain(q, kc, vc, n_t)
                parts = [decode_attention(q, ks, vs, n_t, kv_start=start, with_lse=True)
                         for ks, vs, start in shards]
                o = torch.stack([p[0][:, 0].float() for p in parts])  # [R, B, H, D]
                lse = torch.stack([p[1] for p in parts])  # [R, B, H]
                merged = merge_splits(lse, torch.ones_like(lse), o)[:, None].to(dtype)
                empty = [i for i, (_, _, start) in enumerate(shards) if start >= length]
                empty_ok = all(bool((parts[i][0] == 0).all()) and
                               bool((parts[i][1] == NEG_INF).all()) for i in empty)
                finite = all(bool(torch.isfinite(p[1]).all()) for p in parts)
                err_whole = (merged.float() - whole.float()).abs().max().item()
                err_plain = (merged.float() - plain.float()).abs().max().item()
                plain_parts = [decode_attention_plain(q, ks, vs, n_t, kv_start=start,
                                                      with_lse=True) for ks, vs, start in shards]
                lse_err = max((p[1] - w[1]).abs().max().item()
                              for p, w in zip(parts, plain_parts))
                check(max(err_whole, err_plain) <= ATTN_TOL[dtype] and empty_ok and finite
                      and lse_err <= ATTN_TOL[torch.float32] * 10,
                      f"decode_attention shards {name}: max |err| {err_whole} (whole), "
                      f"{err_plain} (plain), lse {lse_err}, empty shards {empty} "
                      f"o = 0 and lse = -1e30: {empty_ok}, lse finite {finite}")
                whole_ms = device_ms(lambda *a: decode_attention(*a), lambda: (q, kc, vc, n_t),
                                     reps=50)
                shard_ms = [device_ms(lambda ks, vs, start: decode_attention(
                    q, ks, vs, n_t, kv_start=start, with_lse=True), lambda sh=sh: sh, reps=50)
                    for sh in shards]
                rows[name] = dict(max_abs_err_whole=err_whole, max_abs_err_plain=err_plain,
                                  whole_ms=whole_ms, shard_ms=shard_ms)
                emit(phase="kernel_shards", kernel="decode_attention", case=name, B=B, H=H,
                     KVH=KVH, D=D, Smax=Smax, shards=SHARDS, cache_len=length,
                     dtype=str(dtype), empty_shards=empty, max_abs_err_whole=err_whole,
                     max_abs_err_plain=err_plain, lse_max_abs_err_plain=lse_err,
                     tol=ATTN_TOL[dtype], whole_ms=whole_ms, shard_ms=shard_ms,
                     shard_max_ms=max(shard_ms), shard_sum_ms=sum(shard_ms))
            del q, kc, vc, shards
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
    the chunked dual form (C B^T over the visible pairs of every chunk, once
    per group, since all of a group's heads share it; the decayed scores
    times xbar over the visible pairs, per head; and the carried state's two
    products between chunks, not before the first or after the last), or
    the step-by-step recurrence (per step and head, s = a s + xbar B^T is a
    multiply and a multiply-add per state element and y = s C a
    multiply-add: 5 P N).  The decay factors and the D x term (O(L^2 + L P)
    per chunk) are left out of both.  Also the operations of the kernels'
    route, the chunked form's products on the tensor cores in TF32: three
    products each for a pair of float32 operands (split TF32), two where one
    operand is bfloat16 (exact in TF32), one where both are.  Returns
    (bytes, flops, the route's TF32 flops, the counts)."""
    x, dt, A, Bm, Cm, D = args
    B, S, H, P = x.shape
    G, N = Bm.shape[-2], Bm.shape[-1]
    nc = S // L
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, A, Bm, Cm, D, y))
    pairs = L * (L + 1) // 2
    scores = 2 * B * G * nc * pairs * N
    intra = 2 * B * H * nc * pairs * P
    state = 2 * B * H * (nc - 1) * 2 * L * P * N  # xbar B^T and C s
    chunked = scores + intra + state
    recurrence = 5 * B * H * S * P * N
    bf16 = x.dtype == torch.bfloat16
    tf32 = (1 if bf16 else 3) * scores + 3 * intra + (2 if bf16 else 3) * state
    return nbytes, min(chunked, recurrence), tf32, dict(chunked=chunked, recurrence=recurrence,
                                                        tf32_route=tf32)


SSD_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel",
               "ssd_chunk_cumsum_kernel")


def kernel_stage_ms(fn, reps: int, kernels=SSD_KERNELS) -> dict:
    """Mean device milliseconds a call of each of ``kernels`` (by name; the
    SSD scan's by default), from torch.profiler over ``reps`` calls of
    ``fn`` (``device_events``); 0 for a kernel the profiler did not see."""
    out = {k: 0.0 for k in kernels}
    for e in device_events(fn, reps):
        for k in kernels:
            if k in e.name:
                out[k] += e.device_time / 1e3 / reps
    return out


def ssd_phase(dev):
    """ssd_scan against its plain version on the card at the prefill's
    shapes (4 prompts of 512 tokens, chunk 256), each element held to
    ``ssd_scan_tolerance`` (the derived bound of two float32 evaluations in
    different orders); plus bfloat16, a ragged chunk (480 -> 240), and a
    weak decay (|dt A| ~ 1e-3 per step, exp over a chunk ~0.8) under which
    the carried state matters: its part of y is measured against the same
    inputs cut into independent chunks.  Shapes no registered config has,
    which the reference's kernel takes (ROADMAP B), in both types: (P, N) =
    (48, 80) and (64, 256) at mamba2's heads (the kernels at sizes 64 x 128
    and 64 x 256); a chunk of 4,096 (its cumsum in the workspace) at B 1,
    S 8,192 and 2 heads (the plain version holds a chunk's [L, L] float64
    decays a head); S 4,099 at B 16 and 2 heads, chunks of 1 (B nc =
    65,584: the output kernel's grid loops past 65,535)."""
    from repro_torch.kernels import ssd_scan, ssd_scan_plain, ssd_scan_tolerance
    from repro_torch.kernels.ssd_scan import pick_chunk

    # (name, B, heads, S, dtype, decay, chunk)
    cases = [("mamba2_f32", 4, MAMBA2, 512, torch.float32, 1.0, SSD_CHUNK),
             ("mamba2_bf16", 4, MAMBA2, 512, torch.bfloat16, 1.0, SSD_CHUNK),
             ("mamba2_weak_f32", 4, MAMBA2, 512, torch.float32, 1e-3, SSD_CHUNK),
             ("hymba_f32", 4, HYMBA, 512, torch.float32, 1.0, SSD_CHUNK),
             ("ragged480_f32", 4, MAMBA2, 480, torch.float32, 1.0, SSD_CHUNK)]
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cases += [(f"p48n80_{dt_name}", 4, dict(H=80, P=48, N=80), 512, dtype, 1.0, SSD_CHUNK),
                  (f"p64n256_{dt_name}", 4, dict(H=80, P=64, N=256), 512, dtype, 1.0, SSD_CHUNK),
                  (f"chunk4096_{dt_name}", 1, dict(H=2, P=64, N=128), 8192, dtype, 1e-3, 4096),
                  (f"prime4099_{dt_name}", 16, dict(H=2, P=16, N=16), 4099, dtype, 1.0,
                   SSD_CHUNK)]
    rows = {}
    for name, B, heads, S, dtype, decay, chunk in cases:
        args = ssd_inputs(dev, B, S, heads["H"], heads["P"], heads["N"], dtype, decay,
                          SEED + S + heads["N"])
        L = pick_chunk(S, chunk)
        got = ssd_scan(*args, chunk=chunk)
        want = ssd_scan_plain(*args, chunk=L)
        tol = ssd_scan_tolerance(*args, chunk=chunk)
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
            # bfloat16 outputs: kernel and plain version each round y, so they
            # may differ by one unit in the last place at max |y|
            rounding = scale * torch.finfo(dtype).eps if dtype == torch.bfloat16 else 0.0
            check(carried >= 0.05 * scale and err <= 1e-3 * carried + rounding,
                  f"ssd_scan {name}: the carried state is {carried} of max |y| {scale}, "
                  f"the kernel's error {err}")
        nbytes, flops, tf32_flops, counts = ssd_cost(args, got, L)
        # the bound follows the kernels' route, the chunked form's products
        # on the tensor cores in (split) TF32; the CUDA cores' float32 figure
        # for the least work is kept beside it
        bound_ms, bound_by = _bound(nbytes, tf32_flops, TF32_FLOP_PER_S)
        bound_cuda_cores_ms = _bound(nbytes, flops, FP32_FLOP_PER_S)[0]
        ms = device_ms(lambda *a: ssd_scan(*a, chunk=chunk), lambda: args, reps=10)
        call_ms = cuda_ms(lambda *a: ssd_scan(*a, chunk=chunk), lambda: args, reps=10)
        # the plain version loops over the chunks on the host: at thousands of
        # chunks its launches would outrun device_ms's hold, so it is timed by
        # events around each call (host gaps included)
        plain_timer = cuda_ms if S // L > 64 else device_ms
        plain_ms = plain_timer(lambda *a: ssd_scan_plain(*a, chunk=L), lambda: args, reps=3)
        stage_ms = kernel_stage_ms(lambda: ssd_scan(*args, chunk=chunk), reps=5)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, plain_timer=plain_timer.__name__,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=None, max_abs_err=err)
        emit(phase="kernel", kernel="ssd_scan", case=name, B=B, S=S, L=L, nc=S // L,
             dtype=str(dtype),
             decay=decay, **heads, max_abs_err=err, tol_use=use, max_abs_y=scale,
             carried_state_max=carried, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
             plain_timer=plain_timer.__name__,
             library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
             bound_route="TF32 tensor cores: split TF32 (3 products) for float32 operands, "
                         "fewer where an operand is bfloat16",
             bound_cuda_cores_ms=bound_cuda_cores_ms, stage_ms=stage_ms, flops=flops,
             flops_chunked=counts["chunked"], flops_recurrence=counts["recurrence"],
             flops_tf32_route=tf32_flops, bytes=nbytes, tflops=flops / ms / 1e9)
        del args, got, want, tol, diff, alone, cut, x, dt, A, Bm, Cm, D
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- the RMSNorm kernel

# the served models' norm shapes: llama3.2-3b's prefill (4 x 512 tokens) and
# decode step, mamba2-2.7b's gated norm over d_inner, hymba-1.5b's d_model;
# bfloat16; a ragged row count; two other configs' widths (minitron-8b's
# 4096: two warps a row, mistral-large-123b's 12288: eight); a width that is
# no multiple of 16 bytes (the generic kernel, the row in shared memory)
RMS_CASES = [("llama_prefill_f32", (2048, 3072), torch.float32),
             ("llama_decode_f32", (4, 3072), torch.float32),
             ("mamba2_d_inner_f32", (2048, 5120), torch.float32),
             ("hymba_f32", (2048, 1600), torch.float32),
             ("llama_prefill_bf16", (2048, 3072), torch.bfloat16),
             ("ragged2047_f32", (2047, 3072), torch.float32),
             ("minitron_f32", (2048, 4096), torch.float32),
             ("mistral_large_f32", (2048, 12288), torch.float32),
             ("generic3071_f32", (2048, 3071), torch.float32)]
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
    from repro_torch.engine import autotune
    from repro_torch.kernels import launch_counts, reset_launch_counts, simplex_pivot
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
        clusters = dict(sorted(simplex_pivot.clusters.items()))
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
         autotune_probe_s=probe_s, launches=counts, pivot_clusters=clusters,
         k_pivots_chosen=dict(Counter(e["k_pivots"] for key, e in autotune._CACHE.items()
                                      if key[2] == "cuda")), evaluate_gammas_n=len(sample),
         evaluate_gammas_max_rel_err=eval_err, evaluate_gammas_launches=eval_launches)
    return counts


# ---------------------------------------------------------------- phase 5

SERVE_B, SERVE_PROMPT, SERVE_STEPS = 4, 512, 32
# each model freed before the next; deepseek-v2-lite-16b (64.8 GB of float32
# weights) last
SERVE_ARCHS = ("llama3.2-3b", "mamba2-2.7b", "hymba-1.5b", "paligemma-3b", "musicgen-medium",
               "kimi-k2-1t-a32b", "deepseek-v2-lite-16b")
# kimi-k2-1t-a32b (~2.1 TB whole) at full width cut as scripts/tp_dist.py's
# (vii): 2 of 61 layers, 64 of 384 routed experts (top-8 and the shared one
# kept), ~33 GB of float32 weights
SERVE_CUTS = {"kimi-k2-1t-a32b": dict(num_layers=2, num_experts=64)}
# smoke-size variants (``smoke_variant``: 2 layers, vocab 256) at shapes no
# registered config has, which the reference's kernels take: the model-level
# check of the kernels' new shapes (phase 2 holds the kernels at full size).
# name: (registered arch, fields replaced; "ssm": fields of its SSM config)
SERVE_VARIANTS = {
    # hymba-1.5b's family: d_model 72, d_inner 144 at expand 2, 3 SSD heads of
    # 48, state size 80; 4 attention heads on 2 KV heads of 72
    "hymba-1.5b-d72": ("hymba-1.5b", dict(d_model=72, num_heads=4, num_kv_heads=2, head_dim=72,
                                          ssm=dict(d_state=80, head_dim=48))),
    # llama3.2-3b's family at head dim 192 (the head-dim-256 kernels)
    "llama3.2-3b-d192": ("llama3.2-3b", dict(head_dim=192)),
}
# kernel path vs plain path (both float32 on the card, the same weights and
# the same matrix products): they differ only in the summation order of
# attention and of the SSD scan (chunked against step by step), ~1e-6
# relative per layer; 1e-3 of max(1, max |value|) leaves that amplified
# through 18-64 random layers well inside, and a wrong mask, head, cache
# slot or decay (an O(1) change) far outside.  deepseek-v2-lite-16b (MLA,
# no kernel) is held to its own forward by the same bar: decode from the
# latent cache against the full sequence, and gshard at ample capacity
# against dense dispatch (the same products summed in another order)
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
        if "flash_attention_" in name:  # flash_attention_kernel, FLASH_D256_KERNELS
            key = "flash_attention"
        elif "decode_attention_" in name:  # decode_attention_kernel, its d256 kernel
            key = "decode_attention"
        elif any(k in name for k in SSD_KERNELS):
            key = "ssd_scan"
        elif any(t in name.lower() for t in ("gemm", "cutlass", "splitkreduce")):
            key = "matmul"
        else:
            key = "other"
        groups[key] += e.device_time / 1e3
    return groups, n_ops


def _kernel_attention(cfg) -> bool:
    """Whether the model's attention runs the attention kernels (MLA's runs
    in plain PyTorch, as the reference's is plain JAX)."""
    return cfg.has_attention and cfg.mla is None


def serve_profile(model, cfg, policy, prompt, patches, n_steps: int, res) -> dict:
    """Where the device time of the serving path goes: one prefill and
    ``n_steps`` decode steps under torch.profiler, their kernels' device
    time by group, the device operations per decode step, and the device's
    busy share against the unprofiled run's wall times (``res``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import prefill
    from repro_torch.runtime import make_serve_step

    S = res.prefill_logits.shape[1]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        logits, cache, pos = prefill(model, cfg, policy, prompt, patches, max_len=S + n_steps)
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
    attn = _kernel_attention(cfg)
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


def naive_check(model, cfg, prompt, patches, res) -> dict:
    """The plain path (``"naive"``) on the same weights, fed the kernel
    run's tokens: relative errors of the prefill logits, every step's
    logits and the final cache against the kernel path's."""
    from repro_torch.launch.serve import serve_policy
    from repro_torch.models import prefill
    from repro_torch.runtime import make_serve_step

    N = len(res.step_logits)
    naive = serve_policy(SERVE_PROMPT, "naive")
    logits, cache, pos = prefill(model, cfg, naive, prompt, patches,
                                 max_len=res.prefill_logits.shape[1] + N)
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
    return errs


def _held_rel_err(got, want, until: list, dim: int, first: int = 0):
    """``_rel_err`` over the entries of each sequence b (dim 0) at the
    positions before ``until[b]`` (``dim`` counts them from ``first``);
    None where none is held."""
    n = got.shape[dim]
    held = (first + torch.arange(n, device=got.device))[None, :] < torch.tensor(
        until, device=got.device)[:, None]
    held = held.reshape([len(until) if d == 0 else n if d == dim else 1
                         for d in range(got.dim())]).expand_as(got)
    if not bool(held.any()):
        return None
    return ((got.float() - want.float()).abs()[held].max()
            / want.float().abs()[held].max().clamp_min(1.0)).item()


def moe_naive_check(model, cfg, prompt, res) -> tuple:
    """An MoE model with GQA attention (kimi-k2-1t-a32b): the kernel path and
    the plain path (``"naive"``) on the same weights, both fed the kernel
    run's tokens, with each MoE layer's routing recorded (the kernel path is
    run again for it).  Where a router's k-th and (k+1)-th probabilities
    nearly tie, the two attentions' ~1e-7 differences pick another expert
    for a token (C.16): each sequence is held to the bar on its logits and
    its cache before its first touched position, as ``moe_checks`` holds
    gshard against dense, and the flips are reported
    (``runtime.profile.routing_flips``, as ``scripts/tp_dist.py``'s); a
    primary flip above its near-tie margin fails.  Returns (the held
    relative errors, what is reported)."""
    from repro_torch.launch.serve import serve_policy
    from repro_torch.models import prefill
    from repro_torch.runtime import make_serve_step
    from repro_torch.runtime.profile import observe_routes, routing_flips

    B, S = prompt.shape
    N = len(res.step_logits)
    feed = [res.prefill_logits[:, -1:].argmax(dim=-1).to(torch.int32)] + [
        res.tokens[:, i:i + 1] for i in range(N - 1)]
    runs = {}
    for impl in ("cuda", "naive"):
        routes, now = {}, {"step": None}
        policy = serve_policy(S, impl)
        with observe_routes(model, routes, lambda: (0, now["step"])):
            logits, cache, pos = prefill(model, cfg, policy, prompt, max_len=S + N)
            step = make_serve_step(cfg, policy)
            steps = []
            for i in range(N):
                now["step"] = i
                lg, cache = step(model, cache, feed[i], pos + i)
                steps.append(lg)
        runs[impl] = (logits if impl == "naive" else None, steps, cache, routes)
        del logits
    info = routing_flips(runs["cuda"][3], runs["naive"][3], B, S, cfg)
    until = [info["first_touched"].get(0, {}).get(b, S + N) for b in range(B)]
    logits, steps, cache, _ = runs["naive"]
    errs = {"prefill_logits": _held_rel_err(res.prefill_logits, logits, until, 1),
            "step_logits": max((e for e in (_held_rel_err(res.step_logits[i], lg, until, 1, S + i)
                                             for i, lg in enumerate(steps)) if e is not None),
                               default=None)}
    got = _leaves(res.cache)
    for name, leaf in _leaves(cache).items():  # [L, B, S + N, ...]
        errs[f"cache_{name}"] = _held_rel_err(got[name].transpose(0, 1), leaf.transpose(0, 1),
                                              until, 2)
    info.update(sequences_held_whole=[b for b in range(B) if until[b] == S + N],
                held_until=until)
    return {k: v for k, v in errs.items() if v is not None}, info


def moe_checks(model, cfg, prompt) -> tuple:
    """deepseek-v2-lite-16b at full width, which no kernel runs: (a) the
    reference's ``test_prefill_then_decode_matches_forward`` with dense
    experts: prefill S - 1 tokens, decode token S from the latent cache,
    against ``forward`` over all S; (b) gshard at a capacity that drops
    nothing (cf = E / k) against dense dispatch.

    (b) is held on identical inputs: along the dense forward, each MoE
    layer's hidden states also go through gshard, and the two outputs are
    compared.  The whole prefill's logits through gshard are compared too,
    and each layer's routing recorded in both runs: where a router's k-th
    and (k+1)-th probabilities nearly tie, the two runs' ~1e-7 differences
    pick another expert for a token (a "flip"), which moves that token's
    output by O(1) and, through attention, the rest of its sequence.  Only
    the sequences without a flip are held to the bar on the logits; the
    flips and the whole-prefill difference are reported (ROADMAP C.16).
    Returns (the gated relative errors, what is reported)."""
    import dataclasses

    import repro_torch.models.moe as moe_mod
    import repro_torch.models.transformer as transformer
    from repro_torch.launch.serve import serve_policy
    from repro_torch.models import decode_step, forward, prefill

    B, S = prompt.shape
    gshard = serve_policy(S)
    dense = dataclasses.replace(gshard, moe_impl="dense")
    mo = cfg.moe
    ample = dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))
    check(moe_mod.capacity(ample, B * S) >= B * S, "gshard's ample capacity holds every token")
    ffn = transformer.moe_ffn
    routes, layer_errs = {"dense": [], "gshard": []}, []
    mode = None

    def observed_ffn(p, h, c, impl, **axes):
        y, aux = ffn(p, h, c, impl=impl, **axes)
        if mode is not None:  # this layer's experts, as sets
            experts = moe_mod._router(p, h.reshape(-1, h.shape[-1]).float(), c.moe)[1]
            routes[mode].append(experts.sort(dim=-1).values)
        if mode == "dense":  # the same hidden states through gshard at ample capacity
            layer_errs.append(_rel_err(ffn(p, h, ample, impl="gshard")[0], y))
        return y, aux

    transformer.moe_ffn = observed_ffn
    try:
        mode = "dense"
        full, _, _ = forward(model, cfg, dense, prompt)
        mode = None
        errs = {}
        logits, cache, n = prefill(model, cfg, dense, prompt[:, :S - 1], max_len=S)
        errs["dense_prefill_last"] = _rel_err(logits[:, -1], full[:, S - 2])
        del logits
        logits, cache = decode_step(model, cfg, dense, cache, prompt[:, S - 1:], n)
        errs["dense_decode_vs_forward"] = _rel_err(logits[:, 0], full[:, S - 1])
        del logits, cache
        mode = "gshard"
        logits, _, _ = prefill(model, ample, gshard, prompt)
        mode = None
    finally:
        transformer.moe_ffn = ffn
    L = cfg.num_layers
    check(len(layer_errs) == L and all(len(r) == L for r in routes.values()),
          "every MoE layer observed in both runs")
    errs["gshard_ample_vs_dense_per_layer"] = max(layer_errs)
    flips = torch.stack([(a != b).any(dim=-1) for a, b in zip(routes["dense"],
                                                                routes["gshard"])])  # [L, B S]
    flipped = flips.view(L, B, S).any(dim=2).any(dim=0)  # sequences with a flip
    layers = flips.any(dim=1).nonzero().flatten().tolist()
    if not bool(flipped.all()):
        errs["gshard_ample_vs_dense_unflipped_sequences"] = _rel_err(logits[~flipped],
                                                                     full[~flipped])
    info = {"route_flips": int(flips.sum()), "first_flip_layer": layers[0] if layers else None,
            "flips_by_layer": flips.sum(dim=1).tolist(),
            "flipped_sequences": int(flipped.sum()),
            "gshard_ample_vs_dense_logits": _rel_err(logits, full)}
    return errs, info


LAST_LOGIT_ARCH = "paligemma-3b"  # the largest vocabulary: the most logits a prefill can skip
LAST_LOGIT_TOL = 1e-5


def last_logit_check(model, cfg, policy, prompt, patches) -> dict:
    """The prefill under ``prefill_last_logit_only`` (the final hidden
    state's last position alone through the head: [B, 1, V]) against the
    whole prefill's last row on the same weights and path: their relative
    error (of max |value|) and each prefill's peak memory."""
    import dataclasses

    from repro_torch.models import prefill

    out = {}
    for name, pol in (("whole", policy),
                      ("last", dataclasses.replace(policy, prefill_last_logit_only=True))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        logits, cache, _ = prefill(model, cfg, pol, prompt, patches)
        torch.cuda.synchronize()
        # the whole prefill's last row copied out, so its logits are freed
        out[name] = (logits[:, -1:].clone() if name == "whole" else logits,
                     torch.cuda.max_memory_allocated() / 1e9, tuple(logits.shape))
        del logits, cache
    (whole, whole_gb, whole_shape), (last, last_gb, last_shape) = out["whole"], out["last"]
    err = ((last.float() - whole.float()).abs().max() / whole.float().abs().max()).item()
    return dict(rel_err=err, tol=LAST_LOGIT_TOL, whole_shape=whole_shape, last_shape=last_shape,
                whole_prefill_peak_gb=whole_gb, last_prefill_peak_gb=last_gb,
                peak_saved_gb=whole_gb - last_gb)


def variant_config(name):
    """The smoke-size config of a ``SERVE_VARIANTS`` entry."""
    import dataclasses

    from repro_torch.config import get_arch, smoke_variant

    arch, fields = SERVE_VARIANTS[name]
    cfg = smoke_variant(get_arch(arch))
    fields = dict(fields)
    if "ssm" in fields:
        fields["ssm"] = dataclasses.replace(cfg.ssm, **fields["ssm"])
    return dataclasses.replace(cfg, name=name + "-smoke", **fields)


def serve_phase(dev, arch):
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import (generate, load_model, prompt_patches, prompt_tokens,
                                          serve_policy)

    cfg = variant_config(arch) if arch in SERVE_VARIANTS else get_arch(arch)
    cut = SERVE_CUTS.get(arch)
    if cut:
        cfg = dataclasses.replace(cfg, num_layers=cut["num_layers"], moe=dataclasses.replace(
            cfg.moe, num_experts=cut["num_experts"]))
    elif arch in SERVE_VARIANTS:  # reported as the cut: the smoke variant of an arch
        base, fields = SERVE_VARIANTS[arch]
        cut = dict(smoke_variant_of=base, **fields)
    B, S, N = SERVE_B, SERVE_PROMPT, SERVE_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = load_model(cfg, SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompt = prompt_tokens(cfg, B, S, SEED, dev)  # vlm: the text after 256 patches
    patches = prompt_patches(cfg, B, S, SEED, dev)
    policy = serve_policy(S)
    check(policy.attention_impl == "cuda", "the serve policy runs the kernels")
    # first-call costs of cuBLAS and the kernels
    warm = generate(model, cfg, policy, prompt, 2, patches=patches)
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    res = generate(model, cfg, policy, prompt, N, patches=patches, keep_logits=True)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    progress(f"serve {arch}: prefill {res.prefill_s:.3f} s, {N} steps in {res.decode_s:.3f} s")
    L = cfg.num_layers
    attn = L if _kernel_attention(cfg) else 0
    want = {"simplex_pivot": 0, "asap_replay": 0, "flash_attention": attn,
            "decode_attention": attn * N, "ssd_scan": L if cfg.has_ssm else 0, "rms_norm": 0}
    check(counts == want, f"serve {arch} launches {counts}, expected {want}")
    codebooks = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    check(tuple(res.prefill_logits.shape) == (B, S, *codebooks, cfg.vocab_size),
          "prefill logits shape")
    check(tuple(res.tokens.shape) == (B, N, *codebooks), "generated tokens shape")
    finite = bool(torch.isfinite(res.prefill_logits).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in res.step_logits)
    check(finite, f"serve {arch} logits finite")
    tokens = res.tokens.cpu()
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "tokens in the vocabulary")

    t1 = time.perf_counter()
    reported = {}
    if cfg.mla is not None:  # MLA: no kernel to hold against its plain version
        (errs, reported), check_name = moe_checks(model, cfg, prompt), "dense_and_gshard"
    elif cfg.moe is not None:  # the plain path, the sequences no routing flip touched
        (errs, reported), check_name = moe_naive_check(model, cfg, prompt, res), "naive_held"
    else:  # the plain path on the same weights
        errs, check_name = naive_check(model, cfg, prompt, patches, res), "naive"
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t1
    worst = max(errs.values())
    torch.cuda.empty_cache()
    last_logit = (last_logit_check(model, cfg, policy, prompt, patches)
                  if arch == LAST_LOGIT_ARCH else None)
    breakdown = serve_profile(model, cfg, policy, prompt, patches, 4, res)
    emit(phase="serve", arch=cfg.name, cut=cut, layers=cfg.num_layers, params=n_params,
         dtype="float32", batch=B,
         prompt_len=S, patches=0 if patches is None else patches.shape[1], gen_len=N,
         moe_impl=policy.moe_impl if cfg.moe else None, init_s=init_s,
         prefill_s=res.prefill_s, prefill_tok_per_s=B * S / res.prefill_s,
         decode_s=res.decode_s, decode_tok_per_s=B * N / res.decode_s,
         decode_step_ms=1e3 * res.decode_s / N, peak_mem_gb=peak / 1e9, launches=counts,
         sample_tokens=tokens[0, :8].reshape(-1)[:8].tolist(), check=check_name,
         check_s=check_s, rel_err=errs, tol=SERVE_TOL, reported=reported,
         last_logit=last_logit, **breakdown)
    check(worst <= SERVE_TOL, f"serve {arch}: {check_name} check {errs}")
    check(reported.get("ok", True), f"serve {arch}: a primary routing flip above the "
          f"near-tie margin: {reported.get('primary_margin_max')}")
    if last_logit is not None:
        check(last_logit["rel_err"] <= LAST_LOGIT_TOL
              and last_logit["last_shape"] == (B, 1, cfg.vocab_size),
              f"serve {arch}: the last-position prefill against the whole one's last row "
              f"{last_logit}")
    del model, res, prompt, patches
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 9

TRAIN_ARCH, TRAIN_B, TRAIN_SEQ, TRAIN_STEPS = "llama3.2-3b", 4, 512, 4
# Adam's first steps move each weight by about lr whatever the size of its
# gradient.  5e-5 is a step a full-width random init takes without harm, and
# it keeps the microbatch check meaningful: an element whose gradient sits
# under float32 rounding can step either way in the two runs, 2 lr = 1e-4
# apart, inside the reference's atol of 2e-4
TRAIN_LR = 5e-5
# the reference's bars for microbatch accumulation (tests/test_train_step.py)
MB_LOSS_TOL, MB_RTOL, MB_ATOL = 5e-4, 2e-3, 2e-4
# the card's step against the CPU's (full width, 2 layers): float32 on both,
# sums in other orders (~1e-6 relative); 1e-3 of each gradient leaf's max |g|
# is the serve phase's bar, and a wrong gradient (an O(1) change) is far out
TRAIN_GRAD_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-5
# an element whose gradient rounds to the other sign on one side takes
# Adam's normalised step the other way: after one step (|update| <= 1) the
# two sides sit 2 lr apart, after three at most ~4 lr
FLIP_1, FLIP_3 = 2.1 * TRAIN_LR, 4 * TRAIN_LR
TRAIN_SMALL = (2, 2, 128)  # layers, batch, sequence of phase 9 (b)
TRAIN_CKPT_DIR = REPO / "build" / "chip_smoke_train_ckpt"


def _train_args(steps: int, batch: int, seq: int, microbatches: int = 1):
    from repro_torch.launch import train as cli

    return cli.parse_args(["--arch", TRAIN_ARCH, "--steps", str(steps), "--batch", str(batch),
                           "--seq", str(seq), "--lr", str(TRAIN_LR), "--seed", str(SEED),
                           "--microbatches", str(microbatches), "--device", "cuda"])


def _train_batch(cfg, B, S, step, dev):
    from repro_torch.data import make_batch

    return {k: torch.from_numpy(v).to(dev) for k, v in make_batch(cfg, B, S, step, SEED).items()}


def _free():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _train_flops(cfg, B, S) -> tuple:
    """(model FLOPs of a step: 6 N_active per token with the tied head's
    products, which train_flops_per_token leaves out with the embedding
    gather, plus attention's quadratic term; the same with each block's
    forward run again by remat)."""
    from repro_torch.models import param_counts, train_flops_per_token

    pc = param_counts(cfg)
    tokens = B * S
    model = (train_flops_per_token(cfg, S) + 6.0 * cfg.vocab_size * cfg.d_model) * tokens
    block_fwd = 2.0 * (pc.active - pc.embed) + 2.0 * cfg.num_layers * cfg.num_heads * \
        cfg.head_dim * S
    return model, model + block_fwd * tokens


def _host_params(state) -> dict:
    return {n: p.detach().cpu() for n, p in state.params.named_parameters()}


def train_full_phase(dev) -> dict:
    """Phase 9 (a): llama3.2-3b at full width and depth through
    ``repro_torch.launch.train``'s functions."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as cli
    from repro_torch.runtime import make_train_step
    from repro_torch.runtime.profile import profile_train_step

    B, S = TRAIN_B, TRAIN_SEQ
    args = _train_args(TRAIN_STEPS, B, S)
    cfg, policy, tcfg = cli.build_cfg(args)
    check(policy.attention_impl == "chunked" and policy.remat == "block"
          and policy.attn_chunk == S, f"the CLI's training policy: {policy}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = cli.init_state(args, cfg, tcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.parameters())
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    log, state = cli.run_standard(args, cfg, policy, tcfg, state=state)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state_gb = sum(t.numel() * t.element_size() for t in [
        *state.params.parameters(), *(p.grad for p in state.params.parameters()),
        *state.opt.m.values(), *state.opt.v.values()]) / 1e9
    check(all(v == 0 for v in counts.values()), f"the training path launched kernels: {counts}")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in log),
          f"losses and grad norms finite: {log}")
    walls = [m["time_s"] for m in log]
    steady = float(np.median(walls[1:]))
    progress(f"train {TRAIN_ARCH}: {TRAIN_STEPS} steps, {[round(w, 3) for w in walls]} s")
    prof = profile_train_step(cfg, policy, tcfg, state, _train_batch(cfg, B, S, TRAIN_STEPS, dev))
    groups = prof["device_ms"]
    check(groups["attention"] > 0 and groups["optimizer"] > 0 and groups["matmul"] > 0,
          f"the profiler saw the train step's groups on the card: {groups}")
    model_flops, exec_flops = _train_flops(cfg, B, S)
    del state
    _free()

    # the same batch stepped twice lowers the loss (the reference's
    # test_train_step_reduces_loss)
    state = cli.init_state(args, cfg, tcfg)
    step = make_train_step(cfg, policy, tcfg)
    batch = _train_batch(cfg, B, S, 0, dev)
    state, m0 = step(state, batch)
    state, m1 = step(state, batch)
    repeat = (float(m0["loss"]), float(m1["loss"]))
    check(all(np.isfinite(repeat)) and repeat[1] < repeat[0],
          f"the same batch stepped twice lowers the loss: {repeat}")
    del state, batch
    _free()

    # microbatches 2 against 1 from the same seed, two steps each (the
    # reference's test_microbatch_accumulation_matches_full_batch); the
    # first run's parameters wait on the host
    runs = {}
    for mb in (1, 2):
        a = _train_args(2, B, S, microbatches=mb)
        mlog, state = cli.run_standard(a, *cli.build_cfg(a), state=None)
        runs[mb] = mlog[-1]["loss"]
        if mb == 1:
            host = _host_params(state)
            del state
            _free()
    worst_ratio, worst_abs = 0.0, 0.0
    for n, p in state.params.named_parameters():
        want = host[n].to(dev)
        diff = (p.detach() - want).abs()
        worst_abs = max(worst_abs, float(diff.max()))
        worst_ratio = max(worst_ratio, float((diff / (MB_ATOL + MB_RTOL * want.abs())).max()))
    del state, host
    _free()
    mb_loss_diff = abs(runs[1] - runs[2])
    check(mb_loss_diff < MB_LOSS_TOL and worst_ratio <= 1.0,
          f"microbatches 2 against 1: loss {runs}, parameters at {worst_ratio} of the bar")
    steps = [{k: m[k] for k in ("step", "loss", "lr", "grad_norm")} | {"ms": 1e3 * m["time_s"]}
             for m in log]
    return dict(arch=cfg.name, params=n_params, dtype="float32", batch=B, seq=S,
                remat=policy.remat, attn_chunk=policy.attn_chunk, lr=TRAIN_LR, init_s=init_s,
                params_grads_moments_gb=state_gb, steps=steps, step_ms_median=1e3 * steady,
                tok_per_s=B * S / steady, peak_mem_gb=peak / 1e9, launches=counts,
                profiled_step=prof, model_flops=model_flops, flops_with_remat=exec_flops,
                model_tflop_per_s=model_flops / steady / 1e12,
                fp32_peak_share=model_flops / steady / FP32_FLOP_PER_S,
                executed_fp32_peak_share=exec_flops / steady / FP32_FLOP_PER_S,
                same_batch_losses=repeat, microbatch_last_loss=runs,
                microbatch_loss_diff=mb_loss_diff, microbatch_param_max_abs=worst_abs,
                microbatch_param_bar_ratio=worst_ratio)


def _grads(state) -> dict:
    return {n: p.grad.detach() for n, p in state.params.named_parameters()}


def train_small_phase(dev) -> dict:
    """Phase 9 (b): llama3.2-3b at full width with 2 layers: a step on the
    card against the same step on the CPU, and a checkpoint round trip on
    the card.

    The retaken step is held to a tolerance, not run under
    ``torch.use_deterministic_algorithms``: that mode needs
    ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS's first use, which would
    change every earlier phase.  llama's backward has no accumulating
    scatter whose writes collide (the gold logits' gather writes distinct
    positions back; MoE's index_put_ and scatter_add_ are not on this
    path), so equality is expected, and whether it held is printed."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.launch import train as cli
    from repro_torch.models import init_params
    from repro_torch.runtime import make_train_state, make_train_step

    L, B, S = TRAIN_SMALL
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=L)
    _, policy, _ = cli.build_cfg(_train_args(3, B, S))
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=10, seed=SEED)
    step = make_train_step(cfg, policy, tcfg)

    # the card against the CPU, from the same weights (drawn on the card)
    card = make_train_state(init_params(cfg, SEED, torch.float32, dev), tcfg)
    cpu = make_train_state(init_params(cfg, SEED, torch.float32, dev).to("cpu"), tcfg)
    batch = _train_batch(cfg, B, S, 0, dev)
    t0 = time.perf_counter()
    card, m_card = step(card, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu, m_cpu = step(cpu, {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    errs = {k: abs(float(m_card[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
            for k in ("loss", "grad_norm")}
    grads_cpu = _grads(cpu)
    grad_err = max(float((g.cpu() - grads_cpu[n]).abs().max())
                   / max(float(grads_cpu[n].abs().max()), 1e-30)
                   for n, g in _grads(card).items())
    cpu_params = dict(cpu.params.named_parameters())
    param_diff = max(float((p.detach().cpu() - cpu_params[n].detach()).abs().max())
                     for n, p in card.params.named_parameters())
    del cpu, grads_cpu, cpu_params
    check(max(errs.values()) <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL
          and param_diff <= FLIP_1,
          f"train step card vs CPU: {errs}, gradients {grad_err}, parameters {param_diff}")

    # checkpoint round trip on the card: 2 steps, save, 1 more; a fresh state
    # restored from the checkpoint retakes that step
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    card, _ = step(card, _train_batch(cfg, B, S, 1, dev))
    saved = {"params": {n: p.detach().clone() for n, p in card.params.named_parameters()},
             "m": dict(card.opt.m), "v": dict(card.opt.v)}
    t0 = time.perf_counter()
    mgr = CheckpointManager(str(TRAIN_CKPT_DIR))
    mgr.save_async(1, card)
    mgr.wait()
    save_s = time.perf_counter() - t0
    card, m_a = step(card, _train_batch(cfg, B, S, 2, dev))
    fresh = make_train_state(init_params(cfg, SEED + 1, torch.float32, dev), tcfg)
    t0 = time.perf_counter()
    fresh, _ = restore_checkpoint(str(TRAIN_CKPT_DIR), 1, fresh, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored_exact = int(fresh.opt.step) == 2 and all(
        torch.equal(p, saved["params"][n]) for n, p in fresh.params.named_parameters()) and all(
        torch.equal(fresh.opt.m[n], saved["m"][n]) and torch.equal(fresh.opt.v[n], saved["v"][n])
        for n in saved["m"])
    del saved
    fresh, m_b = step(fresh, _train_batch(cfg, B, S, 2, dev))
    ckpt_loss_diff = abs(float(m_a["loss"]) - float(m_b["loss"]))
    fresh_params = dict(fresh.params.named_parameters())
    ckpt_param_diff = max(float((p.detach() - fresh_params[n].detach()).abs().max())
                          for n, p in card.params.named_parameters())
    ckpt_gb = sum(f.stat().st_size for f in TRAIN_CKPT_DIR.rglob("*") if f.is_file()) / 1e9
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    del card, fresh, fresh_params
    _free()
    check(restored_exact, "the restored state equals the saved one, leaf for leaf")
    check(ckpt_loss_diff <= 1e-6 * abs(float(m_a["loss"])) and ckpt_param_diff <= FLIP_3,
          f"the step retaken after the restore: loss {ckpt_loss_diff}, parameters "
          f"{ckpt_param_diff}")
    return dict(layers=L, batch=B, seq=S, card_step_s=card_s, cpu_step_s=cpu_s,
                card_vs_cpu_rel_err=errs, card_vs_cpu_grad_err=grad_err,
                card_vs_cpu_param_max_abs=param_diff, grad_tol=TRAIN_GRAD_TOL,
                ckpt_gb=ckpt_gb, ckpt_save_s=save_s, ckpt_restore_s=restore_s,
                ckpt_restored_exact=restored_exact, ckpt_step_loss_diff=ckpt_loss_diff,
                ckpt_step_param_max_abs=ckpt_param_diff,
                ckpt_step_bitwise=ckpt_loss_diff == 0 and ckpt_param_diff == 0)


def train_phase(dev) -> dict:
    """Phase 9, with the launch counts set to 0 just before each run and
    read just after (every kernel's must stay 0: training runs none)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    full = train_full_phase(dev)
    reset_launch_counts()
    small = train_small_phase(dev)
    counts = launch_counts()
    check(all(v == 0 for v in counts.values()), f"phase 9 (b) launched kernels: {counts}")
    emit(phase="train", **full, small=small)
    return {"arch": full["arch"], "params": full["params"], "step_ms": full["step_ms_median"],
            "tok_per_s": full["tok_per_s"], "peak_mem_gb": full["peak_mem_gb"],
            "busy_share": full["profiled_step"]["busy_share"],
            "fp32_peak_share": full["fp32_peak_share"], "launches": full["launches"]}


# ---------------------------------------------------------------- phase 10

# the reference CLI's chain (launch/train.py run_dlt_chain): 4 stages of
# speeds 1 / (1 + 0.2 i), links at ~15 ms a batch; 2 loads of 4 x 512
# tokens a super-step in 2 installments each; a straggler (stage 3 at half
# speed) from step 1, stage 1 lost at step 2
CHAIN_STAGES, CHAIN_Q, CHAIN_LOADS, CHAIN_STEPS = 4, 2, 2, 4
CHAIN_FAIL, CHAIN_STRAGGLE = "1@step2", "3@step1x2.0"
CHAIN_LOSS_RTOL = 1e-5  # the chain's loss against one pass over the same samples
DIST_LOSS_RTOL = 1e-6  # a DistChain's loss against the LocalChain's
CHAIN_SCENARIOS = 256  # phase 10 (c): straggler what-ifs in one bulk call
CHAIN_CKPT_DIR = REPO / "build" / "chip_smoke_chain_ckpt"
CHAIN_DIST_DIR = REPO / "build" / "chip_smoke_dist_chain"


def _chain_args(steps: int, dev, stages: int = CHAIN_STAGES, extra=()):
    from repro_torch.launch import train as cli

    return cli.parse_args(["--arch", TRAIN_ARCH, "--steps", str(steps), "--batch",
                           str(TRAIN_B), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
                           "--seed", str(SEED), "--device", str(dev), "--dlt-chain", str(stages),
                           "--dlt-q", str(CHAIN_Q), "--dlt-loads", str(CHAIN_LOADS), *extra])


def _super_step_data(cfg, args, data_step: int, stages: int):
    """(tokens, labels, counts) of the super-step at ``data_step`` under the
    CLI's first plan of ``stages`` stages, and its batches."""
    from repro_torch.data import batch_load_spec, make_batch
    from repro_torch.launch import train as cli
    from repro_torch.runtime.dlt_runner import stage_batches
    from repro_torch.runtime.ft import RecoveringChain

    planner, _ = cli.chain_planner(args, cfg, stages)
    loads = [batch_load_spec(cfg, args.batch, args.seq) for _ in range(args.dlt_loads)]
    plan = RecoveringChain(planner, loads, q=args.dlt_q).plan
    batches = [make_batch(cfg, args.batch, args.seq, data_step + i, seed=args.seed)
               for i in range(args.dlt_loads)]
    return (*stage_batches(plan, batches, stages), batches)


def _concat(batches, dev) -> dict:
    return {k: torch.from_numpy(np.concatenate([b[k] for b in batches])).to(dev)
            for k in ("tokens", "labels")}


def _chain_device_ms(prof, stages: int) -> dict:
    """Device milliseconds of one profiled chain step by stage: a kernel
    belongs to the stage whose ``chain.stage{i}`` scope was open on the host
    when its op launched it (the backward's too: ``backward()`` returns
    only when the autograd engine has launched the stage's last kernel);
    the rest (the optimizer, the host-to-device copy of the chunk) apart."""
    spans = [(e.time_range.start, e.time_range.end, int(e.name[len("chain.stage"):]))
             for e in prof.events() if e.name.startswith("chain.stage")
             and e.device_type != torch.autograd.DeviceType.CUDA]
    out = {f"stage{i}": 0.0 for i in range(stages)} | {"rest": 0.0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA or not e.kernels:
            continue
        t = e.time_range.start
        key = next((f"stage{i}" for a, b, i in spans if a <= t <= b), "rest")
        out[key] += sum(k.duration for k in e.kernels) / 1e3
    return out


def _profiled_chain_step(cfg, policy, tcfg, state, args, data_step: int, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.dlt_runner import LocalChain, make_dlt_train_step

    toks, labs, counts, _ = _super_step_data(cfg, args, data_step, CHAIN_STAGES)
    step = make_dlt_train_step(cfg, policy, tcfg, LocalChain(CHAIN_STAGES, dev), len(counts))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, toks, labs, counts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_stage = _chain_device_ms(prof, CHAIN_STAGES)
    rows = counts.sum(axis=0)
    check(all((by_stage[f"stage{i}"] > 0) == (rows[i] > 0) for i in range(CHAIN_STAGES)),
          f"the profiler saw the kernels of every stage with rows {rows.tolist()}: {by_stage}")
    return dict(device_ms=by_stage, wall_ms=1e3 * wall, samples=counts.tolist(),
                device_total_ms=sum(by_stage.values()))


def chain_full_phase(dev) -> dict:
    """Phase 10 (a): llama3.2-3b at full width and depth trained down a
    4-stage ``LocalChain`` through ``repro_torch.launch.train``'s chain
    functions: a straggler replan, then a failure that shrinks the chain."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as cli
    from repro_torch.models import loss_fn
    from repro_torch.runtime import make_train_step
    from repro_torch.runtime.dlt_runner import LocalChain, make_dlt_train_step

    args = _chain_args(CHAIN_STEPS, dev, extra=("--fail", CHAIN_FAIL, "--straggle",
                                                 CHAIN_STRAGGLE))
    cfg, policy, tcfg = cli.build_cfg(args)
    state = cli.init_state(args, cfg, tcfg)
    n_params = sum(p.numel() for p in state.params.parameters())
    # the first super-step's loss, as one pass over its 8 samples would give it
    _, _, _, batches = _super_step_data(cfg, args, 0, CHAIN_STAGES)
    with torch.no_grad():
        single = float(loss_fn(state.params, cfg, policy, _concat(batches, dev))[0])
    _free()
    reset_launch_counts()
    log, state = cli.run_dlt_chain(args, cfg, policy, tcfg, state=state)
    counts = launch_counts()
    check(all(v == 0 for v in counts.values()), f"the chain's training launched kernels: {counts}")
    check([m["stages"] for m in log] == [4, 4, 3, 3], f"the chain shrank 4 -> 3: {log}")
    check(all(sum(map(sum, m["samples"])) == CHAIN_LOADS * TRAIN_B for m in log),
          f"every super-step's counts sum to loads x batch: {[m['samples'] for m in log]}")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in log),
          f"losses and grad norms finite: {log}")
    loss_err = abs(log[0]["loss"] - single) / abs(single)
    check(loss_err <= CHAIN_LOSS_RTOL,
          f"the chain's first loss {log[0]['loss']} against one pass {single}: {loss_err}")
    for m in log:
        progress(f"chain super-step {m['step']}: {m['stages']} stages, samples {m['samples']}, "
                 f"loss {m['loss']:.5f}, {m['time_s']:.3f} s, {m['tok_per_s']:.0f} tok/s, "
                 f"peak {m['peak_mem_gb']} GB")

    # one more super-step of the 4-stage chain and a phase-9 step (make_train_step)
    # on the same 8 samples, back to back; then the 4-stage step profiled
    toks, labs, cnt, batches = _super_step_data(cfg, args, 2 * CHAIN_STEPS, CHAIN_STAGES)
    chain_step = make_dlt_train_step(cfg, policy, tcfg, LocalChain(CHAIN_STAGES, dev), len(cnt))
    plain_step = make_train_step(cfg, policy, tcfg)
    walls = {}
    for name, fn in (("chain", lambda: chain_step(state, toks, labs, cnt)),
                     ("plain", lambda: plain_step(state, _concat(batches, dev)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = fn()
        float(m["loss"])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    _free()
    prof = _profiled_chain_step(cfg, policy, tcfg, state, args, 2 * CHAIN_STEPS + 2, dev)
    counts = launch_counts()
    check(all(v == 0 for v in counts.values()), f"the chain's training launched kernels: {counts}")
    del state
    _free()
    steps = [{k: m[k] for k in ("step", "stages", "samples", "loss", "lr", "grad_norm",
                                "tok_per_s", "peak_mem_gb", "makespan")}
             | {"wall_ms": 1e3 * m["time_s"]} for m in log]
    return dict(arch=cfg.name, params=n_params, dtype="float32", stages=CHAIN_STAGES,
                q=CHAIN_Q, loads=CHAIN_LOADS, batch=TRAIN_B, seq=TRAIN_SEQ, lr=TRAIN_LR,
                fail=CHAIN_FAIL, straggle=CHAIN_STRAGGLE, super_steps=steps,
                first_loss_single_pass=single, first_loss_rel_err=loss_err,
                chain_step_ms=1e3 * walls["chain"], plain_step_ms=1e3 * walls["plain"],
                profiled_step=prof, launches=counts)


def _dist_chain_worker(rank: int, world: int, init: str, out: str, device: str) -> None:
    """One stage of phase 10 (b)'s DistChain: a spawned process on the
    card, joined to the others over gloo; two chain steps of the 2-layer
    model, then its parameters held bitwise against rank 0's."""
    import dataclasses
    import os

    import torch.distributed as dist

    from repro_torch.config import get_arch
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import make_chain_mesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    try:
        args = _chain_args(2, device, stages=world)
        _, policy, tcfg = cli.build_cfg(args)
        cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=TRAIN_SMALL[0])
        group = make_chain_mesh(world, device)
        log, state = cli.run_dlt_chain(args, cfg, policy, tcfg, group=group)
        equal = True
        for p in state.params.parameters():
            x = p.detach().clone()
            dist.broadcast(x, 0)
            equal = equal and torch.equal(x, p.detach())
        flag = torch.tensor([0 if equal else 1])
        dist.all_reduce(flag)
        with open(f"{out}/rank{rank}.json", "w") as f:
            # the second step's times: the first pays each process's warm-up
            json.dump(dict(loss=log[0]["loss"], samples=log[0]["samples"],
                           backend=group.backend, staged=group.staged,
                           replicas_equal=int(flag) == 0,
                           steps=[{k: m[k] for k in ("loss", "time_s", "hop_s", "sum_s")}
                                  for m in log]), f)
    finally:
        dist.destroy_process_group()


def chain_small_phase(dev) -> dict:
    """Phase 10 (b): the same model with 2 layers: one chain step's
    gradients against ``make_train_step`` over the same samples, a failure
    restored from a checkpoint on the card, and a 2-process ``DistChain``
    on the one card against the ``LocalChain``."""
    import dataclasses
    import multiprocessing as mp
    import shutil

    from repro_torch.config import get_arch
    from repro_torch.launch import train as cli
    from repro_torch.models import init_params
    from repro_torch.runtime import make_train_state, make_train_step
    from repro_torch.runtime.dlt_runner import LocalChain, make_dlt_train_step

    L = TRAIN_SMALL[0]
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=L)
    args = _chain_args(2, dev)
    _, policy, tcfg = cli.build_cfg(args)

    # gradients: one chain step against one step over the samples concatenated
    toks, labs, cnt, batches = _super_step_data(cfg, args, 0, CHAIN_STAGES)
    chain = make_train_state(init_params(cfg, SEED, torch.float32, dev), tcfg)
    chain, m_chain = make_dlt_train_step(cfg, policy, tcfg, LocalChain(CHAIN_STAGES, dev),
                                         len(cnt))(chain, toks, labs, cnt)
    plain = make_train_state(init_params(cfg, SEED, torch.float32, dev), tcfg)
    plain, m_plain = make_train_step(cfg, policy, tcfg)(plain, _concat(batches, dev))
    want = _grads(plain)
    grad_err = max(float((g - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-30)
                   for n, g in _grads(chain).items())
    loss_err = abs(float(m_chain["loss"]) - float(m_plain["loss"])) / abs(float(m_plain["loss"]))
    del chain, plain, want
    _free()
    check(grad_err <= TRAIN_GRAD_TOL and loss_err <= CHAIN_LOSS_RTOL,
          f"chain step against one pass: gradients {grad_err}, loss {loss_err}")

    # a failure after 2 super-steps, restored from the checkpoint on the card
    # (the CLI's own path; the restore is watched, not changed)
    shutil.rmtree(CHAIN_CKPT_DIR, ignore_errors=True)
    fargs = _chain_args(2, dev, extra=("--fail", "1@step2", "--save-every", "2",
                                       "--ckpt-dir", str(CHAIN_CKPT_DIR)))
    restore, seen = cli.restore_checkpoint, {}

    def leaves(state) -> dict:
        return {**{"p/" + n: p.detach() for n, p in state.params.named_parameters()},
                **{"m/" + n: t for n, t in state.opt.m.items()},
                **{"v/" + n: t for n, t in state.opt.v.items()}}

    def watched(directory, step, target, device=None):
        before = {n: t.clone() for n, t in leaves(target).items()}
        opt_step = int(target.opt.step)
        t0 = time.perf_counter()
        out = restore(directory, step, target, device=device)
        torch.cuda.synchronize()
        seen["restore_s"] = time.perf_counter() - t0
        after = leaves(target)
        seen["exact"] = int(target.opt.step) == opt_step and all(
            torch.equal(before[n], after[n]) for n in before)
        seen["step"] = step
        return out

    cli.restore_checkpoint = watched
    try:
        flog, fstate = cli.run_dlt_chain(fargs, cfg, policy, tcfg)
    finally:
        cli.restore_checkpoint = restore
    ckpt_gb = sum(f.stat().st_size for f in CHAIN_CKPT_DIR.rglob("*") if f.is_file()) / 1e9
    shutil.rmtree(CHAIN_CKPT_DIR, ignore_errors=True)
    del fstate
    _free()
    check(seen.get("step") == 1 and seen.get("exact"),
          f"the failure restored checkpoint step 1 exactly: {seen}")

    # a DistChain of 2 processes on the one card (gloo, hops through host
    # memory) against the LocalChain of 2 stages, one step each
    shutil.rmtree(CHAIN_DIST_DIR, ignore_errors=True)
    CHAIN_DIST_DIR.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_chain_worker,
                         args=(r, 2, str(CHAIN_DIST_DIR / "rendezvous"), str(CHAIN_DIST_DIR),
                               str(dev)))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    dist_s = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"the DistChain processes ended: {[p.exitcode for p in procs]}")
    ranks = [json.loads((CHAIN_DIST_DIR / f"rank{r}.json").read_text()) for r in range(2)]
    shutil.rmtree(CHAIN_DIST_DIR, ignore_errors=True)
    largs = _chain_args(1, dev, stages=2)
    llog, lstate = cli.run_dlt_chain(largs, cfg, policy, tcfg)
    del lstate
    _free()
    dist_err = abs(ranks[0]["loss"] - llog[0]["loss"]) / abs(llog[0]["loss"])
    check(all(r["replicas_equal"] for r in ranks) and ranks[0]["loss"] == ranks[1]["loss"],
          f"the DistChain's replicas bitwise equal across ranks: {ranks}")
    check(ranks[0]["backend"] == "gloo" and ranks[0]["staged"],
          f"two ranks on one card: gloo, hops through host memory: {ranks[0]}")
    check(dist_err <= DIST_LOSS_RTOL and ranks[0]["samples"] == llog[0]["samples"],
          f"DistChain against LocalChain: loss {ranks[0]['loss']} vs {llog[0]['loss']}")
    return dict(layers=L, grad_err=grad_err, loss_err_vs_single_pass=loss_err,
                grad_tol=TRAIN_GRAD_TOL, restored_exact=seen["exact"],
                restored_step=seen["step"], restore_s=seen["restore_s"], ckpt_gb=ckpt_gb,
                failure_run=[{k: m[k] for k in ("step", "stages", "loss")} for m in flog],
                dist=dict(processes=2, wall_s=dist_s, local_loss=llog[0]["loss"],
                          local_step_ms=1e3 * llog[0]["time_s"], loss_rel_err=dist_err,
                          ranks=[r | {f"{k}_share": r["steps"][1][f"{k}_s"]
                                      / r["steps"][1]["time_s"] for k in ("hop", "sum")}
                                 for r in ranks]))


def chain_replan_phase(dev) -> dict:
    """Phase 10 (c): ``ChainReplanner`` on the card (the ``"cuda"``
    backend) over phase (a)'s chain: 256 straggler what-ifs in one bulk
    call, the auto-T sweep, a failure replan and a warm stream of 8 speed
    observations; every makespan against the port's serial solve."""
    import dataclasses

    from repro_torch.api import Policy, Session
    from repro_torch.core.planner import Planner
    from repro_torch.data import batch_load_spec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as cli
    from repro_torch.runtime.dlt_runner import ChainReplanner
    from repro_torch.runtime.replan import SpeedObserved

    args = _chain_args(CHAIN_STEPS, dev)
    cfg, _, _ = cli.build_cfg(args)
    loads = [batch_load_spec(cfg, args.batch, args.seq) for _ in range(CHAIN_LOADS)]
    planner, _ = cli.chain_planner(args, cfg, CHAIN_STAGES)
    rng = np.random.default_rng(SEED + 10)
    scales = np.ones((CHAIN_SCENARIOS, CHAIN_STAGES))
    scales[np.arange(CHAIN_SCENARIOS), rng.integers(0, CHAIN_STAGES, CHAIN_SCENARIOS)] = \
        1.0 / rng.uniform(1.1, 3.0, CHAIN_SCENARIOS)
    serial = Session(device="cpu")

    def serial_mk(problem, q=CHAIN_Q):
        return serial.solve(problem, Policy(installments=q, backend="serial")).makespan

    reset_launch_counts()
    t0 = time.perf_counter()
    rp = ChainReplanner(planner, q=CHAIN_Q, device=dev)
    mks = rp.what_if_speeds(loads, scales)
    what_if_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    auto = rp.auto_installments(loads, t_max=8)
    auto_s = time.perf_counter() - t0
    base = rp.planner
    t0 = time.perf_counter()
    failed = rp.on_failure(1, loads, restore_delay=1.0)
    failure_s = time.perf_counter() - t0
    stream = rp.stream(loads)
    arts = []
    t0 = time.perf_counter()
    for k in range(8):
        i = k % len(rp.planner.stages)
        arts.append(stream.apply(SpeedObserved(i, stream.problem.w[i] * (1 + 0.05 * (k + 1)))))
    stream_s = time.perf_counter() - t0
    stream.close()
    counts = launch_counts()

    worst = 0.0
    for sc, mk in zip(scales, mks):
        stages = [dataclasses.replace(s, flops_per_sec=s.flops_per_sec * f)
                  for s, f in zip(base.stages, sc)]
        want = serial_mk(Planner(stages, base.links).to_problem(loads))
        worst = max(worst, abs(mk - want) / want)
    for q, mk in auto.makespans.items():
        want = serial_mk(base.to_problem(loads), q)
        worst = max(worst, abs(mk - want) / want)
    want = serial_mk(rp.planner.to_problem(loads))
    worst = max(worst, abs(failed.makespan - want) / want)
    n_warm = 0
    for a in arts:
        check(a.ok, f"stream artifact {a.status}")
        n_warm += bool(a.events[-1]["warm"])
        want = serial_mk(a.problem)
        worst = max(worst, abs(a.makespan - want) / want)
    check(worst <= RTOL, f"ChainReplanner's makespans against the serial solve: {worst}")
    check(counts["simplex_pivot"] > 0 and counts["asap_replay"] > 0,
          f"the chain's replans launched the pivot and replay kernels: {counts}")
    progress(f"chain replanner: {CHAIN_SCENARIOS} what-ifs in {what_if_s:.3f} s, auto-T "
             f"{auto_s:.3f} s (T* {auto.t_star}), failure {failure_s:.3f} s, 8 events "
             f"{stream_s:.3f} s ({n_warm} warm); launches {counts}")
    return dict(scenarios=CHAIN_SCENARIOS, what_if_s=what_if_s, auto_t_s=auto_s,
                t_star=auto.t_star, failure_s=failure_s, stream_s=stream_s, stream_warm=n_warm,
                max_rel_diff_serial=worst, launches=counts,
                makespan_range=[float(mks.min()), float(mks.max())])


def chain_phase(dev) -> dict:
    """Phase 10, with the launch counts set to 0 just before each part and
    read just after: training runs no kernel; the replanner runs the pivot
    and replay kernels."""
    full = chain_full_phase(dev)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    small = chain_small_phase(dev)
    counts = launch_counts()
    check(all(v == 0 for v in counts.values()), f"phase 10 (b) launched kernels: {counts}")
    replan = chain_replan_phase(dev)
    emit(phase="chain", **full, small=small, replan=replan)
    return {"train_launches": {k: full["launches"][k] + counts[k] for k in counts},
            "replan_launches": replan["launches"],
            "super_step_ms": [m["wall_ms"] for m in full["super_steps"]],
            "chain_step_ms": full["chain_step_ms"], "plain_step_ms": full["plain_step_ms"]}


# ---------------------------------------------------------------- phase 11

SHARD_STEPS = 2  # phase 11 (a): steps of the sharded path against the unsharded one
SHARD_LOSS_RTOL = 1e-6
SHARD_CKPT_DIR = REPO / "build" / "chip_smoke_shard_ckpt"
MULTILOAD = (2, 3, 6, 8)  # torch_serve_multiload: smoke layers, batches, requests, tokens


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _whole_params(state) -> dict:
    from torch.distributed.tensor import DTensor

    return {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach().clone()
            for n, p in state.params.named_parameters()}


def _whole_state(state) -> dict:
    from torch.distributed.tensor import DTensor

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()

    return {"params": _whole_params(state), "m": {n: whole(t) for n, t in state.opt.m.items()},
            "v": {n: whole(t) for n, t in state.opt.v.items()}, "step": int(state.opt.step)}


def shard_small_phase(dev) -> dict:
    """Phase 11 (a): llama3.2-3b at full width with 2 layers through
    ``run_standard``'s sharded path on a 1-rank NCCL ``(1, 1)`` mesh, against
    the unsharded ``make_train_step`` from the same draws; then a sharded
    checkpoint round trip."""
    import dataclasses
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.config import get_arch
    from repro_torch.data import SyntheticStream
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.runtime import make_train_step
    from repro_torch.runtime.sharding import is_sharded

    import copy

    L, B, S = TRAIN_SMALL
    args = _train_args(SHARD_STEPS, B, S)
    _, policy, tcfg = cli.build_cfg(args)
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=L)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_data_mesh("cuda")
        check(tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model"),
              f"the data mesh: {mesh}")
        t0 = time.perf_counter()
        log, sharded = cli.run_standard(args, cfg, policy, tcfg)  # the group's mesh
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        check(is_sharded(sharded.params), "run_standard sharded the state over the group")
        state = cli.init_state(args, cfg, tcfg)  # unsharded, the same draws
        step = make_train_step(cfg, policy, tcfg)
        stream = SyntheticStream(cfg, args.batch, args.seq, seed=args.seed)
        single = []
        for _ in range(SHARD_STEPS):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
            state, m = step(state, batch)
            single.append((float(m["loss"]), float(m["grad_norm"])))
        rel = max(max(abs(a["loss"] - b[0]) / abs(b[0]), abs(a["grad_norm"] - b[1]) / abs(b[1]))
                  for a, b in zip(log, single))
        whole = _whole_params(sharded)
        worst, outside, total = 0.0, 0, 0
        for n, p in state.params.named_parameters():
            diff = (whole[n] - p.detach()).abs()
            worst = max(worst, float(diff.max()))
            outside += int((diff > MB_ATOL + MB_RTOL * p.detach().abs()).sum())
            total += p.numel()
        del state, whole
        check(rel <= SHARD_LOSS_RTOL and worst <= 2 * TRAIN_LR and outside <= total // 10_000,
              f"sharded against unsharded: loss/grad norm {rel}, parameters {worst} "
              f"({outside} of {total} outside the bar)")
        # the sharded checkpoint round trip
        shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
        saved = _whole_state(sharded)
        t0 = time.perf_counter()
        save_checkpoint(str(SHARD_CKPT_DIR), SHARD_STEPS - 1, sharded)
        save_s = time.perf_counter() - t0
        fresh_args = copy.copy(args)
        fresh_args.seed += 1
        fresh = cli.init_state(fresh_args, cfg, tcfg, mesh, policy)
        t0 = time.perf_counter()
        restore_checkpoint(str(SHARD_CKPT_DIR), SHARD_STEPS - 1, fresh, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        back = _whole_state(fresh)
        exact = back["step"] == saved["step"] and all(
            torch.equal(back[g][n], saved[g][n]) for g in ("params", "m", "v") for n in saved[g])
        ckpt_gb = sum(f.stat().st_size for f in SHARD_CKPT_DIR.rglob("*") if f.is_file()) / 1e9
        shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
        del sharded, fresh, saved, back
    finally:
        dist.destroy_process_group()
    _free()
    check(exact, "the sharded checkpoint restored exact")
    return dict(layers=L, batch=B, seq=S, steps=SHARD_STEPS, backend="nccl", mesh=[1, 1],
                sharded=[{k: m[k] for k in ("loss", "grad_norm")} | {"ms": 1e3 * m["time_s"]}
                         for m in log], sharded_run_s=sharded_s,
                single=[{"loss": a, "grad_norm": b} for a, b in single],
                loss_grad_norm_max_rel=rel, param_max_abs=worst, param_outside_bar=outside,
                ckpt_gb=ckpt_gb, ckpt_save_s=save_s, ckpt_restore_s=restore_s,
                ckpt_restored_exact=exact)


def _example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(dev) -> dict:
    """Phase 11 (b): the three examples on the card, the launch counts set
    to 0 just before each and read just after."""
    import dataclasses

    from repro_torch.api import Session
    from repro_torch.core.solver import solve
    from repro_torch.kernels import launch_counts, reset_launch_counts

    out, counts, walls = {}, {}, {}
    for name in ("torch_quickstart", "torch_serve_multiload", "torch_elastic_restart"):
        mod = _example(name)
        reset_launch_counts()
        t0 = time.perf_counter()
        out[name] = mod.main([])
        walls[name] = time.perf_counter() - t0
        counts[name] = launch_counts()
        progress(f"example {name}: {walls[name]:.1f} s, launches {counts[name]}")
    # quickstart: every engine solve on "cuda" against the port's serial solve
    serial = Session(device="cpu")
    worst = 0.0
    for what, problem, policy, got in out["torch_quickstart"]["solved"]:
        want = serial.solve(problem, dataclasses.replace(policy, backend="serial")).makespan
        worst = max(worst, abs(got - want) / abs(want))
    qs = counts["torch_quickstart"]
    check(worst <= RTOL and qs["simplex_pivot"] > 0 and qs["asap_replay"] > 0,
          f"quickstart on the card: makespans {worst} from serial, launches {qs}")
    # serve_multiload: the attention kernels' exact launches, the plan against serial
    layers, batches, _, gen = MULTILOAD
    sm, got = counts["torch_serve_multiload"], out["torch_serve_multiload"]
    want_counts = {"flash_attention": layers * batches, "decode_attention": layers * gen * batches}
    check(all(sm[k] == v for k, v in want_counts.items()) and sm["ssd_scan"] == 0,
          f"torch_serve_multiload launches {sm}, expected {want_counts}")
    plan_serial = solve(got["instance"]).makespan
    ml_err = abs(got["plan"] - plan_serial) / plan_serial
    check(ml_err <= RTOL and got["tokens"] == batches * MULTILOAD[2] * gen,
          f"torch_serve_multiload plan {got['plan']} against serial {plan_serial}")
    el = out["torch_elastic_restart"]
    check(el["restored_step"] == 3 and el["replans"] == 2 and el["losses"][-1] < el["losses"][0],
          f"torch_elastic_restart: {el['restored_step']}, {el['replans']}, {el['losses']}")
    return dict(walls_s=walls, launches=counts, quickstart_solves=len(
        out["torch_quickstart"]["solved"]), quickstart_max_rel_from_serial=worst,
        multiload_plan=got["plan"], multiload_plan_rel_from_serial=ml_err,
        multiload_serve_s=got["serve_s"], multiload_heads=got["heads"],
        elastic_plans=el["plans"], elastic_losses=el["losses"])


def sharding_phase(dev) -> dict:
    """Phase 11: (a) with every kernel's count at 0 throughout (training
    runs none), then (b)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    small = shard_small_phase(dev)
    counts = launch_counts()
    check(all(v == 0 for v in counts.values()), f"phase 11 (a) launched kernels: {counts}")
    examples = examples_phase(dev)
    emit(phase="sharding", small=small, examples=examples)
    return {"train_launches": counts, "examples_launches": examples["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs the card", file=sys.stderr)
        return 2
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
    for name, insts, lanes in (("chain", chain, None), ("star", star, None),
                               ("chain_ret_rel", chain_rr, 6)):
        (bucket,) = InstanceArena(insts).buckets
        piv[name] = pivot_phase(name, bucket, dev, lanes)
        progress(f"pivot kernel {name}: {json.dumps({k: v['ms'] for k, v in piv[name].items()})}")
    # the §6 buckets, m = 1, the chain bucket as the warm-hit path packs it
    # (ladder-padded to m 16, T 32) and the campaign's largest bucket shape
    # (64 chain instances with returns, m 8, 3 loads, q 4: T 12)
    from repro_torch.core.instance import random_instance

    rep = {}
    for name, insts, ladder in (
            ("chain", chain, False), ("star", star, False), ("chain_ret_rel", chain_rr, False),
            ("star_ret_rel", star_rr, False),
            ("m1", [random_instance(rng, m=1, n_loads=5, q=5) for _ in range(256)], False),
            ("chain_hit", chain, True),
            ("campaign", [random_instance(rng, m=8, n_loads=3, q=4, return_ratio=0.75)
                          for _ in range(64)], False)):
        (bucket,) = InstanceArena(insts, pad_shapes=ladder).buckets
        rep[name] = replay_phase(name, bucket, dev, rng)
        progress(f"replay kernel {name}: {rep[name]['ms']:.5f} ms")

    # phase 3: the main path, launch counts from these calls only
    groups = [("chain", chain, None), ("star", star, None), ("chain_ret_rel", chain_rr, None),
              ("star_ret_rel", star_rr, None), ("goldens", gold, gold_values)]
    cache = SolutionCache()
    launches, phase3 = bulk_phase(groups, dev, cache, "solve_bulk")
    # phase 4: every instance again, now a cache hit
    bulk_phase(groups, dev, cache, "warm_hits")
    del cache, groups
    torch.cuda.empty_cache()

    # phases 7 and 8: the planning service tier over phase 3's populations
    # (run here, while phase 3's results are at hand; numbered after the
    # serving phases they were added after)
    tier = {"replan": replan_phase(dev, chain, star, phase3),
            "plan_server": plan_server_phase(dev, chain, star, phase3)}
    del phase3
    torch.cuda.empty_cache()

    # phases 2 (attention and SSD kernels) and 5: the serving paths
    fa = flash_phase(dev)
    da = decode_phase(dev)
    flash_shard_phase(dev)  # the kernels' model-axis arguments (q_offset; kv_start, lse)
    decode_shard_phase(dev)
    ssd = ssd_phase(dev)
    rms, rms_launches = rmsnorm_phase(dev)
    torch.cuda.empty_cache()
    served = {k: 0 for k in ("flash_attention", "decode_attention", "ssd_scan")}
    for arch in SERVE_ARCHS + tuple(SERVE_VARIANTS):
        counts = serve_phase(dev, arch)
        for k in served:
            served[k] += counts[k]

    # phase 6: the planner's front door and the golden campaign
    campaign_phase(dev)

    # phase 9: training, after the serving models are freed
    _free()
    trained = train_phase(dev)
    # phase 10: the paper's chain (training down a chain of stages, replanning)
    _free()
    chained = chain_phase(dev)
    # phase 11: the sharded training path on a 1-rank mesh, and the examples
    _free()
    sharded = sharding_phase(dev)

    ex = sharded["examples_launches"]
    by_path = {k: {"solve_bulk (phase 3)": launches[k], "replan (phase 7)": tier["replan"][k],
                   "plan_server (phase 8)": tier["plan_server"][k],
                   "chain (phase 10)": chained["replan_launches"][k],
                   "torch_quickstart (phase 11)": ex["torch_quickstart"][k]}
               for k in ("simplex_pivot", "asap_replay")}
    p, r = piv["chain"]["set-up"], rep["chain"]
    f, d, m = fa["causal_f32"], da["len544_w0_float32"], ssd["mamba2_f32"]
    n = rms["llama_prefill_f32"]
    kernels = [
        dict(name="simplex_pivot", route="cuda", source="src/repro_torch/csrc/simplex_pivot.cu",
             replaces="src/repro/kernels/simplex_pivot.py:150", launches=launches["simplex_pivot"],
             max_abs_err=max(row["max_abs_err"] for t in piv for row in piv[t].values()),
             launches_by_path=by_path["simplex_pivot"],
             ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"],
             library_ms=None),
        dict(name="asap_replay", route="cuda", source="src/repro_torch/csrc/asap_replay.cu",
             replaces="src/repro/kernels/asap_replay.py:267", launches=launches["asap_replay"],
             max_abs_err=max(v["max_abs_err"] for v in rep.values()),
             launches_by_path=by_path["asap_replay"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=None),
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:106",
             launches=served["flash_attention"],
             max_abs_err=max(v["max_abs_err"] for v in fa.values()),
             ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"], bound_by=f["bound_by"],
             library_ms=f["library_ms"],
             head_dim_256={"float32": fa["paligemma_causal_f32"],
                           "bfloat16": fa["paligemma_causal_bf16"]},
             head_dim_112={"float32": fa["kimi_causal_f32"],
                           "bfloat16": fa["kimi_causal_bf16"]},
             head_dim_72={"float32": fa["siglip_causal_f32"],
                          "bfloat16": fa["siglip_causal_bf16"]},
             head_dim_100={"float32": fa["d100_causal_f32"],
                           "bfloat16": fa["d100_causal_bf16"]},
             head_dim_192={"float32": fa["d192_causal_f32"],
                           "bfloat16": fa["d192_causal_bf16"]}),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:105",
             launches=served["decode_attention"],
             max_abs_err=max(v["max_abs_err"] for v in da.values()),
             ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["bound_ms"], bound_by=d["bound_by"],
             library_ms=d["library_ms"],
             head_dim_256={"float32": da["paligemma_len544_w0_float32"],
                           "bfloat16": da["paligemma_len544_w0_bfloat16"]},
             head_dim_112={"float32": da["kimi_len544_w0_float32"],
                           "bfloat16": da["kimi_len544_w0_bfloat16"]},
             head_dim_72={"float32": da["siglip_len544_w0_float32"],
                          "bfloat16": da["siglip_len544_w0_bfloat16"]},
             head_dim_100={"float32": da["d100_len544_w0_float32"],
                           "bfloat16": da["d100_len544_w0_bfloat16"]},
             head_dim_192={"float32": da["d192_len544_w0_float32"],
                           "bfloat16": da["d192_len544_w0_bfloat16"]}),
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:90", launches=served["ssd_scan"],
             max_abs_err=max(v["max_abs_err"] for v in ssd.values()),
             ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
             library_ms=None,
             **{f"{shape}": {"float32": ssd[f"{shape}_f32"], "bfloat16": ssd[f"{shape}_bf16"]}
                for shape in ("p48n80", "p64n256", "chunk4096", "prime4099")}),
        dict(name="rms_norm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:37", launches=rms_launches,
             launches_from="phase 2 (its checks and timed calls): no path of the port calls "
                           "rms_norm, as no path of the reference calls its kernel",
             max_abs_err=max(v["max_abs_err"] for v in rms.values()),
             ms=n["ms"], plain_ms=n["plain_ms"], bound_ms=n["bound_ms"], bound_by=n["bound_by"],
             library_ms=n["library_ms"]),
    ]
    for k in kernels:
        k["train_launches"] = trained["launches"][k["name"]]
        k["chain_train_launches"] = chained["train_launches"][k["name"]]
        k["sharded_train_launches"] = sharded["train_launches"][k["name"]]
        k["examples_launches"] = {name: c[k["name"]] for name, c in ex.items()}
    print(json.dumps({"train": trained}))
    print(json.dumps({"chain": chained}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
