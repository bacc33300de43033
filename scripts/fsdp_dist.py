"""Train with FSDP over every rank of a ``torchrun`` world through the
training CLI's standard mode, and hold it against one card.

    torchrun --nproc-per-node 4 scripts/fsdp_dist.py                 # 4 cards: NCCL
    PYTHONPATH=src torchrun --nproc-per-node 4 scripts/fsdp_dist.py \\
        --device cpu --smoke                                         # the CPU: gloo

(i) ``--arch`` (minitron-8b) at full width and depth in float32, sharded
over a ``(data=N, model=1)`` mesh (``repro_torch.launch.train``'s
``init_state`` and ``run_standard``: remat per block, chunked attention):
``--steps`` steps of ``--batch`` x ``--seq`` tokens a rank from the
synthetic stream, each step's loss, grad norm and wall (the loss read back
after the step: synchronised), tokens/s, the peak memory of every rank; one
more step under ``torch.profiler`` (device ms of the matrix products,
attention, the optimizer, the collectives and the rest; the busy share),
and one under ``CommDebugMode`` (the collectives a step, by op, with the
bytes of the whole tensors they gather, scatter or reduce).
(ii) ``--check-arch`` (llama3.2-3b) at full width and depth, sharded over
the N ranks, ``--check-steps`` steps of the global batch ``--check-batch`` x
``--seq``, then rank 0 alone, unsharded, on the same batches from the same
seed: the losses and grad norms within 1e-5 relative, the parameters within
C.18's bar (all within 2 lr; at most 1 element in 10^4 beyond rtol 2e-3 /
atol 2e-4).  Rank 0 prints one JSON line (also written to ``--out``) with
the cards' name and power limit, and exits non-zero if (ii) misses a bar or
(i)'s loss does not fall.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.config import smoke_variant  # noqa: E402
from repro_torch.data import SyntheticStream  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.mesh import make_data_mesh  # noqa: E402
from repro_torch.runtime import make_train_step  # noqa: E402
from repro_torch.runtime.profile import CommBytes, profile_train_step  # noqa: E402

LOSS_RTOL = 1e-5


def _args(opts, arch: str, batch: int, steps: int):
    return cli.parse_args(["--arch", arch, "--steps", str(steps), "--batch", str(batch),
                           "--seq", str(opts.seq), "--lr", str(opts.lr), "--seed", "0",
                           *(["--device", opts.device] if opts.device else [])])


def _cfg(opts, args):
    cfg, policy, tcfg = cli.build_cfg(args)
    return (smoke_variant(cfg) if opts.smoke else cfg), policy, tcfg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _release(dev):
    """Free a dropped sharded state: FSDP's hooks hold the model in a
    reference cycle, so only the collector returns its memory."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _profiled(cfg, policy, tcfg, state, batch, dev) -> dict:
    """One step under torch.profiler, grouped as ``chip_smoke.py`` groups
    phase 9's (the same scopes), the NCCL kernels apart."""
    return profile_train_step(cfg, policy, tcfg, state, batch) if dev.type == "cuda" else None


def _big(opts, dev, world, rank) -> dict:
    """Part (i): the large model, sharded."""
    args = _args(opts, opts.arch, opts.batch * world, opts.steps)
    args.device = str(dev)
    cfg, policy, tcfg = _cfg(opts, args)
    mesh = make_data_mesh(dev.type)
    _sync(dev)
    t0 = time.perf_counter()
    state = cli.init_state(args, cfg, tcfg, mesh, policy)
    _sync(dev)
    init_s = time.perf_counter() - t0
    local_bytes = sum((p.to_local() if isinstance(p, DTensor) else p).numel() * 4
                      for p in state.params.parameters())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log, state = cli.run_standard(args, cfg, policy, tcfg, state=state, mesh=mesh)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    # one more global batch, this rank's rows, for the profiled and the counted steps
    stream = SyntheticStream(cfg, args.batch, args.seq, seed=args.seed, step=args.steps)
    rows = slice(rank * opts.batch, (rank + 1) * opts.batch)
    batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in next(stream).items()}
    prof = _profiled(cfg, policy, tcfg, state, batch, dev)
    step = make_train_step(cfg, policy, tcfg)
    comm = CommBytes()
    with comm:
        state, _ = step(state, batch)
        _sync(dev)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    del state, step
    _release(dev)
    peaks = [None] * world
    dist.all_gather_object(peaks, peak)
    walls = [m["time_s"] for m in log]
    steady = sorted(walls[1:])[len(walls[1:]) // 2] if len(walls) > 1 else walls[0]
    return dict(arch=cfg.name, dtype="float32", world=world, batch_per_rank=opts.batch,
                seq=opts.seq, remat=policy.remat, attn_chunk=policy.attn_chunk, lr=opts.lr,
                init_s=init_s, local_param_gb=local_bytes / 1e9,
                params=int(cli.param_counts(cfg).total),
                steps=[{k: m[k] for k in ("step", "loss", "lr", "grad_norm")}
                       | {"ms": 1e3 * m["time_s"]} for m in log],
                step_ms_median=1e3 * steady, tok_per_s=world * opts.batch * opts.seq / steady,
                peak_gb_by_rank=peaks, profiled_step=prof, collectives_per_step=counts,
                collective_bytes_per_step={k: int(v) for k, v in comm.bytes.items()},
                loss_falls=log[-1]["loss"] < log[0]["loss"])


def _whole(state, lead: bool) -> dict:
    """Every parameter whole on rank 0's host (a gather a leaf)."""
    out = {}
    for n, p in state.params.named_parameters():
        t = p.full_tensor() if isinstance(p, DTensor) else p
        if lead:
            out[n] = t.detach().to("cpu", copy=True)
    return out


def _check(opts, dev, world, rank) -> dict:
    """Part (ii): the check model sharded over the world against one card."""
    args = _args(opts, opts.check_arch, opts.check_batch, opts.check_steps)
    args.device = str(dev)
    cfg, policy, tcfg = _cfg(opts, args)
    log, state = cli.run_standard(args, cfg, policy, tcfg, mesh=make_data_mesh(dev.type))
    sharded = _whole(state, rank == 0)
    del state
    _release(dev)
    out = None
    if rank == 0:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        state = cli.init_state(args, cfg, tcfg)  # unsharded, the same draws
        step = make_train_step(cfg, policy, tcfg)
        stream = SyntheticStream(cfg, args.batch, args.seq, seed=args.seed)
        single = []
        for _ in range(args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
            t0 = time.perf_counter()
            state, m = step(state, batch)
            single.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                           "ms": 1e3 * (time.perf_counter() - t0)})
        rel = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(log, single))
               for k in ("loss", "grad_norm")}
        worst, outside, total = 0.0, 0, 0
        for n, p in state.params.named_parameters():
            w = p.detach().cpu()
            diff = (sharded[n] - w).abs()
            worst = max(worst, float(diff.max()))
            outside += int((diff > 2e-4 + 2e-3 * w.abs()).sum())
            total += w.numel()
        single_peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
        del state
        out = dict(arch=cfg.name, world=world, global_batch=opts.check_batch, seq=opts.seq,
                   single_peak_gb=single_peak,
                   steps=opts.check_steps, lr=opts.lr,
                   sharded=[{k: m[k] for k in ("loss", "grad_norm")} | {"ms": 1e3 * m["time_s"]}
                            for m in log],
                   single=single, rel_diff=rel, param_max_abs=worst,
                   param_outside_bar=outside, param_total=total,
                   ok=(max(rel.values()) <= LOSS_RTOL and worst <= 2 * opts.lr
                       and outside <= total // 10_000))
    dist.barrier()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke variants")
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--batch", type=int, default=4, help="rows a rank in part (i)")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--check-arch", default="llama3.2-3b")
    ap.add_argument("--check-batch", type=int, default=8, help="global rows in part (ii)")
    ap.add_argument("--check-steps", type=int, default=2)
    ap.add_argument("--out", default=str(REPO / "build" / "fsdp_dist.json"))
    opts = ap.parse_args(argv)
    args = _args(opts, opts.arch, opts.batch, opts.steps)
    backend = cli.init_data_group(args)
    if backend is None:
        raise SystemExit("run under torchrun with more than one process")
    dev = torch.device(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    big = _big(opts, dev, world, rank)
    _release(dev)
    check = _check(opts, dev, world, rank)
    ok = True
    if rank == 0:
        card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()
                if dev.type == "cuda" else ["cpu"])
        rec = dict(cards=card, backend=backend, torch=torch.__version__, big=big, check=check,
                   wall_s=time.perf_counter() - t0)
        line = json.dumps(rec)
        os.makedirs(os.path.dirname(opts.out), exist_ok=True)
        with open(opts.out, "w") as f:
            f.write(line + "\n")
        print(line, flush=True)
        ok = check["ok"] and big["loss_falls"]
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
