"""Tensor parallelism (a model axis wider than 1) over every rank of a
``torchrun`` world: the dense family's cells (``launch/specs.build_cell``)
on ``(data, model)`` meshes, held against one card.

    torchrun --nproc-per-node 4 scripts/tp_dist.py                   # 4 cards: NCCL
    PYTHONPATH=src torchrun --nproc-per-node 4 scripts/tp_dist.py --device cpu --smoke \\
        --seq 32 --prompt 32 --gen 4 --check-batch 4 --serve-batch 2 --lr 1e-3  # the CPU: gloo

(i) ``--check-arch`` (llama3.2-3b) at full width and depth in float32: the
train cell's step on each of ``--meshes`` (``1x4`` and ``2x2``: data x
model), ``--check-steps`` steps of the global batch ``--check-batch`` x
``--seq`` from the synthetic stream (each data rank its rows), then rank 0
alone, unsharded, on the same batches from the same seed: the losses and
grad norms within 1e-5 relative, the parameters within C.18's bar (all
within 2 lr; at most 1 element in 10^4 beyond rtol 2e-3 / atol 2e-4).
Recorded a mesh: ms a step, peak GB a rank, and one more step under
``CommDebugMode`` (the collectives by op, with their bytes).
(ii) ``--serve-arch`` (mistral-large-123b) at full width and depth in
bfloat16 on ``(1, N)``: the weights drawn sharded (``init_sharded``: no
rank holds more than a layer whole), the prefill cell on ``--serve-batch``
x ``--prompt`` tokens, then ``--gen`` greedy decode-cell steps against a
cache of prompt + gen entries.  Recorded: prefill s, decode ms a step,
peak GB a rank, the collectives of a prefill and of a decode step, and the
profiler's busy share of each.
(iii) ``--serve-arch`` cut to ``--check-layers`` layers at full width in
float32: the prefill and decode cells on ``(1, N)`` against the same layers
unsharded on rank 0 (the same draws): logits and caches within 1e-4 of
their max |value|.
Rank 0 prints one JSON line (also written to ``--out``) with the cards'
name and power limit, and exits non-zero on a missed bar.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.config import (ShapeConfig, ShardingPolicy, TrainConfig, get_arch,  # noqa: E402
                                smoke_variant)
from repro_torch.data import SyntheticStream, make_batch  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.models import (decode_step, extend_cache, greedy_tokens,  # noqa: E402
                                init_params, prefill)
from repro_torch.runtime import make_train_state, make_train_step  # noqa: E402
from repro_torch.runtime.profile import CommBytes, busy_ms, device_time_by_group  # noqa: E402
from repro_torch.runtime.sharding import init_sharded, shard_model  # noqa: E402

LOSS_RTOL = 1e-5
SERVE_TOL = 1e-4


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _release(dev):
    """Free a dropped sharded state (FSDP's hooks hold the model in a
    reference cycle, so only the collector returns its memory)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _peak_reset(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gb(dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


def _gather(x):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def _whole(model, lead: bool) -> dict:
    """Every parameter whole on rank 0's host (a gather a leaf)."""
    out = {}
    for n, p in model.named_parameters():
        t = p.full_tensor() if isinstance(p, DTensor) else p
        if lead:
            out[n] = t.detach().to("cpu", copy=True)
    return out


def _cfg(opts, arch: str, layers: int | None = None):
    cfg = get_arch(arch)
    if opts.smoke:
        cfg = smoke_variant(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def _profiled(fn, dev) -> dict | None:
    """One call of ``fn`` under torch.profiler: its wall, the device's busy
    share of it and its device ms by group (NCCL's kernels apart: they
    spin on the device while a rank waits for the others), the host's
    operator calls."""
    if dev.type != "cuda":
        return None
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    busy = busy_ms(prof)
    groups, n_ops = device_time_by_group(prof)
    host_ops = sum(1 for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA
                   and e.name.startswith("aten::") and e.cpu_parent is None)
    return dict(wall_ms=1e3 * wall, busy_ms=busy, busy_share=busy / 1e3 / wall,
                device_ms=groups, device_ops=n_ops, host_top_level_aten_ops=host_ops)


def _train_check(opts, dev, rank) -> dict:
    """Part (i): the train cell on each mesh against rank 0 unsharded."""
    cfg = _cfg(opts, opts.check_arch)
    policy = ShardingPolicy(attn_chunk=min(1024, opts.seq))
    tcfg = TrainConfig(lr=opts.lr, warmup_steps=0, total_steps=opts.check_steps + 1)
    shape = ShapeConfig("train", opts.seq, opts.check_batch, "train")
    world = dist.get_world_size()
    runs = {}
    for spec in opts.meshes.split(","):
        data, model_ax = map(int, spec.split("x"))
        if data * model_ax != world:
            raise SystemExit(f"mesh {spec} is not a world of {world}")
        mesh = init_device_mesh(dev.type, (data, model_ax), mesh_dim_names=("data", "model"))
        _peak_reset(dev)
        t0 = time.perf_counter()
        model = init_sharded(cfg, mesh, seed=0, dtype=torch.float32, device=dev, policy=policy)
        state = make_train_state(shard_model(model.requires_grad_(True), mesh, policy), tcfg)
        _sync(dev)
        init_s = time.perf_counter() - t0
        cell = build_cell(mesh, cfg, shape, policy, tcfg, torch.float32)
        d = mesh.get_local_rank("data")
        rows = slice(d * opts.check_batch // data, (d + 1) * opts.check_batch // data)
        stream = SyntheticStream(cfg, opts.check_batch, opts.seq, seed=0)
        steps = []
        for _ in range(opts.check_steps):
            batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in next(stream).items()}
            _sync(dev)
            t0 = time.perf_counter()
            state, m = cell.fn(state, batch)
            loss = float(m["loss"])  # waits for the step
            steps.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                          "ms": 1e3 * (time.perf_counter() - t0)})
        after = _whole(state.params, rank == 0)
        batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in next(stream).items()}
        comm = CommBytes()
        with comm:
            state, _ = cell.fn(state, batch)
            _sync(dev)
        runs[spec] = dict(steps=steps, init_s=init_s, peak_gb_by_rank=_gather(_peak_gb(dev)),
                          collectives_per_step=comm.counts(), after=after)
        del state, model, cell
        _release(dev)
    out = None
    if rank == 0:
        _peak_reset(dev)
        state = make_train_state(init_params(cfg, seed=0, dtype=torch.float32, device=dev)
                                 .requires_grad_(True), tcfg)
        step = make_train_step(cfg, policy, tcfg)
        stream = SyntheticStream(cfg, opts.check_batch, opts.seq, seed=0)
        single = []
        for _ in range(opts.check_steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            single.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                           "ms": 1e3 * (time.perf_counter() - t0)})
        want = {n: p.detach().cpu() for n, p in state.params.named_parameters()}
        single_peak = _peak_gb(dev)
        del state
        _release(dev)
        ok = True
        for spec, run in runs.items():
            rel = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(run["steps"], single))
                   for k in ("loss", "grad_norm")}
            worst, outside, total = 0.0, 0, 0
            for n, w in want.items():
                diff = (run["after"][n] - w).abs()
                worst = max(worst, float(diff.max()))
                outside += int((diff > 2e-4 + 2e-3 * w.abs()).sum())
                total += w.numel()
            run.pop("after")
            run.update(rel_diff=rel, param_max_abs=worst, param_outside_bar=outside,
                       param_total=total,
                       ok=(max(rel.values()) <= LOSS_RTOL and worst <= 2 * opts.lr
                           and outside <= total // 10_000))
            ok = ok and run["ok"]
        out = dict(arch=cfg.name, dtype="float32", global_batch=opts.check_batch, seq=opts.seq,
                   lr=opts.lr, meshes=runs, single=single, single_peak_gb=single_peak, ok=ok)
    dist.barrier()
    return out


def _serve_run(cfg, mesh, policy, model, toks, gen: int, dev, record: bool):
    """The prefill cell, then ``gen`` greedy decode-cell steps on a cache of
    prompt + gen entries; the logits of each and the final cache (full
    tensors), and with ``record`` the times, collectives and profiles."""
    B, S = toks.shape
    pre = build_cell(mesh, cfg, ShapeConfig("prefill", S, B, "prefill"), policy,
                     param_dtype=model.embed.dtype)
    dec = build_cell(mesh, cfg, ShapeConfig("decode", S + gen, B, "decode"), policy,
                     param_dtype=model.embed.dtype)
    rec: dict = {}
    _sync(dev)
    t0 = time.perf_counter()
    lg, cache = pre.fn(model, {"tokens": toks})
    nxt = greedy_tokens(lg[:, -1:])
    _sync(dev)
    rec["prefill_s"] = time.perf_counter() - t0
    logits = [lg.full_tensor() if isinstance(lg, DTensor) else lg]
    cache = extend_cache(cfg, cache, S + gen)
    tokens, walls = [nxt], []
    for i in range(gen):
        n = torch.tensor([S + i], dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        lg, cache = dec.fn(model, cache, {"tokens": nxt}, n)
        nxt = greedy_tokens(lg[:, -1:])
        _sync(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
        logits.append(lg.full_tensor() if isinstance(lg, DTensor) else lg)
        tokens.append(nxt)
    rec["decode_ms"] = walls
    rec["decode_ms_median"] = sorted(walls[1:] or walls)[len(walls[1:] or walls) // 2]
    rec["tokens"] = torch.cat(tokens, dim=1).cpu().tolist()
    if record:  # one more prefill and last decode step, counted, then profiled
        last = torch.tensor([S + gen - 1], dtype=torch.int32, device=dev)
        for name, fn in (("prefill", lambda: pre.fn(model, {"tokens": toks})),
                         ("decode", lambda: dec.fn(model, cache, {"tokens": nxt}, last))):
            comm = CommBytes()
            with comm:
                fn()
                _sync(dev)
            rec[f"{name}_collectives"] = comm.counts()
            rec[f"{name}_profile"] = _profiled(fn, dev)
    full = {k: (t.full_tensor() if isinstance(t, DTensor) else t) for k, t in cache.items()}
    return logits, full, rec


def _serve(opts, dev, rank) -> dict:
    """Part (ii): the serve arch at full size, bfloat16, on (1, N)."""
    cfg = _cfg(opts, opts.serve_arch)
    policy = ShardingPolicy(attn_chunk=min(1024, opts.prompt))
    world = dist.get_world_size()
    mesh = init_device_mesh(dev.type, (1, world), mesh_dim_names=("data", "model"))
    _peak_reset(dev)
    _sync(dev)
    t0 = time.perf_counter()
    model = init_sharded(cfg, mesh, seed=0, dtype=torch.bfloat16, device=dev, policy=policy)
    _sync(dev)
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.to_local().numel() * p.element_size() for p in model.parameters()) / 1e9
    init_peak = _peak_gb(dev)
    toks = torch.from_numpy(make_batch(cfg, opts.serve_batch, opts.prompt, step=0)["tokens"]).to(dev)
    _peak_reset(dev)
    logits, cache, rec = _serve_run(cfg, mesh, policy, model, toks, opts.gen, dev, record=True)
    finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
    rec.update(arch=cfg.name, dtype="bfloat16", mesh=f"1x{world}", batch=opts.serve_batch,
               prompt=opts.prompt, gen=opts.gen, cache_entries=opts.prompt + opts.gen,
               init_s=init_s, weights_gb_a_rank=weights_gb, init_peak_gb=init_peak,
               serve_peak_gb_by_rank=_gather(_peak_gb(dev)),
               logits_shape=list(logits[0].shape), finite=finite,
               ok=finite and list(logits[0].shape) == [opts.serve_batch, opts.prompt,
                                                       cfg.vocab_size])
    del model, cache, logits
    _release(dev)
    return rec if rank == 0 else None


def _serve_check(opts, dev, rank) -> dict:
    """Part (iii): the serve arch cut to a few layers, float32, sharded on
    (1, N) against the same layers unsharded on rank 0."""
    cfg = _cfg(opts, opts.serve_arch, opts.check_layers)
    policy = ShardingPolicy(attn_chunk=min(1024, opts.prompt))
    world = dist.get_world_size()
    mesh = init_device_mesh(dev.type, (1, world), mesh_dim_names=("data", "model"))
    model = init_sharded(cfg, mesh, seed=1, dtype=torch.float32, device=dev, policy=policy)
    toks = torch.from_numpy(make_batch(cfg, opts.serve_batch, opts.prompt, step=1)["tokens"]).to(dev)
    logits, cache, rec = _serve_run(cfg, mesh, policy, model, toks, opts.check_gen, dev,
                                    record=False)
    del model
    _release(dev)
    out = None
    if rank == 0:
        base = init_params(cfg, seed=1, dtype=torch.float32, device=dev)
        lg, c, pos = prefill(base, cfg, policy, toks, max_len=opts.prompt + opts.check_gen)
        want, nxt = [lg], greedy_tokens(lg[:, -1:])
        for i in range(opts.check_gen):
            lg, c = decode_step(base, cfg, policy, c, nxt, pos + i)
            want.append(lg)
            nxt = greedy_tokens(lg[:, -1:])
        errs = {"logits": max(float((a - b).abs().max() / b.abs().max())
                              for a, b in zip(logits, want))}
        for k in ("k", "v"):
            errs[k] = float((cache[k] - c[k]).abs().max() / c[k].abs().max())
        out = dict(arch=cfg.name, layers=opts.check_layers, dtype="float32", mesh=f"1x{world}",
                   batch=opts.serve_batch, prompt=opts.prompt, gen=opts.check_gen,
                   rel_err=errs, ok=max(errs.values()) <= SERVE_TOL)
        del base, c
        _release(dev)
    dist.barrier()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke variants")
    ap.add_argument("--check-arch", default="llama3.2-3b")
    ap.add_argument("--meshes", default="1x4,2x2", help="data x model meshes of part (i)")
    ap.add_argument("--check-batch", type=int, default=8, help="global rows in part (i)")
    ap.add_argument("--check-steps", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--serve-arch", default="mistral-large-123b")
    ap.add_argument("--serve-batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--check-layers", type=int, default=2)
    ap.add_argument("--check-gen", type=int, default=4)
    ap.add_argument("--parts", default="train,serve,check", help="which of (i)-(iii) to run")
    ap.add_argument("--out", default=str(REPO / "build" / "tp_dist.json"))
    opts = ap.parse_args(argv)
    args = cli.parse_args(["--arch", opts.check_arch,
                           *(["--device", opts.device] if opts.device else [])])
    backend = cli.init_data_group(args)
    if backend is None:
        raise SystemExit("run under torchrun with more than one process")
    dev = torch.device(args.device)
    rank = dist.get_rank()
    parts = set(opts.parts.split(","))
    t0 = time.perf_counter()
    rec = {}
    if "train" in parts:
        rec["train"] = _train_check(opts, dev, rank)
        _release(dev)
    if "check" in parts:
        rec["serve_check"] = _serve_check(opts, dev, rank)
        _release(dev)
    if "serve" in parts:
        rec["serve"] = _serve(opts, dev, rank)
    ok = True
    if rank == 0:
        card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()
                if dev.type == "cuda" else ["cpu"])
        rec.update(cards=card, backend=backend, torch=torch.__version__,
                   world=dist.get_world_size(), wall_s=time.perf_counter() - t0)
        line = json.dumps(rec)
        os.makedirs(os.path.dirname(opts.out), exist_ok=True)
        with open(opts.out, "w") as f:
            f.write(line + "\n")
        print(line, flush=True)
        ok = all(part["ok"] for key, part in rec.items()
                 if key in ("train", "serve", "serve_check"))
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
