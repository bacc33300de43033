"""Training entry point of the port: AdamW steps of a decoder LM of any
family on the CUDA card unless ``--device cpu`` is given.

The port of the reference's training driver (``repro.launch.train``),
standard mode: float32 weights drawn from ``--seed`` on the device, the
deterministic synthetic stream (``repro_torch.data.SyntheticStream``), one
train step a batch (``repro_torch.runtime.make_train_step``: microbatch
accumulation, global-norm clipping, a cosine schedule), checkpoints every
``--save-every`` steps in the reference's format, and ``--resume`` from the
latest.  Attention trains through the plain ``"chunked"`` path, as the
reference's driver fixes it: no kernel of the port has a backward.

It runs on one card.  Data parallelism over several cards comes with the
sharding slice (ROADMAP A.15), and so does the reference's ``--dlt-chain``
mode (the paper's chain of stages); ``--dlt-chain`` is refused here.

  python -m repro_torch.launch.train --arch llama3.2-3b --steps 4 \\
      --batch 4 --seq 512                          # on the card, full size
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --device cpu --steps 20 --ckpt-dir /tmp/ck --save-every 5
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import resolve_device
from repro_torch.data import SyntheticStream
from repro_torch.models import init_params, param_counts
from repro_torch.runtime import make_train_state, make_train_step

__all__ = ["parse_args", "build_cfg", "init_state", "run_standard", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: one card, which must be present) or 'cpu'")
    ap.add_argument("--dlt-chain", type=int, default=0,
                    help="the reference's chain runner over N stages: not in the port yet "
                         "(ROADMAP A.15); refused")
    ap.add_argument("--metrics-out", default=None)
    return ap.parse_args(argv)


def build_cfg(args):
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    policy = ShardingPolicy(attention_impl="chunked", attn_chunk=min(1024, args.seq))
    tcfg = TrainConfig(lr=args.lr, warmup_steps=min(10, args.steps // 10),
                       total_steps=args.steps, microbatches=args.microbatches,
                       seed=args.seed)
    return cfg, policy, tcfg


def init_state(args, cfg, tcfg):
    """Float32 weights drawn from ``--seed`` on ``--device`` and zeroed AdamW
    moments: the state a run starts from."""
    model = init_params(cfg, seed=args.seed, dtype=torch.float32, device=args.device)
    return make_train_state(model, tcfg)


def run_standard(args, cfg, policy, tcfg, state=None):
    """Train from step 0 (or the latest checkpoint with ``--resume``) to
    ``--steps``.  Returns (the metrics of each step, the final state);
    ``state`` replaces :func:`init_state`'s."""
    dev = resolve_device(args.device)
    state = init_state(args, cfg, tcfg) if state is None else state
    step_fn = make_train_step(cfg, policy, tcfg)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if args.resume and args.ckpt_dir and (ls := latest_step(args.ckpt_dir)) is not None:
        state, _ = restore_checkpoint(args.ckpt_dir, ls, state, device=dev)
        start = ls + 1
        print(f"resumed from step {ls}")
    stream = SyntheticStream(cfg, args.batch, args.seq, seed=args.seed, step=start)
    metrics_log = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.time() - t0
        lr = float(metrics["lr"])
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} lr {lr:.2e} {dt*1e3:.0f}ms")
        metrics_log.append({"step": step, "loss": loss, "time_s": dt, "lr": lr,
                            "grad_norm": float(metrics["grad_norm"])})
        if mgr and (step + 1) % args.save_every == 0:
            mgr.save_async(step, state)
    if mgr:
        mgr.wait()
    return metrics_log, state


def main(argv=None):
    args = parse_args(argv)
    if args.dlt_chain:
        raise SystemExit(f"--dlt-chain {args.dlt_chain}: the chain runner (the reference's "
                         "dlt_runner over shard_map) is not in the port yet; it comes with "
                         "ROADMAP A.15")
    cfg, policy, tcfg = build_cfg(args)
    resolve_device(args.device)
    pc = param_counts(cfg)
    print(f"arch={cfg.name} params={pc.total/1e6:.1f}M active={pc.active/1e6:.1f}M "
          f"devices=1")
    log, _ = run_standard(args, cfg, policy, tcfg)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(log, f, indent=1)
    losses = [m["loss"] for m in log]
    print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
