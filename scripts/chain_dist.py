"""Run the chain of ``repro_torch.launch.train --dlt-chain`` one process a
stage, and hold it against the same chain in one process.

    torchrun --nproc-per-node 4 scripts/chain_dist.py               # 4 cards: NCCL
    PYTHONPATH=src torchrun --nproc-per-node 4 scripts/chain_dist.py \\
        --device cpu --smoke                                        # the CPU: gloo

Every rank runs ``run_dlt_chain`` on llama3.2-3b at full width with
``--layers`` layers (or the smoke variant), 2 loads of ``--batch`` x
``--seq`` tokens a super-step in 2 installments, ``--steps`` super-steps,
stage 3 straggling (x2) from step 1 and stage 1 lost at step 2 (the chain
shrinks to 3 and the last rank leaves; no checkpoint, so the survivors keep
their replicas).  Then rank 0's parameters are broadcast and every rank
that stayed compares its own with them bit for bit, and rank 0 runs the
same chain as a ``LocalChain`` on its device.  Rank 0 prints one JSON line:
the device, the backend, each super-step's loss, wall and the host seconds
in hops and in the all-reduce on every rank, whether the replicas are
bitwise equal, and the largest relative difference of a super-step's loss
from the ``LocalChain``'s.  Exits non-zero if the replicas differ or a loss
is more than 1e-5 relative from the ``LocalChain``'s.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.config import get_arch, smoke_variant  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.runtime.dlt_runner import LocalChain  # noqa: E402

LOSS_RTOL = 1e-5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--smoke", action="store_true", help="the smoke variant, not 2 full layers")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    opts = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    argv = ["--arch", "llama3.2-3b", "--steps", str(opts.steps), "--batch", str(opts.batch),
            "--seq", str(opts.seq), "--lr", "5e-5", "--dlt-chain", str(world), "--dlt-q", "2",
            "--fail", "1@step2", "--straggle", "3@step1x2.0",
            *(["--device", opts.device] if opts.device else [])]
    args = cli.parse_args(argv)
    _, policy, tcfg = cli.build_cfg(args)
    cfg = get_arch(args.arch)
    cfg = smoke_variant(cfg) if opts.smoke else dataclasses.replace(cfg, num_layers=opts.layers)
    backend = cli.init_chain_group(args)
    if backend is None:
        raise SystemExit("run under torchrun with more than one process")
    rank = dist.get_rank()
    log, state = cli.run_dlt_chain(args, cfg, policy, tcfg)
    # rank 0's parameters against every rank's (the one that left compares too;
    # its answer is not counted)
    equal = True
    for p in state.params.parameters():
        x = p.detach().clone()
        dist.broadcast(x, 0)
        equal = equal and torch.equal(x, p.detach())
    per_rank = [None] * world
    dist.all_gather_object(per_rank, dict(
        rank=rank, stayed=len(log) == opts.steps, replica_equal=equal,
        steps=[{k: m[k] for k in ("time_s", "hop_s", "sum_s")} for m in log]))
    if rank == 0:
        largs = cli.parse_args(argv)
        largs.device = args.device
        llog, _ = cli.run_dlt_chain(largs, cfg, policy, tcfg,
                                    group=LocalChain(world, torch.device(args.device)))
        worst = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(log, llog))
        stayed_equal = all(r["replica_equal"] for r in per_rank if r["stayed"])
        card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0]
                if torch.device(args.device).type == "cuda" else "cpu")
        print(json.dumps(dict(
            device=card, backend=backend, world=world, arch=cfg.name, layers=cfg.num_layers,
            batch=opts.batch, seq=opts.seq, stages=[m["stages"] for m in log],
            losses=[m["loss"] for m in log], local_losses=[m["loss"] for m in llog],
            local_wall_s=[m["time_s"] for m in llog], loss_max_rel_diff=worst,
            replicas_bitwise_equal=stayed_equal, ranks=per_rank)), flush=True)
        ok = stayed_equal and worst <= LOSS_RTOL
    else:
        ok = True
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
