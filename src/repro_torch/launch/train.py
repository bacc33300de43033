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

``--dlt-chain N`` is the reference's chain mode, the paper's platform: N
stages form a linear chain, the DLT planner (the LP of Fig. 6, through
``RecoveringChain`` on the serial backend) schedules each super-step's
``--dlt-loads`` batches down the chain in ``--dlt-q`` installments, and
:mod:`repro_torch.runtime.dlt_runner` executes the schedule, with
checkpoints, failure injection (``--fail STAGE@stepK``: the chain shrinks to
its first N - 1 stages, replans and restores the latest checkpoint) and
straggler replanning (``--straggle STAGE@stepKxSLOW``).  In one process the
N stages share ``--device`` (a ``LocalChain``); under ``torchrun
--nproc-per-node N`` each process is a stage (a ``DistChain``), over NCCL
with a card a rank where the machine has N cards, and over gloo where the
ranks share a card or run on the CPU; the backend is printed on the
``arch=...`` line.

Under ``torchrun --nproc-per-node N`` the standard mode is data parallel,
as the reference's ``run_standard`` on a ``(N, 1)`` data x model mesh: the
state is sharded over the ``N`` ranks with FSDP
(:func:`repro_torch.runtime.sharding.shard_model`: each weight's ``d_in``
over 'data', the AdamW moments with it), every rank draws the same global
batch of ``--batch`` rows and trains on its ``--batch / N`` of them, and
the printed loss is the global batch's.  NCCL with a card a rank; gloo
with ``--device cpu`` only.  Checkpoints are gathered a leaf at a time and
written by rank 0, in the same format.

  python -m repro_torch.launch.train --arch llama3.2-3b --steps 4 \\
      --batch 4 --seq 512                          # on the card, full size
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch minitron-8b \\
      --steps 4 --batch 16 --seq 512               # four cards, FSDP
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch llama3.2-3b --smoke --device cpu --steps 4 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --device cpu --steps 20 --ckpt-dir /tmp/ck --save-every 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --device cpu --steps 12 --dlt-chain 4 --dlt-q 2 \\
      --fail 1@step6 --straggle 3@step3x2.0 --ckpt-dir /tmp/c
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-3b --smoke --device cpu --steps 12 --dlt-chain 4
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import resolve_device
from repro_torch.core.planner import LinkSpec, Planner, StageSpec
from repro_torch.data import SyntheticStream, batch_load_spec, make_batch
from repro_torch.launch.mesh import make_chain_mesh, make_data_mesh
from repro_torch.models import activate_mesh, init_params, param_counts
from repro_torch.runtime import make_train_state, make_train_step
from repro_torch.runtime.sharding import shard_model
from repro_torch.runtime.dlt_runner import make_dlt_train_step, stage_batches
from repro_torch.runtime.ft import FailureEvent, FailureSim, RecoveringChain, StragglerSim

__all__ = ["parse_args", "build_cfg", "init_state", "run_standard", "chain_planner",
           "chain_events", "init_chain_group", "init_data_group", "run_dlt_chain", "main"]


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
    # --- DLT chain mode ---
    ap.add_argument("--dlt-chain", type=int, default=0,
                    help="run the paper's chain runner over N stages")
    ap.add_argument("--dlt-q", type=int, default=1, help="installments per load")
    ap.add_argument("--dlt-loads", type=int, default=2, help="loads per super-step")
    ap.add_argument("--fail", default=None, help="inject failure: STAGE@stepK")
    ap.add_argument("--straggle", default=None, help="STAGE@stepKxSLOW")
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


def init_state(args, cfg, tcfg, mesh=None, policy=None):
    """Float32 weights drawn from ``--seed`` on ``--device`` and zeroed AdamW
    moments: the state a run starts from.  With a data ``mesh`` every rank
    draws the same weights and keeps its shards of them and of the moments
    (FSDP, ``policy``'s specs)."""
    model = init_params(cfg, seed=args.seed, dtype=torch.float32, device=args.device)
    if mesh is not None:
        shard_model(model.requires_grad_(True), mesh, policy)
    return make_train_state(model, tcfg)


def run_standard(args, cfg, policy, tcfg, state=None, mesh=None):
    """Train from step 0 (or the latest checkpoint with ``--resume``) to
    ``--steps``.  Returns (the metrics of each step, the final state);
    ``state`` replaces :func:`init_state`'s.  Under an initialised process
    group (or with a data ``mesh``) the state is sharded over the data
    ranks and each rank trains on its rows of every global batch; the
    loss is the global batch's."""
    dev = resolve_device(args.device)
    dist = torch.distributed
    if mesh is None and dist.is_initialized():
        mesh = make_data_mesh(dev.type)
    rank, world = (dist.get_rank(), dist.get_world_size()) if mesh is not None else (0, 1)
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} does not split over {world} data ranks")
    rows = slice(rank * args.batch // world, (rank + 1) * args.batch // world)
    lead = rank == 0
    with activate_mesh(mesh):  # the mesh the run's state lives on (current_mesh)
        state = init_state(args, cfg, tcfg, mesh, policy) if state is None else state
        step_fn = make_train_step(cfg, policy, tcfg)
        mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        start = 0
        if args.resume and args.ckpt_dir and (ls := latest_step(args.ckpt_dir)) is not None:
            state, _ = restore_checkpoint(args.ckpt_dir, ls, state, device=dev)
            start = ls + 1
            if lead:
                print(f"resumed from step {ls}")
        stream = SyntheticStream(cfg, args.batch, args.seq, seed=args.seed, step=start)
        metrics_log = []
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in next(stream).items()}
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            lr = float(metrics["lr"])
            if lead and step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} lr {lr:.2e} {dt*1e3:.0f}ms", flush=True)
            metrics_log.append({"step": step, "loss": loss, "time_s": dt, "lr": lr,
                                "grad_norm": float(metrics["grad_norm"])})
            if mgr and (step + 1) % args.save_every == 0:
                mgr.save_async(step, state)
        if mgr:
            mgr.wait()
    return metrics_log, state


def chain_planner(args, cfg, m: int) -> tuple:
    """(the chain's :class:`Planner`, stage 0's nominal FLOP/s), scaled to
    the workload so the LP is non-trivial: a batch is ~50 ms of compute a
    stage and ~15 ms a link; the stages are heterogeneous on purpose (stage
    i's speed 1 / (1 + 0.2 i) of stage 0's), as in the reference's CLI."""
    load0 = batch_load_spec(cfg, args.batch, args.seq)
    base_speed = load0.flops_per_sample * load0.num_samples / 0.05
    base_bw = load0.bytes_per_sample * load0.num_samples / 0.015
    stages = [StageSpec(f"pod{i}", base_speed / (1 + 0.2 * i)) for i in range(m)]
    links = [LinkSpec(bytes_per_sec=base_bw, startup_sec=50e-6) for _ in range(m - 1)]
    return Planner(stages, links), base_speed


def chain_events(args) -> tuple:
    """(the ``FailureSim`` of ``--fail``, the ``StragglerSim`` of
    ``--straggle``), each ``None`` when its flag is not given."""
    failure = straggler = None
    if args.fail:
        g = re.fullmatch(r"(\d+)@step(\d+)", args.fail)
        if g is None:
            raise SystemExit(f"--fail {args.fail!r}: expected STAGE@stepK")
        failure = FailureSim([FailureEvent(step=int(g.group(2)), stage=int(g.group(1)),
                                           restore_delay=1.0)])
    if args.straggle:
        g = re.fullmatch(r"(\d+)@step(\d+)x([\d.]+)", args.straggle)
        if g is None:
            raise SystemExit(f"--straggle {args.straggle!r}: expected STAGE@stepKxSLOW")
        straggler = StragglerSim(int(g.group(1)), int(g.group(2)), float(g.group(3)))
    return failure, straggler


def init_chain_group(args, shared_card: bool = True):
    """Join the ``torch.distributed`` world that ``torchrun`` describes in
    the environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``), with the backend the topology allows:
    NCCL with ``cuda:LOCAL_RANK`` where the machine has a card for every
    local rank, gloo where the ranks share a card (NCCL refuses two ranks
    on one; without ``shared_card`` that raises instead) or run on the CPU.
    Sets ``args.device`` to this rank's device.  Returns the backend's
    name, or ``None`` in a single process or when the caller already
    initialised a group (which is then used as it is)."""
    dist = torch.distributed
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    dev = torch.device("cuda" if args.device is None else args.device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    if dev.type == "cuda":
        resolve_device(dev)
        cards = torch.cuda.device_count()
        if cards < local_world and not shared_card:
            raise SystemExit(f"the standard mode runs a card a rank: {local_world} local ranks, "
                             f"{cards} cards (--device cpu runs over gloo)")
        backend = "nccl" if cards >= local_world else "gloo"
        args.device = f"cuda:{local_rank % cards}"
        torch.cuda.set_device(args.device)
    else:
        backend = "gloo"
    dist.init_process_group(backend)
    return backend


def init_data_group(args):
    """:func:`init_chain_group` for the standard mode's data parallelism:
    NCCL with a card a rank, gloo only with ``--device cpu``."""
    return init_chain_group(args, shared_card=False)


def run_dlt_chain(args, cfg, policy, tcfg, state=None, group=None):
    """The paper's chain: super-steps of ``--dlt-loads`` batches scheduled
    down a chain of ``--dlt-chain`` stages, with straggler replanning and,
    on a failure, the chain shrunk to its first N - 1 stages, the step
    rebuilt and the latest checkpoint restored.  ``group`` replaces
    :func:`repro_torch.launch.mesh.make_chain_mesh`'s stage group and
    ``state`` :func:`init_state`'s.  Only stage 0's process prints and
    writes checkpoints.  Returns (the metrics of each super-step, the final
    state); a process whose stage leaves the chain returns at that point."""
    m = args.dlt_chain
    group = make_chain_mesh(m, args.device) if group is None else group
    dev = group.device
    lead = group.rank == 0

    def say(line):
        if lead:
            print(line, flush=True)

    planner, base_speed = chain_planner(args, cfg, m)
    loads = [batch_load_spec(cfg, args.batch, args.seq) for _ in range(args.dlt_loads)]
    chain = RecoveringChain(planner, loads, q=args.dlt_q)
    say(f"chain plan: makespan={chain.plan.makespan:.4f}s cells={chain.plan.cells} "
        f"samples={[list(map(int, s)) for s in chain.plan.samples]}")
    failure, straggler = chain_events(args)
    state = init_state(args, cfg, tcfg) if state is None else state
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir and lead else None
    step_fn = make_dlt_train_step(cfg, policy, tcfg, group, n_cells=len(chain.plan.cells))
    on_card = dev.type == "cuda"
    metrics_log = []
    step = 0
    data_step = 0
    while step < args.steps:
        # one super-step = dlt_loads global batches scheduled down the chain
        batches = [make_batch(cfg, args.batch, args.seq, data_step + i, seed=args.seed)
                   for i in range(args.dlt_loads)]
        toks, labs, counts = stage_batches(chain.plan, batches, chain.n_stages)
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        hop0, sum0 = group.seconds["hop"], group.seconds["sum"]
        t0 = time.perf_counter()
        state, metrics = step_fn(state, toks, labs, counts)
        loss = float(metrics["loss"])  # waits for the step
        if on_card:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        metrics_log.append({
            "step": step, "loss": loss, "stages": chain.n_stages,
            "makespan": chain.plan.makespan, "lr": float(metrics["lr"]),
            "grad_norm": float(metrics["grad_norm"]), "time_s": wall,
            "samples": counts.tolist(), "tok_per_s": int(counts.sum()) * args.seq / wall,
            "hop_s": group.seconds["hop"] - hop0, "sum_s": group.seconds["sum"] - sum0,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None})
        say(f"step {step:4d} loss {loss:.4f} chain={chain.n_stages} "
            f"plan_makespan={chain.plan.makespan:.4f}s")
        if args.ckpt_dir and (step + 1) % args.save_every == 0:
            if mgr:
                mgr.save_async(step, state)
                mgr.wait()
            group.barrier()  # the checkpoint is on disk before any stage reads it
        data_step += args.dlt_loads
        step += 1

        # --- straggler feedback (simulated wall-times -> w_i EWMA -> replan) ---
        if straggler is not None:
            for i in range(chain.n_stages):
                eff = straggler.effective_speed(i, base_speed / (1 + 0.2 * i), step)
                if chain.on_observation(i, eff):
                    say(f"  straggler replan (stage {i}): "
                        f"makespan={chain.plan.makespan:.4f}s "
                        f"samples={[list(map(int, x)) for x in chain.plan.samples]}")

        # --- failure injection -> shrink the chain, restore, rebuild the step ---
        if failure is not None and (ev := failure.check(step)):
            say(f"  FAILURE stage {ev.stage} at step {step}: replanning")
            chain.on_failure(ev)
            group = group.shrink(chain.n_stages)
            if group is None:  # this process's stage left the chain
                break
            step_fn = make_dlt_train_step(cfg, policy, tcfg, group,
                                          n_cells=len(chain.plan.cells))
            if args.ckpt_dir and (ls := latest_step(args.ckpt_dir)) is not None:
                state, _ = restore_checkpoint(args.ckpt_dir, ls, state, device=dev)
                say(f"  restored checkpoint step {ls}; "
                    f"new chain={chain.stage_names()} "
                    f"makespan={chain.plan.makespan:.4f}s")
            else:  # the survivors' replicas are the state (the reference says nothing)
                say(f"  no checkpoint to restore; new chain={chain.stage_names()} "
                    f"makespan={chain.plan.makespan:.4f}s")
    if mgr:
        mgr.wait()
    return metrics_log, state


def main(argv=None):
    args = parse_args(argv)
    cfg, policy, tcfg = build_cfg(args)
    dist = torch.distributed
    backend = init_chain_group(args) if args.dlt_chain else init_data_group(args)
    try:
        resolve_device(args.device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        lead = not dist.is_initialized() or dist.get_rank() == 0
        pc = param_counts(cfg)
        if lead:
            print(f"arch={cfg.name} params={pc.total/1e6:.1f}M active={pc.active/1e6:.1f}M "
                  f"devices={world}" + (f" backend={backend}" if backend else ""), flush=True)
        if args.dlt_chain:
            log, _ = run_dlt_chain(args, cfg, policy, tcfg)
        else:
            log, _ = run_standard(args, cfg, policy, tcfg)
    finally:
        if backend is not None:
            dist.destroy_process_group()
    if not lead:
        return
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(log, f, indent=1)
    losses = [m["loss"] for m in log]
    print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
