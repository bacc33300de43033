"""Elastic restart in the port: checkpoint/restart + chain resize, end to
end, on the card (or the CPU with ``--device cpu``).  The port of
``examples/elastic_restart.py``.

Phase 1: train on a 3-stage plan, checkpointing every step.
Phase 2: stage 1 "fails" — the planner drops it (fusing its links, paper §2
         availability dates tau_i = restore time), the last checkpoint is
         restored, training continues on the 2-stage plan.
Phase 3: a NEW stage joins (elastic scale-up) — replan again, keep training.

Because the synthetic data stream is a pure function of the step index, the
restored run re-sees exactly the batches a failure-free run would have —
asserted below.  The checkpoints go to a fresh temporary directory.

Run:  PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import resolve_device
from repro_torch.core.planner import LinkSpec, Planner, StageSpec
from repro_torch.data import batch_load_spec, make_batch
from repro_torch.models import init_params
from repro_torch.runtime import make_train_state, make_train_step
from repro_torch.runtime.ft import FailureEvent, RecoveringChain


def _samples(chain) -> list:
    return [list(map(int, s)) for s in chain.plan.samples]


def main(argv=None) -> dict:
    """Runs the three phases; returns each plan (makespan, samples), the
    chain's log, the losses by name and the checkpoints' directory: a
    temporary one, removed on return."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro_torch_elastic_") as ckpt:
        return run(resolve_device(args.device), ckpt)


def run(dev, ckpt: str) -> dict:
    """The three phases on ``dev``, checkpointing under ``ckpt``."""
    cfg = smoke_variant(get_arch("phi4-mini-3.8b"))
    policy = ShardingPolicy(attn_chunk=16)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=30)
    B, S = 8, 32

    load = batch_load_spec(cfg, B, S)
    speed = load.flops_per_sample * B / 0.05

    def mkstage(i):
        return StageSpec(f"pod{i}", speed / (1 + 0.3 * i))

    planner = Planner([mkstage(0), mkstage(1), mkstage(2)],
                      [LinkSpec(load.bytes_per_sample * B / 0.015, 1e-4)] * 2)
    chain = RecoveringChain(planner, [load, load], q=1)
    plans = [(chain.plan.makespan, _samples(chain))]
    print(f"phase 1: 3-stage chain, plan makespan {chain.plan.makespan*1e3:.1f} ms, "
          f"samples {_samples(chain)}")

    state = make_train_state(init_params(cfg, seed=0, dtype=torch.float32, device=dev), tcfg)
    step_fn = make_train_step(cfg, policy, tcfg)
    mgr = CheckpointManager(ckpt, keep=5)
    losses = {}

    def batch_at(s):
        return {k: torch.from_numpy(v).to(dev) for k, v in make_batch(cfg, B, S, step=s).items()}

    def run_steps(state, lo, hi):
        for s in range(lo, hi):
            state, m = step_fn(state, batch_at(s))
            losses[s] = float(m["loss"])
            print(f"  step {s}: loss {losses[s]:.4f}")
            mgr.save_async(s, state)
            mgr.wait()
        return state

    state = run_steps(state, 0, 4)

    print("\nphase 2: stage 1 fails -> drop, fuse links, replan, restore ckpt")
    chain.on_failure(FailureEvent(step=4, stage=1, restore_delay=0.5))
    plans.append((chain.plan.makespan, _samples(chain)))
    print(f"  surviving chain: {chain.stage_names()}, "
          f"new makespan {chain.plan.makespan*1e3:.1f} ms, samples {_samples(chain)}")
    ls = latest_step(ckpt)
    state, _ = restore_checkpoint(ckpt, ls, state, device=dev)
    print(f"  restored checkpoint step {ls}")
    # deterministic stream: re-running step ls+1 sees the exact same batch
    b_replay = make_batch(cfg, B, S, step=ls + 1)
    b_orig = make_batch(cfg, B, S, step=ls + 1)
    assert np.array_equal(b_replay["tokens"], b_orig["tokens"]), "stream must be deterministic"
    state = run_steps(state, ls + 1, ls + 4)

    print("\nphase 3: a new stage joins (elastic scale-up) -> replan")
    chain.on_join(StageSpec("pod3-new", speed / 1.1, available_at=0.7),  # joins later
                  LinkSpec(load.bytes_per_sample * B / 0.015, 1e-4))
    plans.append((chain.plan.makespan, _samples(chain)))
    print(f"  chain: {chain.stage_names()}, makespan {chain.plan.makespan*1e3:.1f} ms, "
          f"samples {_samples(chain)}")
    state = run_steps(state, max(losses) + 1, max(losses) + 4)

    seq = [losses[k] for k in sorted(losses)]
    assert seq[-1] < seq[0], f"loss should improve: {seq[0]:.4f} -> {seq[-1]:.4f}"
    print(f"\ntorch_elastic_restart OK: loss {seq[0]:.4f} -> {seq[-1]:.4f}, "
          f"replans={chain.replans}, log={chain.log}")
    return {"plans": plans, "log": list(chain.log), "replans": chain.replans, "losses": seq,
            "restored_step": ls, "ckpt": ckpt}


if __name__ == "__main__":
    main()
