"""Multi-load serving in the port: N inference request batches are the
paper's N divisible loads.  The LP plans how many requests of each batch
each chain stage serves and in how many installments; its makespan is
compared against the load-by-load heuristics on the same chain, then the
planned requests are served with the real decode loop of the smoke model
through the hand-written flash-attention (prefill) and decode-attention
(each step) kernels on the card, or their plain versions with ``--device
cpu``.  The port of ``examples/serve_multiload.py``.

Run:  PYTHONPATH=src python examples/torch_serve_multiload.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.config import ShardingPolicy, get_arch, smoke_variant
from repro_torch.convert import resolve_device
from repro_torch.core.heuristics import multi_inst, simple, single_inst
from repro_torch.core.planner import BatchSpec, LinkSpec, Planner, StageSpec
from repro_torch.data import make_batch
from repro_torch.models import decode_flops_per_token, init_params, prefill
from repro_torch.runtime import make_serve_step

N_BATCHES = 3  # the N loads
BATCH = 6  # requests per batch
PROMPT, GEN = 16, 8


def main(argv=None) -> dict:
    """Plans and serves; returns the deterministic numbers (the plan, the
    heuristics' makespans), the planned instance and the tokens served by
    name."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_variant(get_arch("llama3.2-3b"))
    policy = ShardingPolicy(attention_impl="cuda", attn_chunk=16)  # the attention kernels

    # --- the chain: 4 heterogeneous stages, scaled so one batch ~ 60ms/stage ---
    fl = decode_flops_per_token(cfg, PROMPT) * GEN
    speed = fl * BATCH / 0.06
    stages = [StageSpec(f"pod{i}", speed / (1 + 0.5 * i)) for i in range(4)]
    links = [LinkSpec(bytes_per_sec=4.0 * PROMPT * BATCH / 0.02, startup_sec=1e-4)] * 3
    planner = Planner(stages, links)
    loads = [BatchSpec(num_samples=BATCH, bytes_per_sample=4.0 * PROMPT, flops_per_sample=fl)
             for _ in range(N_BATCHES)]
    out: dict = {}

    print(f"=== scheduling {N_BATCHES} request batches x {BATCH} requests on a "
          f"4-stage chain ===")
    plan = planner.plan(loads, q=2)
    print(f"LP plan makespan: {plan.makespan * 1e3:.2f} ms")
    out.update(plan=plan.makespan, samples=np.asarray(plan.samples).tolist(),
               cells=[list(c) for c in plan.cells], instance=planner.to_instance(loads, q=2))
    for name, fn in [("SIMPLE", simple), ("SINGLEINST", single_inst),
                     ("MULTIINST", lambda i: multi_inst(i, cap=100))]:
        r = fn(planner.to_instance(loads, q=1))
        rel = r.makespan / plan.makespan if not r.failed else float("inf")
        print(f"  {name:>10}: {r.makespan * 1e3:8.2f} ms  ({rel:5.2f}x LP)"
              + ("  FAILED" if r.failed else ""))
        out[f"heuristic_{name}"] = r.makespan
    for t, (n, j) in enumerate(plan.cells):
        print(f"  batch {n} installment {j}: requests/stage = "
              f"{[int(x) for x in plan.samples[t]]}")

    # --- serve the requests (one device plays every stage) ---
    print("\n=== executing the plan with the real decode loop ===")
    model = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    serve_step = make_serve_step(cfg, policy)
    t0 = time.time()
    total_tokens = 0
    heads = []
    for n in range(N_BATCHES):
        toks = torch.from_numpy(make_batch(cfg, BATCH, PROMPT, step=n)["tokens"]).to(dev)
        logits, cache, pos = prefill(model, cfg, policy, toks, max_len=PROMPT + GEN)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        outs = []
        for i in range(GEN):
            logits, cache = serve_step(model, cache, nxt, pos + i)
            nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            outs.append(nxt.cpu().numpy())
        total_tokens += GEN * BATCH
        heads.append(np.concatenate(outs, 1)[0, :5].tolist())
        print(f"  batch {n}: generated {GEN} tokens x {BATCH} requests; "
              f"head of request 0: {heads[-1]}")
    dt = time.time() - t0
    print(f"served {total_tokens} tokens in {dt:.2f}s ({total_tokens / dt:.1f} tok/s on "
          f"{dev.type})")
    out.update(tokens=total_tokens, heads=heads, serve_s=dt)
    print("torch_serve_multiload OK")
    return out


if __name__ == "__main__":
    main()
