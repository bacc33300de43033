"""Quickstart of the port: the paper's contribution through the one front
door, ``repro_torch.api``, on the CUDA card (or the CPU with ``--device
cpu``).  The port of ``examples/quickstart.py``, section by section:

1. The §3 motivating instance (2 processors, 2 loads, lambda=3/4) solved
   optimally with the Fig. 6 LP on several backends, vs the heuristics it
   supersedes.
2. A STAR platform with a result-return phase through the same session —
   plus the versioned PlanArtifact: JSON out, JSON in, replayed
   bit-identically.
3. Serving-style traffic: async ``submit()`` tickets coalescing into
   micro-batched engine solves; the flight recorder; live replanning; the
   plan server over HTTP with its persistent store.
4. The same LP scheduling real training batches on a heterogeneous chain,
   with the cost-aware Theorem-1 auto-T* chooser, and training steps of the
   smoke model.

The engine backends are the port's: ``"cuda"`` (the hand-written kernels)
on the card, ``"torch"`` (their plain versions) on the CPU, where the
reference names ``"pallas"`` and ``"batched"``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.api import PlanArtifact, Policy, Problem, Session
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import resolve_device
from repro_torch.core import available_backends
from repro_torch.core.closed_form import example_instance, star_single_load_makespan
from repro_torch.core.heuristics import multi_inst, simple, single_inst
from repro_torch.core.instance import random_instance
from repro_torch.core.planner import LinkSpec, Planner, StageSpec
from repro_torch.data import batch_load_spec, make_batch
from repro_torch.models import init_params
from repro_torch.obs import get_registry
from repro_torch.runtime import make_train_state, make_train_step
from repro_torch.runtime.replan import EventStreamReplanner, SpeedObserved
from repro_torch.serve import PlanClient, PlanServer


def main(argv=None) -> dict:
    """Runs the quickstart; returns its deterministic numbers (makespans,
    plans) by name, and under ``"solved"`` each engine solve as (what, the
    problem, the policy, its makespan)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    engine = "cuda" if dev.type == "cuda" else "torch"
    out: dict = {"solved": []}

    # one session owns the backend handles, the solution cache, and the submit queue
    session = Session(device=dev)

    # --------------------------------------------------------------- 1
    print("=== the paper's example: 2 identical processors, lambda = 3/4 ===")
    paper = Problem.from_instance(example_instance(0.75))
    art = session.solve(paper, Policy(installments=2))  # Fig. 6, Q=2 installments
    print(f"LP (Fig. 6, Q=2 installments): makespan = {art.makespan:.6f}"
          f"  (paper's hand schedule: 781/653 * 3/4 = {781 / 653 * 0.75:.6f})")
    out["paper"] = art.makespan
    out["paper_gamma"] = np.asarray(art.gamma)

    print(f"registered solver backends: {available_backends()}")
    for backend in ("simplex", engine):
        a = session.solve(paper, Policy(installments=2, backend=backend))
        print(f"{backend:>8} backend agrees: makespan = {a.makespan:.6f} "
              f"(served by {a.backend}, status={a.status})")
        out[f"paper_{'simplex' if backend == 'simplex' else 'engine'}"] = a.makespan
    out["solved"].append(("paper", paper, Policy(installments=2, backend=engine),
                          out["paper_engine"]))
    for name, fn in [("SIMPLE", simple), ("SINGLEINST", single_inst),
                     ("MULTIINST", lambda i: multi_inst(i, cap=300))]:
        r = fn(example_instance(0.75))
        print(f"{name:>10}: makespan = {r.makespan:.6f}" + ("  (FAILED)" if r.failed else ""))
        out[f"heuristic_{name}"] = r.makespan
    print("gamma (fraction of each load per processor per installment):")
    print(np.array_str(art.gamma, precision=4, suppress_small=True))

    # --------------------------------------------------------------- 2
    print("\n=== a star platform with result return + the shippable artifact ===")
    star = Problem(topology="star", w=[0.8, 1.2, 0.6, 1.5], z=0.3, v_comm=[1.0], v_comp=[1.0])
    star_art = session.solve(star, Policy(backend=engine))
    cf = star_single_load_makespan(np.array(star.w), np.array(star.z), 1.0, 1.0)
    print(f"star (bus) single load: LP makespan = {star_art.makespan:.6f}, "
          f"closed form = {cf:.6f} (equal on uniform links)")
    ret = Problem(topology="star", w=[0.8, 1.2, 0.6, 1.5], z=0.3, v_comm=[1.0], v_comp=[1.0],
                  return_ratio=0.25)
    ret_art = session.solve(ret, Policy(backend=engine))
    ret_end = float(ret_art.schedule().ret_end.max())
    print(f"with result return (ratio 0.25): makespan = {ret_art.makespan:.6f} "
          f"(last return arrives at {ret_end:.6f})")
    out.update(star=star_art.makespan, star_closed_form=cf, ret=ret_art.makespan,
               ret_end=ret_end)
    out["solved"] += [("star", star, Policy(backend=engine), star_art.makespan),
                      ("ret", ret, Policy(backend=engine), ret_art.makespan)]

    wire = ret_art.to_json()
    shipped = PlanArtifact.from_json(wire)
    assert shipped.to_json() == wire, "artifact round-trip must be bit-identical"
    print(f"artifact v{shipped.version}: {len(wire)} JSON bytes, "
          f"replayed makespan = {shipped.schedule().makespan:.6f}, "
          f"provenance: backend={shipped.backend}, cache_hit={shipped.cache_hit}")

    # --------------------------------------------------------------- 3
    print("\n=== serving-style traffic: coalescing async submission ===")
    rng = np.random.default_rng(0)
    bursty = Session(policy=Policy(backend=engine), max_batch=8, device=dev)
    submitted = [Problem.from_instance(random_instance(rng, m=3, n_loads=2, q=1))
                 for _ in range(20)]
    tickets = [bursty.submit(p) for p in submitted]
    makespans = [t.result().makespan for t in tickets]
    st = bursty.stats()
    print(f"20 staggered submits -> {st['flushes']} engine flushes "
          f"(max_batch=8); mean makespan {np.mean(makespans):.3f}s")
    out["submits"] = makespans
    out["solved"] += [(f"submit{i}", p, Policy(backend=engine), m)
                      for i, (p, m) in enumerate(zip(submitted, makespans))]

    print("\n=== the flight recorder: spans + metrics ===")
    burst_probs = [Problem.from_instance(random_instance(rng, m=3, n_loads=2, q=1))
                   for _ in range(8)]
    with bursty.trace() as tr:
        bursty.solve_bulk(burst_probs)
    stage_us = {n: tr.total_us(n) for n in ("engine.lp_build", "engine.simplex",
                                            "engine.replay")}
    print(f"traced {len(tr)} spans over {tr.total_us('session.trace')/1e3:.1f}ms: "
          + ", ".join(f"{n.split('.')[1]} {us/1e3:.1f}ms" for n, us in stage_us.items()))
    bursty.solve_bulk(burst_probs)
    hit = bursty.solve_bulk(burst_probs)[0]
    print(f"warm re-solve: cache_hit={hit.cache_hit}, backend={hit.backend}, "
          f"bucket B={hit.telemetry['bucket']['B']} replayed in "
          f"{hit.telemetry['stages']['replay_s']*1e3:.2f}ms, "
          f"pivots={hit.telemetry['lp']['pivots_phase1']}"
          f"+{hit.telemetry['lp']['pivots_phase2']}")
    snap = get_registry().snapshot()
    solves = sum(v for k, v in snap.items() if k.startswith("repro_engine_bulk_solves_total"))
    pivots = sum(v for k, v in snap.items()
                 if k.startswith("repro_simplex_pivots_total") and "phase=2" in k)
    print(f"metrics: engine bulk solves = {solves:.0f}, "
          f"cache hits = {snap.get('repro_cache_hits_total', 0):.0f}, "
          f"phase-2 pivots = {pivots:.0f}")

    print("\n=== live replanning: platform events -> warm-started re-solves ===")
    live = Session(policy=Policy(backend=engine), device=dev)
    replanner = EventStreamReplanner(live, ret, Policy(backend=engine))
    sub = replanner.subscription
    snap0 = sub.next(timeout=5.0)
    print(f"  initial plan: makespan = {snap0.makespan:.6f}")
    out["replans"] = [snap0.makespan]
    for k in range(3):
        replanner.apply(SpeedObserved(index=2, w=0.6 * (1.0 + 0.05 * (k + 1))))
        update = sub.next(timeout=5.0)
        prov = update.events[-1]
        print(f"  {prov['trigger']}(w={replanner.problem.w[2]:.3f}): "
              f"makespan = {update.makespan:.6f}, warm={prov['warm']}, "
              f"pivots={prov['pivots_phase1']}+{prov['pivots_phase2']}")
        out["replans"].append(update.makespan)
        out["solved"].append((f"replan{k}", replanner.problem, Policy(backend=engine),
                              update.makespan))
    replanner.close()
    assert sub.next(timeout=0.1) is None, "closed feed must drain to None"

    print("\n=== the planning service: persistent store + HTTP front door ===")
    with tempfile.TemporaryDirectory(prefix="torch_quickstart_") as tmp:  # removed on exit
        store_path = os.path.join(tmp, "plans.sqlite")
        serve_policy = Policy(backend=engine)
        with PlanServer(store=store_path, workers=2, policy=serve_policy, port=0,
                        device=dev) as server:
            client = PlanClient(f"http://localhost:{server.port}")
            served = client.plan(ret)
            assert served.diff(ret_art) == {}, "served plan must match direct solve"
            print(f"served over HTTP :{server.port}: makespan = {served.makespan:.6f} "
                  f"(diff()-clean vs the direct solve), healthz = {client.healthz()['status']}")
        with PlanServer(store=store_path, workers=1, policy=serve_policy, device=dev) as restarted:
            warm = restarted.plan(ret)
            print(f"restarted server: cache_hit={warm.cache_hit} "
                  f"(store hits = {restarted.cache.store_hits})")
    out.update(served=served.makespan, restarted=warm.makespan)
    out["solved"] += [("served", ret, serve_policy, served.makespan),
                      ("restarted", ret, serve_policy, warm.makespan)]

    # --------------------------------------------------------------- 4
    print("\n=== the same LP scheduling real training batches on a chain ===")
    cfg = smoke_variant(get_arch("llama3.2-3b"))
    policy = ShardingPolicy(attn_chunk=16)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    B, S = 8, 32
    load = batch_load_spec(cfg, B, S)
    speed = load.flops_per_sample * B / 0.04
    stages = [StageSpec("pod0", speed), StageSpec("pod1", speed / 2), StageSpec("pod2", speed / 3)]
    links = [LinkSpec(bytes_per_sec=load.bytes_per_sample * B / 0.01, startup_sec=1e-4)] * 2
    planner = Planner(stages, links, session=session)
    auto = planner.plan_auto_T([load, load], t_max=4, installment_cost=2e-4, backend="serial")
    print("auto-T sweep (0.2ms/installment): "
          + ", ".join(f"q={q}: {auto.makespans[q] * 1e3:.2f}ms" for q in sorted(auto.makespans))
          + f" -> T* = {auto.t_star}")
    plan = auto.plan
    print(f"planned makespan: {plan.makespan * 1e3:.2f} ms "
          f"(T* = {auto.t_star} installments/load, artifact t_star = {plan.artifact.t_star})")
    for t, (n, j) in enumerate(plan.cells):
        print(f"  load {n}, installment {j}: samples/stage = "
              f"{[int(x) for x in plan.samples[t]]}")
    out.update(auto={q: auto.makespans[q] for q in auto.makespans}, t_star=auto.t_star,
               plan=plan.makespan, samples=np.asarray(plan.samples).tolist())

    state = make_train_state(init_params(cfg, seed=0, dtype=torch.float32, device=dev), tcfg)
    step = make_train_step(cfg, policy, tcfg)
    losses = []
    for i in range(3):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(cfg, B, S, step=i).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        print(f"train step {i}: loss = {losses[-1]:.4f}")
    out["losses"] = losses
    print("torch_quickstart OK")
    return out


if __name__ == "__main__":
    main()
