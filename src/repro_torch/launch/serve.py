"""Serving entry point of the port: batched prefill + token-by-token decode of a
decoder LM of any family of the reference — dense, moe (with MLA), ssm
(Mamba-2), hybrid (Hymba), vlm (PaliGemma: a prompt of patch embeddings
and text) or audio (MusicGen: parallel codebooks) — on the CUDA card
unless ``--device cpu`` is given.

The port of the reference's serving driver (``repro.launch.serve``).  The
prefill and decode run in the hand-written kernels
(``attention_impl="cuda"``): per layer, one flash-attention launch and one
SSD-scan launch in the prefill (whichever the family has), and one
decode-attention launch per step.  MLA attention, the experts and the
Mamba decode step are plain PyTorch, as the reference's are plain JAX.
Decoding is greedy (per codebook for audio) unless ``--no-greedy``.  The
decode loop keeps the cache length and the sampled tokens on the device,
so it never waits for the host until the end.

  python -m repro_torch.launch.serve --arch llama3.2-3b --batch 4 \\
      --prompt-len 512 --gen-len 32                       # on the card
  python -m repro_torch.launch.serve --arch paligemma-3b --batch 4 \\
      --prompt-len 512 --gen-len 32     # on the card: 256 patches + 256 tokens
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
      --smoke --device cpu --batch 2 --prompt-len 16 --gen-len 4

The multi-load analogue for inference, as in the reference: N request
batches are the paper's N divisible loads, and ``--plan N`` DLT-plans them
over a 4-stage chain (or star, ``--topology``) through the port's
``Planner`` and ``api.Session`` on ``--device``, printing the schedule next
to its makespan, a replanning tick (a solution-cache hit on an engine
backend) and, with ``--auto-t T_MAX``, the cost-aware installment sweep.

``--serve`` switches to the long-lived planning service instead (no model
stack): a :class:`repro_torch.serve.PlanServer` — worker Sessions on
``--device`` solving with ``--plan-backend`` (``cuda``: the kernels on the
card), a bounded admission queue, an optional persistent plan store shared
across restarts and replicas, ``/healthz`` + ``/metrics``, graceful drain on
SIGINT or after ``--serve-duration`` seconds::

  python -m repro_torch.launch.serve --serve --plan-backend cuda \\
      --serve-port 8080 --serve-store /tmp/plans.sqlite --serve-workers 4
  PYTHONPATH=src python -m repro_torch.launch.serve --serve --device cpu \\
      --plan-backend torch --serve-port 0 --serve-duration 3
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.config import ArchConfig, ShardingPolicy, get_arch, smoke_variant
from repro_torch.convert import resolve_device
from repro_torch.core.planner import BatchSpec, LinkSpec, StageSpec
from repro_torch.data import make_batch
from repro_torch.models import Transformer, decode_flops_per_token, init_params, prefill
from repro_torch.obs import span
from repro_torch.runtime import make_serve_step

__all__ = ["main", "serve_policy", "load_model", "prompt_tokens", "prompt_patches", "generate",
           "ServeResult", "plan_inputs", "PLAN_BACKENDS"]

# the reference's engine backend names, and the port's that take their place
PLAN_BACKENDS = {"batched": "torch", "pallas": "cuda"}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None,
                    help="model architecture (e.g. llama3.2-3b, mamba2-2.7b, hymba-1.5b, "
                         "deepseek-v2-lite-16b, paligemma-3b, musicgen-medium)")
    ap.add_argument("--smoke", action="store_true", help="the reduced CPU-test variant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--greedy", action=argparse.BooleanOptionalAction, default=True,
                    help="greedy (argmax) decoding; --no-greedy samples from the softmax "
                         "with --temperature")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="softmax temperature for --no-greedy sampling")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: the card, which must be present) or 'cpu'")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the prefill and decode spans and write Chrome trace-event "
                         "JSON to PATH")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the process metrics registry as Prometheus text on "
                         "http://localhost:PORT/metrics for the duration of the run")
    ap.add_argument("--plan", type=int, default=0,
                    help="also DLT-plan N request batches over a 4-stage platform")
    ap.add_argument("--plan-backend", default="torch",
                    help="solver-backend registry entry for --plan (see "
                         "repro_torch.core.available_backends()): 'torch' runs the engine in "
                         "plain PyTorch on --device, 'cuda' in the CUDA kernels; the "
                         "reference's 'batched' and 'pallas' name these two")
    ap.add_argument("--topology", default="chain", choices=("chain", "star"),
                    help="platform family for --plan: the paper's linear chain, or a one-port "
                         "master star (stage 0 holds the data, every other stage on its own "
                         "link)")
    ap.add_argument("--return-ratio", type=float, default=0.0,
                    help="result bytes returned to the source per input byte (>0 adds the "
                         "result-return phase to the plan)")
    ap.add_argument("--auto-t", type=int, default=0, metavar="T_MAX",
                    help="with --plan: sweep 1..T_MAX installments through the engine and "
                         "report the cost-aware T*")
    ap.add_argument("--installment-cost", type=float, default=1e-3,
                    help="fixed per-installment overhead (seconds) charged by the --auto-t "
                         "sweep")
    ap.add_argument("--serve", action="store_true",
                    help="run the long-lived planning service (repro_torch.serve.PlanServer) "
                         "instead of the decode demo; its workers solve with --plan-backend "
                         "on --device")
    ap.add_argument("--serve-port", type=int, default=0, metavar="PORT",
                    help="HTTP port for --serve (0 = ephemeral, printed)")
    ap.add_argument("--serve-workers", type=int, default=2,
                    help="worker Sessions behind the admission queue (one CUDA stream each "
                         "on the card)")
    ap.add_argument("--serve-store", default=None, metavar="PATH",
                    help="persistent plan store (sqlite file) shared across restarts and "
                         "sibling replicas; default in-memory")
    ap.add_argument("--serve-queue-limit", type=int, default=256,
                    help="bounded admission queue depth (backpressure: a full queue rejects "
                         "with HTTP 429)")
    ap.add_argument("--serve-deadline", type=float, default=30.0,
                    help="default per-request deadline (seconds)")
    ap.add_argument("--serve-shards", type=int, default=None, metavar="N",
                    help="fan engine buckets out over N shards per solve (N CUDA streams on "
                         "the card; default: one)")
    ap.add_argument("--serve-duration", type=float, default=None, metavar="SECONDS",
                    help="with --serve: drain and exit after this long (default: run until "
                         "SIGINT)")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if not args.serve and args.arch is None:
        ap.error("--arch is required (unless running --serve)")
    metrics_server = None
    if args.metrics_port is not None:
        from repro_torch.obs import start_metrics_server

        metrics_server = start_metrics_server(args.metrics_port)
        print(f"metrics: http://localhost:{metrics_server.server_address[1]}/metrics")
    tracer = prev_tracer = None
    if args.trace_out is not None:
        from repro_torch.obs import Tracer, activate

        tracer = Tracer()
        prev_tracer = activate(tracer)
    try:
        if args.serve:
            _run_server(args)
        else:
            _run(args)
    finally:
        if tracer is not None:
            from repro_torch.obs import activate

            activate(prev_tracer)
            tracer.save(args.trace_out)
            print(f"trace: {args.trace_out} ({len(tracer)} spans)")
        if metrics_server is not None:
            metrics_server.shutdown()


def _run_server(args):
    """The --serve mode: stand up a PlanServer and run until stopped.

    Admitted work always drains before exit (SIGINT and --serve-duration
    both go through ``PlanServer.close()``), so Ctrl-C never drops a plan.
    """
    from repro_torch.api import Policy
    from repro_torch.serve import PlanServer

    dev = resolve_device(args.device)
    backend = PLAN_BACKENDS.get(args.plan_backend, args.plan_backend)
    server = PlanServer(
        store=args.serve_store,
        workers=args.serve_workers,
        queue_limit=args.serve_queue_limit,
        default_deadline_s=args.serve_deadline,
        n_shards=args.serve_shards,
        port=args.serve_port,
        policy=Policy(backend=backend),
        device=dev,
    )
    print(f"plan server: http://localhost:{server.port}/v1/plan "
          f"({args.serve_workers} workers, backend={backend} on {dev.type}, "
          f"queue {args.serve_queue_limit}, store={args.serve_store or 'in-memory'})")
    print(f"  healthz: http://localhost:{server.port}/healthz   "
          f"metrics: http://localhost:{server.port}/metrics")
    try:
        if args.serve_duration is not None:
            time.sleep(args.serve_duration)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        print("draining...")
    finally:
        server.close()
        st = server.cache.stats()
        print(f"drained. cache: {st.get('hits', 0)} hit / "
              f"{st.get('misses', 0)} miss"
              + (f", store: {st['store']['entries']} rows persisted"
                 if "store" in st else ""))


def serve_policy(prompt_len: int, attention_impl: str = "cuda") -> ShardingPolicy:
    """The demo's policy: the hand-written attention kernels, chunks of the
    prompt length up to 1024 for the chunked implementation."""
    return ShardingPolicy(attention_impl=attention_impl, attn_chunk=min(1024, prompt_len))


def load_model(cfg: ArchConfig, seed: int, device) -> Transformer:
    """Seeded float32 weights on ``device`` (the reference's demo serves in
    float32)."""
    return init_params(cfg, seed=seed, dtype=torch.float32, device=device)


def prompt_tokens(cfg: ArchConfig, batch: int, prompt_len: int, seed: int, device):
    """The demo's prompts: ``make_batch`` tokens, int32, on ``device``
    (``None``: the card, raising without one): [batch, prompt_len]; audio
    [batch, prompt_len, K]; vlm [batch, prompt_len - num_patches], the text
    after the patch prefix (:func:`prompt_patches`)."""
    toks = make_batch(cfg, batch, prompt_len, step=0, seed=seed)["tokens"]
    return torch.from_numpy(toks).to(resolve_device(device))


def prompt_patches(cfg: ArchConfig, batch: int, prompt_len: int, seed: int, device):
    """A vlm prompt's patch embeddings from ``make_batch``, float32
    [batch, num_patches, patch_dim] on ``device``; None for other families."""
    patches = make_batch(cfg, batch, prompt_len, step=0, seed=seed).get("patches")
    return None if patches is None else torch.from_numpy(patches).to(resolve_device(device))


@dataclasses.dataclass
class ServeResult:
    """What :func:`generate` produced: the prefill's logits [B, S, V] and
    the cache after the last step, the generated tokens [B, gen_len] (one
    per decode step), each step's logits [B, 1, V] when asked for, and the
    host times of the prefill and of the decode loop (each ending in a
    synchronised device).  Audio adds a codebook axis: logits [B, S, K, V],
    tokens [B, gen_len, K]."""

    prefill_logits: torch.Tensor
    cache: dict
    tokens: torch.Tensor
    step_logits: list
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, prompt, gen_len: int,
             *, patches=None, greedy: bool = True, temperature: float = 1.0, seed: int = 0,
             keep_logits: bool = False) -> ServeResult:
    """Prefill ``prompt`` [B, S] (audio [B, S, K]) after vlm's ``patches``,
    then ``gen_len`` decode steps, each fed the token sampled from the
    previous logits (argmax, per codebook for audio; or a draw at
    ``temperature`` from a generator seeded with ``seed + 1``)."""
    dev = prompt.device
    gen = None
    if not greedy:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)

    def sample(lg):
        if greedy:  # [B, 1] (audio: [B, 1, K], one token a codebook)
            return lg[:, -1:].argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(lg[:, -1] / max(temperature, 1e-6), dim=-1)
        draw = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=gen)
        return draw.view(B, 1, *probs.shape[1:-1]).to(torch.int32)

    B = prompt.shape[0]
    S = prompt.shape[1] + (0 if patches is None else patches.shape[1])
    _sync(dev)
    t0 = time.perf_counter()
    with span("serve.prefill", batch=B, prompt_len=S):
        logits, cache, pos = prefill(model, cfg, policy, prompt, patches, max_len=S + gen_len)
        _sync(dev)
    t_prefill = time.perf_counter() - t0
    serve_step = make_serve_step(cfg, policy)
    nxt = sample(logits)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
    out, step_logits = [], []
    t1 = time.perf_counter()
    with span("serve.decode", batch=B, gen_len=gen_len):
        for i in range(gen_len):
            lg, cache = serve_step(model, cache, nxt, pos_t + i)
            nxt = sample(lg)
            out.append(nxt)
            if keep_logits:
                step_logits.append(lg)
        _sync(dev)
    t_decode = time.perf_counter() - t1
    tokens = (torch.cat(out, dim=1) if out else
              torch.zeros(B, 0, *prompt.shape[2:], dtype=torch.int32, device=dev))
    return ServeResult(logits, cache, tokens, step_logits, t_prefill, t_decode)


def _run(args):
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if cfg.family == "vlm" and args.prompt_len <= cfg.num_patches:
        raise SystemExit(f"{cfg.name}'s prompt holds its {cfg.num_patches} patch embeddings "
                         f"before the text: --prompt-len must exceed {cfg.num_patches}")
    policy = serve_policy(args.prompt_len)
    model = load_model(cfg, args.seed, dev)
    prompt = prompt_tokens(cfg, args.batch, args.prompt_len, args.seed, dev)
    patches = prompt_patches(cfg, args.batch, args.prompt_len, args.seed, dev)
    res = generate(model, cfg, policy, prompt, args.gen_len, patches=patches,
                   greedy=args.greedy, temperature=args.temperature, seed=args.seed)
    n_tok = args.gen_len * args.batch
    print(f"arch={cfg.name} prefill {args.batch}x{args.prompt_len} in {res.prefill_s:.2f}s; "
          f"decoded {n_tok} tokens in {res.decode_s:.2f}s "
          f"({n_tok / max(res.decode_s, 1e-9):.1f} tok/s on {dev.type})")
    print("sample tokens:", res.tokens[0, :8].reshape(-1)[:8].tolist())
    if args.plan:
        _plan(args, cfg, dev)


def plan_inputs(cfg: ArchConfig, batch: int, prompt_len: int, gen_len: int, n_loads: int,
                return_ratio: float = 0.0):
    """The ``--plan`` platform and loads, as the reference's demo builds them:
    ``n_loads`` request batches over a heterogeneous 4-stage platform, speeds
    scaled to the workload (a batch ~50 ms a stage, a transfer ~15 ms) so the
    schedule is non-trivial.  Returns (stages, links, loads)."""
    fl = decode_flops_per_token(cfg, prompt_len) * gen_len
    base_speed = fl * batch / 0.05
    base_bw = 4.0 * prompt_len * batch / 0.015
    stages = [StageSpec(f"pod{i}", base_speed / (1 + 0.15 * i)) for i in range(4)]
    links = [LinkSpec(base_bw, 50e-6)] * 3
    loads = [BatchSpec(num_samples=batch, bytes_per_sample=4.0 * prompt_len,
                       flops_per_sample=fl,
                       return_bytes_per_sample=return_ratio * 4.0 * prompt_len)
             for _ in range(n_loads)]
    return stages, links, loads


def _plan(args, cfg: ArchConfig, dev: torch.device) -> None:
    """The ``--plan`` block: one plan, a replanning tick, the auto-T sweep.
    Makespans print in ms to 12 significant digits."""
    from repro_torch.api import Policy, Session
    from repro_torch.core.planner import Planner

    backend = PLAN_BACKENDS.get(args.plan_backend, args.plan_backend)
    stages, links, loads = plan_inputs(cfg, args.batch, args.prompt_len, args.gen_len,
                                       args.plan, args.return_ratio)
    # one Session is the whole planning state: backend handles, solution
    # cache, and the coalescing submit queue; the engine runs on --device
    session = Session(policy=Policy(installments=2, backend=backend), device=dev)
    planner = Planner(stages, links, topology=args.topology, session=session)
    plan = planner.plan(loads, q=2, backend=backend)
    art = plan.artifact
    print(f"DLT plan for {args.plan} request batches over 4 {args.topology} stages: "
          f"makespan={plan.makespan * 1e3:.12g}ms (backend={art.backend}, artifact "
          f"v{art.version}, {len(art.to_json())} JSON bytes)")
    for t, (n, j) in enumerate(plan.cells):
        print(f"  load {n} installment {j}: "
              f"requests/stage={[int(x) for x in plan.samples[t]]}")
    # a replanning tick with an unchanged platform state: with an engine
    # backend this is a pure solution-cache hit, visible in the artifact
    plan2 = planner.plan(loads, q=2, backend=backend)
    tick = (f"replan tick: makespan={plan2.makespan * 1e3:.12g}ms "
            f"cache_hit={plan2.artifact.cache_hit}")
    if backend in ("torch", "cuda"):
        st = session.stats().get("cache", {})
        tick += f" cache={st.get('hits', 0)} hit / {st.get('misses', 0)} miss"
    print(tick)
    if args.auto_t:
        # cost-aware installment chooser: one bulk sweep up the q ladder
        res = planner.plan_auto_T(loads, t_max=args.auto_t,
                                  installment_cost=args.installment_cost, backend=backend)
        swept = ", ".join(f"q={q}: {res.makespans[q] * 1e3:.12g}ms"
                          f"+{(res.costs[q] - res.makespans[q]) * 1e3:.12g}ms"
                          for q in sorted(res.makespans))
        print(f"auto-T sweep (installment cost {args.installment_cost * 1e3:.12g}ms): {swept}")
        print(f"  -> T* = {res.t_star} installments/load, "
              f"cost-aware makespan {res.costs[res.t_star] * 1e3:.12g}ms")


if __name__ == "__main__":
    main()
