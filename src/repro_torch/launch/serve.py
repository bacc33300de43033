"""Serving entry point of the port: batched prefill + token-by-token decode of a
decoder LM of the dense, ssm (Mamba-2) or hybrid (Hymba) family, on the CUDA
card unless ``--device cpu`` is given.

The port of the reference's decode demo (``repro.launch.serve``, without
``--serve``).  The prefill and decode run in the hand-written kernels
(``attention_impl="cuda"``): per layer, one flash-attention launch and one
SSD-scan launch in the prefill (whichever the family has), and one
decode-attention launch per step.  The Mamba decode step is plain PyTorch.
The decode loop keeps the cache length and the sampled tokens on the
device, so it never waits for the host until the end.

  python -m repro_torch.launch.serve --arch llama3.2-3b --batch 4 \\
      --prompt-len 512 --gen-len 32                       # on the card
  python -m repro_torch.launch.serve --arch mamba2-2.7b --batch 4 \\
      --prompt-len 512 --gen-len 32                       # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --smoke --device cpu --batch 2 --prompt-len 16 --gen-len 4

``--plan``/``--auto-t`` (and their options) need the port's ``Planner`` and
``api.Session``, and ``--serve`` (and its options) the port's plan server; they
fail with the roadmap item that brings them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.config import ArchConfig, ShardingPolicy, get_arch, smoke_variant
from repro_torch.convert import resolve_device
from repro_torch.data import make_batch
from repro_torch.models import Transformer, init_params, prefill
from repro_torch.obs import span
from repro_torch.runtime import make_serve_step

__all__ = ["main", "serve_policy", "load_model", "prompt_tokens", "generate", "ServeResult"]

# flags of the reference's CLI that need modules the port does not have yet
_LATER = {
    "plan": "A.6", "plan_backend": "A.6", "topology": "A.6", "return_ratio": "A.6",
    "auto_t": "A.6", "installment_cost": "A.6",
    "serve": "A.9", "serve_port": "A.9", "serve_workers": "A.9", "serve_store": "A.9",
    "serve_queue_limit": "A.9", "serve_deadline": "A.9", "serve_shards": "A.9",
    "serve_duration": "A.9",
}
_WHAT = {"A.6": "the port's Planner and api.Session", "A.9": "the port's plan server"}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None,
                    help="model architecture of the dense, ssm or hybrid family (e.g. "
                         "llama3.2-3b, mamba2-2.7b, hymba-1.5b)")
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
    for flag in ("--plan", "--auto-t", "--serve-port", "--serve-workers",
                 "--serve-queue-limit", "--serve-shards"):
        ap.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    for flag in ("--return-ratio", "--installment-cost", "--serve-deadline",
                 "--serve-duration"):
        ap.add_argument(flag, type=float, default=None, help=argparse.SUPPRESS)
    for flag in ("--plan-backend", "--topology", "--serve-store"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--serve", action="store_const", const=True, default=None,
                    help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    for name, item in _LATER.items():
        if getattr(args, name) is not None:
            ap.error(f"--{name.replace('_', '-')} needs {_WHAT[item]}, which the port does "
                     f"not have yet (ROADMAP {item})")
    if args.arch is None:
        ap.error("--arch is required")
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
        _run(args)
    finally:
        if tracer is not None:
            from repro_torch.obs import activate

            activate(prev_tracer)
            tracer.save(args.trace_out)
            print(f"trace: {args.trace_out} ({len(tracer)} spans)")
        if metrics_server is not None:
            metrics_server.shutdown()


def serve_policy(prompt_len: int, attention_impl: str = "cuda") -> ShardingPolicy:
    """The demo's policy: the hand-written attention kernels, chunks of the
    prompt length up to 1024 for the chunked implementation."""
    return ShardingPolicy(attention_impl=attention_impl, attn_chunk=min(1024, prompt_len))


def load_model(cfg: ArchConfig, seed: int, device) -> Transformer:
    """Seeded float32 weights on ``device`` (the reference's demo serves in
    float32)."""
    return init_params(cfg, seed=seed, dtype=torch.float32, device=device)


def prompt_tokens(cfg: ArchConfig, batch: int, prompt_len: int, seed: int, device):
    """The demo's prompts: ``make_batch`` tokens [batch, prompt_len], int32,
    on ``device`` (``None``: the card, raising without one)."""
    toks = make_batch(cfg, batch, prompt_len, step=0, seed=seed)["tokens"]
    return torch.from_numpy(toks).to(resolve_device(device))


@dataclasses.dataclass
class ServeResult:
    """What :func:`generate` produced: the prefill's logits [B, S, V] and
    the cache after the last step, the generated tokens [B, gen_len] (one
    per decode step), each step's logits [B, 1, V] when asked for, and the
    host times of the prefill and of the decode loop (each ending in a
    synchronised device)."""

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
             *, greedy: bool = True, temperature: float = 1.0, seed: int = 0,
             keep_logits: bool = False) -> ServeResult:
    """Prefill ``prompt`` [B, S], then ``gen_len`` decode steps, each fed the
    token sampled from the previous logits (argmax, or a draw at
    ``temperature`` from a generator seeded with ``seed + 1``)."""
    dev = prompt.device
    gen = None
    if not greedy:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)

    def sample(lg):
        if greedy:
            return lg[:, -1:].argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(lg[:, -1, :] / max(temperature, 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)

    B, S = prompt.shape
    _sync(dev)
    t0 = time.perf_counter()
    with span("serve.prefill", batch=B, prompt_len=S):
        logits, cache, pos = prefill(model, cfg, policy, prompt, max_len=S + gen_len)
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
    tokens = torch.cat(out, dim=1) if out else torch.zeros(B, 0, dtype=torch.int32, device=dev)
    return ServeResult(logits, cache, tokens, step_logits, t_prefill, t_decode)


def _run(args):
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    policy = serve_policy(args.prompt_len)
    model = load_model(cfg, args.seed, dev)
    prompt = prompt_tokens(cfg, args.batch, args.prompt_len, args.seed, dev)
    res = generate(model, cfg, policy, prompt, args.gen_len, greedy=args.greedy,
                   temperature=args.temperature, seed=args.seed)
    n_tok = args.gen_len * args.batch
    print(f"arch={cfg.name} prefill {args.batch}x{args.prompt_len} in {res.prefill_s:.2f}s; "
          f"decoded {n_tok} tokens in {res.decode_s:.2f}s "
          f"({n_tok / max(res.decode_s, 1e-9):.1f} tok/s on {dev.type})")
    print("sample tokens:", res.tokens[0, :8].tolist())


if __name__ == "__main__":
    main()
