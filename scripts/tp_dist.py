"""Tensor parallelism (a model axis wider than 1) and expert parallelism
(an MoE model's experts split over the data ranks) over every rank of a
``torchrun`` world: every family's cells (``launch/specs.build_cell``) on
``(data, model)`` meshes, held against one card.

    torchrun --nproc-per-node 4 scripts/tp_dist.py                   # 4 cards: NCCL
    PYTHONPATH=src torchrun --nproc-per-node 4 scripts/tp_dist.py --device cpu --smoke \\
        --seq 32 --prompt 32 --gen 4 --check-batch 4 --serve-batch 4 --lr 1e-3  # the CPU: gloo

``--parts`` picks the parts, run in the order given (default: all
twenty-seven, (i)-(xxvii)).  The
dense family's: (i) ``train``: ``--check-arch`` (llama3.2-3b) at full width
and depth in float32: the train cell's step on each of ``--meshes`` (``1x4``
and ``2x2``: data x model), ``--check-steps`` steps of the global batch
``--check-batch`` x ``--seq`` from the synthetic stream (each data rank its
rows), then rank 0 alone, unsharded, on the same batches from the same
seed: the losses and grad norms within 1e-5 relative, the parameters within
C.18's bar (all within 2 lr; at most 1 element in 10^4 beyond rtol 2e-3 /
atol 2e-4).  Recorded a mesh: ms a step, peak GB a rank, and one more step
under ``CommDebugMode`` (the collectives by op, with their bytes).
(ii) ``serve``: ``--serve-arch`` (mistral-large-123b) at full width and
depth in bfloat16 on ``(1, N)``: the weights drawn sharded
(``init_sharded``: no rank holds more than a leaf whole), the prefill cell
on ``--serve-batch`` x ``--prompt`` tokens, then ``--gen`` greedy
decode-cell steps against a cache of prompt + gen entries.  Recorded:
prefill s, decode ms a step, peak GB a rank, the collectives of a prefill
and of a decode step, and the profiler's busy share of each.  (iii)
``check``: ``--serve-arch`` cut to ``--check-layers`` layers at full width
in float32: the prefill and decode cells on ``(1, N)`` against the same
layers unsharded on rank 0 (the same draws): logits and caches within 1e-4
of their max |value|.
The moe family's: (iv) ``moe-train``: (i) for deepseek-v2-lite-16b (MLA,
gshard at cf 1.25) cut to 4 layers, the aux losses held too.  (v)
``moe-serve``: deepseek-v2-lite-16b at full size in float32 on ``(1, N)``
against rank 0 alone: the prefill and ``--gen`` decode steps, logits and
latent caches within 1e-4 of their max |value|.  (vi) ``kimi-serve``: (ii)
for kimi-k2-1t-a32b cut to 6 layers.  (vii) ``kimi-check``: kimi-k2-1t-a32b
cut to 2 layers and 64 routed experts in float32, as (v) with
``--check-gen`` decode steps.
Routing flips (ROADMAP C.16): in (iv), (v) and (vii) each MoE layer's
routing is recorded on both sides; every (token, layer) whose top-k
differs is reported with its margin (the k-th minus the (k+1)-th router
probability, the larger of the two sides').  A token is touched where it
flipped, or where gshard's capacity keeps other slots of it on the two
sides (an earlier token's flip moved an expert's count: the flip reaches
other sequences so).  A flip is primary unless a token of its sequence
was touched at an earlier layer and the same or an earlier position (or,
in training, an earlier step flipped); a primary flip whose margin is
above 1e-6 fails the run (no near-tie).  The bars apply where nothing was
touched: in serving, each sequence's logits and caches before its first
touched position; in training, the steps before the first flip, and the
whole first step too, with or without a flip.
The ssm, hybrid, audio and vlm families' (mamba2-2.7b, hymba-1.5b,
musicgen-medium, paligemma-3b): (viii), (x), (xii), (xiv)
``<family>-train``: (i) for the family's model cut to 2 layers.  (ix),
(xi), (xiii), (xv) ``<family>-serve``: the model at full depth in float32
on ``(1, N)`` against rank 0 alone, as (v), on a prompt of ``--prompt``
positions (paligemma: its 256 patches, then text; hymba: twice its
window, 2,048 for its window of 1,024, so the ring cache wraps in the
prefill and again while decoding), ``--check-gen`` decode steps: the
logits, every cache leaf after each decode step (the KV
ring, the Mamba conv window and state) within 1e-4 of their max |value|,
and the two sides' greedy tokens equal; recorded as (ii) the collectives
and the profile of one more prefill and decode step.
Expert parallelism's (each on ``2x2`` and ``4x1``: the
experts split on E over the data ranks, each expert's d_ff over 'model';
each data rank serves its rows of the batch): (xvi) ``moe-ep-train``: (iv)
on those meshes.  (xvii) ``moe-ep-serve``: (v) on each, the collectives
and profile of one more prefill and decode step recorded.  (xviii)
``kimi-ep-check``: (vii) on each.  (xix) ``kimi-ep-serve``: (vi) on the
last mesh (96 of kimi's 384 experts a rank, drawn as slabs of the rank's
rows).
The activation layouts' (the reference's hillclimb variants,
:data:`VARIANTS`, each run beside the default on the same draws; the one
card's side under the variant's values, a last-position variant held to
the whole prefill's last row): (xx) ``layout-train``: (i) under ``sp``,
``noremat+sp`` and ``noseqshard``.  (xxi) ``layout-serve``: (iii) under
``last_logit``, ``noseqshard``, ``sp``, ``sp+last``, ``sp_noq`` and
``sp+last+bf16``, then (ii) under ``sp+last``.  (xxii)
``layout-families``: the ssm, hybrid, audio and vlm families' models at
FAMILY_TRAIN_LAYERS layers trained (on the first of ``--meshes``) under
``sp`` and served on (1, N) under ``sp+last`` and ``noseqshard`` (hymba on
twice its window), then deepseek-v2-lite-16b at MOE_TRAIN_LAYERS layers
trained and served on ``--meshes`` under ``sp`` and ``dense``.
The hand-written kernels and the int8 KV cache (:data:`VARIANTS` ``cuda``,
``int8``, ``cuda+int8``; the one card's side under the same values):
(xxiii) ``kernels-serve``: llama3.2-3b, mamba2-2.7b, hymba-1.5b (on twice
its window), musicgen-medium and paligemma-3b at full width and depth in
float32 on (1, N) under ``cuda``, and llama3.2-3b on ``2x2``, as the
families' serving parts; then ``--serve-arch`` at full size in bfloat16
under ``cuda`` and ``cuda+int8`` beside the default, as (ii).  (xxiv)
``int8-serve``: llama3.2-3b and hymba-1.5b (twice its window) with the int8
cache on (1, N), with and without the kernels, against one card with the
int8 cache: a K/V value can quantize a step apart on the two sides
(ROADMAP C.5), so the one card starts each decode step from the sharded
side's cache; the int8 leaves at most a step apart (the flips counted), a
row's logits within 1e-3 in the step its new entry flipped.  Every serving
run counts each rank's kernel launches in the prefill and in the decode
steps (``launches``): under ``cuda`` on the cards one flash launch a layer
with attention and one SSD launch a Mamba layer in the prefill, one decode
launch a layer with attention and step, exactly.
The experts over the model axis (:data:`VARIANTS` ``expert_model``:
``expert_axis="model"``, ``expert_ff_axis="data"``, E over 'model' and each
expert's d_ff over 'data'; each rank's expert slabs checked, and the
expert exchanges recorded apart by kind, the gathers and the returns):
(xxv) ``expert-model-train``: (iv) on ``1x4``, ``2x2`` and ``4x1``, then
kimi-k2-1t-a32b cut as (vii) on ``1x4`` and ``2x2`` against the default
layout on the same mesh (no card holds its float32 training state).
(xxvi) ``expert-model-serve``: (v) on ``1x4`` and ``2x2`` with every cache
leaf held after each decode step and the greedy tokens equal, then (vi) on
(1, N) beside the default layout (the weights drawn again in each).
(xxvii) ``kimi-kernels-serve``: kimi-k2-1t-a32b's attention (64 heads on 8
KV heads of head dim 112, which the kernels run at width 128) through the
kernels: (vii)'s cut in float32 on (1, N) under ``cuda`` against rank 0
alone under ``cuda``, as (xxiii) (every cache leaf after each decode step,
greedy tokens equal, launches exact on every rank); then (vi) under
KERNEL_SERVE, as (xxiii) runs ``--serve-arch``.  Its head dim is kept in
the ``--smoke`` variant.
The one-card side of (v), (vii), (xvii), (xviii) and the serving parts
(ix)-(xv), (xxi)-(xxiii), (xxvii) is fed the sharded side's greedy tokens.
Rank 0 prints one JSON line (also written to ``--out``, after each part)
with the cards' name and power limit, and exits non-zero on a missed bar.
Every part ends with the ranks' one decision (an all-reduce of whether
each raised, which is also where the other ranks wait for rank 0's
one-card comparison): a part that raised on every rank is recorded as
failed with its error and the next part runs; where the ranks disagree,
the run stops there (a rank that raised alone may have left the others
in a collective of that part).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.config import (ShapeConfig, ShardingPolicy, TrainConfig, get_arch,  # noqa: E402
                                smoke_variant)
from repro_torch.data import SyntheticStream, make_batch  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.models import (decode_step, extend_cache, greedy_tokens,  # noqa: E402
                                init_params, prefill)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.moe import exchange_tally  # noqa: E402
from repro_torch.runtime import make_train_state, make_train_step  # noqa: E402
from repro_torch.runtime.profile import (CommBytes, busy_ms, device_time_by_group,  # noqa: E402
                                         observe_routes, routing_flips)
from repro_torch.runtime.sharding import init_sharded, is_expert_leaf, shard_model  # noqa: E402

LOSS_RTOL = 1e-5
SERVE_TOL = 1e-4
# the moe parts' models and cuts (PERF.md §4): (iv) 4 layers, so that one card
# holds the float32 state to compare with; (vi) the most layers that keep a
# rank's bfloat16 weights near 55 GB; (vii) 2 layers and 64 of 384 experts in
# float32 (~33 GB whole)
MOE, MOE_TRAIN_LAYERS = "deepseek-v2-lite-16b", 4
KIMI, KIMI_SERVE_LAYERS, KIMI_CHECK = "kimi-k2-1t-a32b", 6, (2, 64)
# the ssm, hybrid, audio and vlm families' parts (viii)-(xv): a train part at
# FAMILY_TRAIN_LAYERS layers (2, so that all fifteen parts stay near 15 minutes on
# four cards) and a serving part at full depth each
FAMILIES = {"ssm": "mamba2-2.7b", "hybrid": "hymba-1.5b", "audio": "musicgen-medium",
            "vlm": "paligemma-3b"}
FAMILY_TRAIN_LAYERS = 2
# expert parallelism's parts (xvi)-(xix): the experts split on E over the data
# ranks, d_ff over 'model' on (2, 2); (xix) on the last mesh alone
EP_MESHES = "2x2,4x1"
# the layout parts (xx)-(xxii): the reference's hillclimb variants
# (benchmarks/hillclimb.py) of the activation layouts, as policy overrides
VARIANTS = {
    "default": {},
    "last_logit": {"prefill_last_logit_only": True},
    "noseqshard": {"shard_seq_attn": False, "qkv_feature_shard": False},
    "sp": {"sp_activations": True},
    "sp+last": {"sp_activations": True, "prefill_last_logit_only": True},
    "sp_noq": {"sp_activations": True, "qkv_feature_shard": False},
    "sp+last+bf16": {"sp_activations": True, "prefill_last_logit_only": True,
                     "logits_fp32": False},
    "noremat+sp": {"remat": "none", "sp_activations": True, "qkv_feature_shard": False},
    "dense": {"moe_impl": "dense"},
    # the kernels and the int8 KV cache (parts (xxiii), (xxiv))
    "cuda": {"attention_impl": "cuda"},
    "int8": {"kv_cache_dtype": "int8"},
    "cuda+int8": {"attention_impl": "cuda", "kv_cache_dtype": "int8"},
    # the experts over 'model', each one's d_ff over 'data' (parts (xxv), (xxvi))
    "expert_model": {"expert_axis": "model", "expert_ff_axis": "data"},
}
LAYOUT_TRAIN = ("default", "sp", "noremat+sp", "noseqshard")
LAYOUT_SERVE = ("default", "last_logit", "noseqshard", "sp", "sp+last", "sp_noq", "sp+last+bf16")
# part (xxiii)'s models at full width and depth under "cuda" (llama also on 2x2),
# then --serve-arch at full size in bfloat16 under these beside the default
KERNEL_ARCHS = ("llama3.2-3b", *FAMILIES.values())
KERNEL_SERVE = ("default", "cuda", "cuda+int8")
# part (xxiv)'s models, each with the int8 cache with and without the kernels
INT8_ARCHS = ("llama3.2-3b", "hymba-1.5b")
INT8_SERVE = ("int8", "cuda+int8")
FLIP_TOL = 1e-3  # a row whose new int8 entry quantized a step apart (ROADMAP C.5)
# the experts over the model axis, parts (xxv), (xxvi): deepseek trained on these
# meshes against one card, in two groups (rank 0's host keeps every run's parameters
# after each step, 11 GB each); kimi (2 layers, 64 experts) on the first group against
# the default layout (one card cannot hold its float32 AdamW state: 8.3 G parameters x
# 16 B), and deepseek and kimi served on it
EXPERT_MODEL_MESHES = ("1x4,2x2", "4x1")


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


def _data_rows(t, mesh, dim: int = 0):
    """``t``'s rows of every data rank joined along ``dim`` in their order,
    on every rank (``t`` itself on a data axis of 1)."""
    n = mesh.size(0)  # the ('data', 'model') mesh's data axis
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group("data"))
    return torch.cat(parts, dim=dim)


def _weights_gb(model) -> float:
    """The weights this rank holds, GB."""
    return sum((p.to_local() if isinstance(p, DTensor) else p).numel() * p.element_size()
               for p in model.parameters()) / 1e9


def _whole(model, lead: bool) -> dict:
    """Every parameter whole on rank 0's host (a gather a leaf)."""
    out = {}
    for n, p in model.named_parameters():
        t = p.full_tensor() if isinstance(p, DTensor) else p
        if lead:
            out[n] = t.detach().to("cpu", copy=True)
    return out


def _full(tree, mesh):
    """A cache tree's leaves [L, B, ...] whole (nested groups included):
    gathered over 'model', every data rank's rows joined."""
    if isinstance(tree, dict):
        return {k: _full(v, mesh) for k, v in tree.items()}
    return _data_rows(tree.full_tensor() if isinstance(tree, DTensor) else tree, mesh, 1)


def _flat(tree, prefix=""):
    """A cache tree's leaves by dotted name, copied to the host."""
    if isinstance(tree, dict):
        return {n: t for k, v in tree.items() for n, t in _flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree.detach().to("cpu", copy=True)}


def _cfg(opts, arch: str, layers: int | None = None, experts: int | None = None):
    cfg = get_arch(arch)
    if opts.smoke:
        cfg = smoke_variant(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return cfg


@contextlib.contextmanager
def _observe_seq_losses(record: dict, key):
    """Record each training forward's cross-entropy by sequence of this
    rank's rows while inside: ``record[key()]`` [rows], on the host (the
    loss's own logits, whole)."""
    ce = transformer.cross_entropy

    def observed(logits, labels, mask=None):
        with torch.no_grad():
            lg = (logits.full_tensor() if isinstance(logits, DTensor) else logits).float()
            nll = torch.logsumexp(lg, dim=-1) - lg.gather(-1, labels.long()[..., None])[..., 0]
            record[key()] = nll.mean(dim=-1).cpu()
        return ce(logits, labels, mask)

    transformer.cross_entropy = observed
    try:
        yield record
    finally:
        transformer.cross_entropy = ce


def _global_rows(record: dict, mesh) -> dict | None:
    """Every data rank's records (a tensor, or a tuple of tensors, of its
    rows) joined in the global batch's order, on rank 0 (``None``
    elsewhere)."""
    parts = _gather((mesh.get_local_rank("data"), mesh.get_local_rank("model"), record))
    if dist.get_rank() != 0:
        return None
    rows = [r for d, m, r in sorted(parts, key=lambda x: x[:2]) if m == 0]

    def join(key):
        if isinstance(rows[0][key], tuple):
            return tuple(torch.cat([r[key][i] for r in rows]) for i in range(len(rows[0][key])))
        return torch.cat([r[key] for r in rows])

    return {k: join(k) for k in rows[0]}


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


def _train_steps(step_fn, state, stream, rows, dev, moe: bool, lead: bool, snap: bool = True):
    """A step of ``step_fn`` on ``rows`` of each of ``stream``'s batches:
    each step's metrics, with ``snap`` the parameters whole after each (on
    ``lead``'s host), and with ``moe`` each step's routing and
    cross-entropy by sequence (this rank's rows)."""
    steps, snaps, routes, seq_loss, now = [], [], {}, {}, {}
    watch = contextlib.ExitStack()
    if moe:
        watch.enter_context(observe_routes(state.params, routes, lambda: (now["step"], None)))
        watch.enter_context(_observe_seq_losses(seq_loss, lambda: now["step"]))
    with watch:
        for i, batch in enumerate(stream):
            now["step"] = i
            batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch.items()}
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            loss = float(m["loss"])  # waits for the step
            steps.append({"loss": loss, "aux": float(m["aux"]),
                          "grad_norm": float(m["grad_norm"]),
                          "ms": 1e3 * (time.perf_counter() - t0)})
            if snap:
                snaps.append(_whole(state.params, lead))
    return state, steps, snaps, routes, seq_loss


def _params_within_c18(got: dict, want: dict, lr: float) -> dict:
    """C.18's bar: all within 2 lr, at most 1 element in 10^4 beyond rtol
    2e-3 / atol 2e-4."""
    worst, outside, total = 0.0, 0, 0
    for n, w in want.items():
        diff = (got[n] - w).abs()
        worst = max(worst, float(diff.max()))
        outside += int((diff > 2e-4 + 2e-3 * w.abs()).sum())
        total += w.numel()
    return dict(param_max_abs=worst, param_outside_bar=outside, param_total=total,
                ok=worst <= 2 * lr and outside <= total // 10_000)


def _variant(base: ShardingPolicy, name: str) -> ShardingPolicy:
    return dataclasses.replace(base, **VARIANTS[name])


def _layout(policy: ShardingPolicy) -> tuple:
    """What of a policy places the weights: its expert axes."""
    return policy.expert_axis, policy.expert_ff_axis


def _one_card(policy: ShardingPolicy) -> ShardingPolicy:
    """The one-card side's policy of a variant: its values (the experts'
    dispatch, the logits' dtype, the attention's implementation: the same
    kernels, the KV cache's dtype), the layouts' defaults and every
    prefill's logits whole (a last-position variant is held to their last
    row)."""
    return ShardingPolicy(attn_chunk=policy.attn_chunk, moe_impl=policy.moe_impl,
                          logits_fp32=policy.logits_fp32,
                          attention_impl=policy.attention_impl,
                          kv_cache_dtype=policy.kv_cache_dtype)


def _launches(cfg, policy, gen: int, counts: dict, dev) -> dict:
    """A rank's kernel launches in a prefill and ``gen`` decode steps
    against what the path must launch under ``"cuda"`` on the card: one
    flash launch a layer with attention and one SSD launch a Mamba layer in
    the prefill, one decode launch a layer with attention and step (MLA
    none); none under the plain paths, and none counted on the CPU."""
    on = policy.attention_impl == "cuda" and dev.type == "cuda"
    attn = cfg.num_layers if on and cfg.has_attention and cfg.mla is None else 0
    ssm = cfg.num_layers if on and cfg.has_ssm else 0
    want = {"prefill": {"flash_attention": attn, "ssd_scan": ssm, "decode_attention": 0},
            "decode": {"flash_attention": 0, "ssd_scan": 0, "decode_attention": attn * gen}}
    by_rank = _gather({stage: {k: counts[stage][k] for k in want[stage]} for stage in want})
    return dict(by_rank=by_rank, want=want, ok=all(g == want for g in by_rank))


def _slabs(model, cfg, mesh, policy) -> dict | None:
    """Under ``expert_axis="model"``: whether every rank holds exactly its
    [E / M, D, F / D_data] slab of each routed expert leaf ([E / M, F /
    D_data, D] for ``w_down``), all 3 a layer; None under another layout."""
    if cfg.moe is None or policy.expert_axis != "model":
        return None
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    up = (E // mesh.size(1), D, F // mesh.size(0))
    held = [(n, tuple(p.to_local().shape)) for n, p in model.named_parameters()
            if is_expert_leaf(n)]
    bad = [n for n, shape in held
           if shape != (up if n.endswith(("w_gate", "w_up")) else (up[0], up[2], up[1]))]
    by_rank = _gather((len(held), len(bad)))
    return dict(slab=list(up), leaves_and_mismatched_by_rank=by_rank,
                ok=all(n == 3 * cfg.num_layers and not b for n, b in by_rank))


def _train_check(opts, dev, rank, cfg, meshes: str | None = None,
                 variants: tuple = ("default",), against: str | None = None) -> dict:
    """Parts (i), (iv), (xxv) and the layout parts' training: the train
    cell on each mesh under each of ``variants`` (:data:`VARIANTS`; runs
    keyed by mesh, or ``"<variant> <mesh>"`` beside the default) against
    rank 0 unsharded, once for each one-card policy the variants need; or
    (``against``, a variant) each run against that variant's on the same
    mesh, no card holding the model's training state (no parameter
    snapshots then: its leaves are compared by the metrics alone).  An MoE
    model's routing is compared too: the losses, aux losses and grad norms
    are held at the first step and at every step before the first flip,
    the parameters after the last step held, and at a flip in the first
    step the cross-entropy of each sequence without one too (after a later
    flip, the parameters already differ by C.18's lr-sized moves:
    reported).  Recorded a run: ms a step, peak GB a rank, the collectives
    of one more step and (an MoE model) its expert exchanges by kind, and
    under ``expert_axis="model"`` each rank's expert slabs checked."""
    base = ShardingPolicy(attn_chunk=min(1024, opts.seq))
    tcfg = TrainConfig(lr=opts.lr, warmup_steps=0, total_steps=opts.check_steps + 1)
    shape = ShapeConfig("train", opts.seq, opts.check_batch, "train")
    world = dist.get_world_size()
    moe = cfg.moe is not None
    n_steps = opts.check_steps
    snap = against is None

    def batches():
        stream = SyntheticStream(cfg, opts.check_batch, opts.seq, seed=0)
        return [next(stream) for _ in range(n_steps + 1)]

    runs, policies = {}, {}
    for name, spec in ((n, m) for n in variants for m in (meshes or opts.meshes).split(",")):
        policy = _variant(base, name)
        key = spec if variants == ("default",) else f"{name} {spec}"
        policies[key] = policy
        data, model_ax = map(int, spec.split("x"))
        if data * model_ax != world:
            raise SystemExit(f"mesh {spec} is not a world of {world}")
        mesh = init_device_mesh(dev.type, (data, model_ax), mesh_dim_names=("data", "model"))
        _peak_reset(dev)
        t0 = time.perf_counter()
        model = init_sharded(cfg, mesh, seed=0, dtype=torch.float32, device=dev, policy=policy)
        slabs = _slabs(model, cfg, mesh, policy)
        state = make_train_state(shard_model(model.requires_grad_(True), mesh, policy), tcfg)
        _sync(dev)
        init_s = time.perf_counter() - t0
        cell = build_cell(mesh, cfg, shape, policy, tcfg, torch.float32)
        d = mesh.get_local_rank("data")
        rows = slice(d * opts.check_batch // data, (d + 1) * opts.check_batch // data)
        *stream, extra = batches()
        state, steps, snaps, routes, seq_loss = _train_steps(cell.fn, state, stream, rows, dev,
                                                             moe, rank == 0, snap)
        comm = CommBytes()
        with comm, exchange_tally() as exchanges:
            state, _ = cell.fn(state, {k: torch.from_numpy(v[rows]).to(dev)
                                       for k, v in extra.items()})
            _sync(dev)
        runs[key] = dict(steps=steps, init_s=init_s, peak_gb_by_rank=_gather(_peak_gb(dev)),
                         weights_gb_a_rank=_weights_gb(state.params),
                         collectives_per_step=comm.counts(),
                         expert_exchanges_per_step=exchanges if moe else None,
                         expert_slabs=slabs, snaps=snaps,
                         routes=_global_rows(routes, mesh) if moe else None,
                         seq_loss=_global_rows(seq_loss, mesh) if moe else None)
        del state, model, cell
        _release(dev)
    out = None
    if rank == 0:
        ones = {}
        for one in (() if against else dict.fromkeys(_one_card(p) for p in policies.values())):
            _peak_reset(dev)
            model = init_params(cfg, seed=0, dtype=torch.float32, device=dev).requires_grad_(True)
            state, *ones[one] = _train_steps(
                make_train_step(cfg, one, tcfg), make_train_state(model, tcfg), batches()[:-1],
                slice(None), dev, moe, True)
            ones[one].append(_peak_gb(dev))
            del state, model
            _release(dev)
        ok = True
        keys = ("loss", "aux", "grad_norm") if moe else ("loss", "grad_norm")
        for spec, run in runs.items():
            if against:
                if spec.startswith(f"{against} "):
                    continue
                other = runs[f"{against} {spec.split(' ', 1)[1]}"]
                single, want, routes, seq_loss = (other["steps"], other["snaps"], other["routes"],
                                                  other["seq_loss"])
                run["against"] = against
            else:
                single, want, routes, seq_loss, single_peak = ones[_one_card(policies[spec])]
                run["single_policy"] = _one_card(policies[spec]).moe_impl
            flips = (routing_flips(run["routes"], routes, opts.check_batch, opts.seq, cfg) if moe
                     else None)
            first = None if flips is None else flips["first_group"]
            # the steps before the first flip, and the first step whatever it holds: a
            # near-tie flip there moves its loss, aux loss and grad norm by less than the bar
            held = n_steps if first is None else max(first, 1)
            rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(run["steps"], single)]
                   for k in keys}
            snaps = run["snaps"]
            params = (_params_within_c18(snaps[held - 1], want[held - 1], opts.lr)
                      if held and snap else None)
            seqs = None
            if first is not None:  # the flipped step: its sequences without a flip
                got, ref = run["seq_loss"][first], seq_loss[first]
                keep = [b for b in range(len(ref)) if b not in flips["flipped_seqs"][first]]
                seqs = dict(step=first, sequences=keep, held=first == 0 and bool(keep),
                            rel_diff=float(((got - ref).abs() / ref.abs())[keep].max())
                            if keep else None)
            run.update(rel_diff=rel, steps_held=held, params_after_step=held - 1 if held else None,
                       params=params, flipped_step_sequences=seqs, flips=flips,
                       ok=(max((max(v[:held], default=0.0) for v in rel.values())) <= LOSS_RTOL
                           and (params is None or params["ok"])
                           and (seqs is None or not seqs["held"]
                                or seqs["rel_diff"] <= LOSS_RTOL)
                           and (flips is None or flips["ok"])
                           and (run["expert_slabs"] is None or run["expert_slabs"]["ok"])))
            ok = ok and run["ok"]
        for run in runs.values():
            for k in ("snaps", "routes", "seq_loss"):
                run.pop(k)
            run.setdefault("ok", run["expert_slabs"] is None or run["expert_slabs"]["ok"])
        out = dict(arch=cfg.name, layers=cfg.num_layers, experts=cfg.moe.num_experts if moe
                   else None, dtype="float32", global_batch=opts.check_batch, seq=opts.seq,
                   lr=opts.lr, meshes=runs, variants=list(variants),
                   policies={k: VARIANTS[k] for k in variants}, against=against,
                   ok=ok and all(r["ok"] for r in runs.values()))
        if not against:
            out.update(single=single, single_peak_gb=single_peak)
    return out


def _prompt(cfg, batch: int, seq: int, step: int, dev) -> dict:
    """The model inputs of a prompt of ``seq`` positions from the synthetic
    stream: its tokens ([B, S], audio [B, S, K]) and vlm's patches (the
    text then takes ``seq - num_patches`` of them)."""
    batch = make_batch(cfg, batch, seq, step=step)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if k != "labels"}


def _serve_run(cfg, mesh, policy, model, prompt: dict, seq: int, gen: int, dev, record: bool,
               routes: dict | None = None, each_step: bool = False, first: bool = False):
    """The prefill cell on ``prompt`` (``seq`` positions), then ``gen``
    greedy decode-cell steps on a cache of seq + gen entries; the logits of
    each and the final cache (full tensors; with ``each_step`` the cache
    after every decode step, on the host, and with ``first`` the prefill's
    before them), and with ``record`` the times, collectives and profiles;
    the kernels' launches of the prefill and of the steps (``launches``).
    ``prompt`` is this data rank's rows; the logits, tokens and caches
    returned are every data rank's, joined.  ``routes``: a dict the MoE
    layers' routing of this rank's rows is recorded into.  An int8 cache
    is made with room for the steps by the prefill cell itself
    (``extend_cache`` takes no int8 cache)."""
    B = prompt["tokens"].shape[0] * mesh.size(0)  # the global batch
    int8 = policy.kv_cache_dtype == "int8"
    pre = build_cell(mesh, cfg, ShapeConfig("prefill", seq + gen if int8 else seq, B, "prefill"),
                     policy, param_dtype=model.embed.dtype)
    dec = build_cell(mesh, cfg, ShapeConfig("decode", seq + gen, B, "decode"), policy,
                     param_dtype=model.embed.dtype)
    rec: dict = {}
    now = {"step": None}
    watch = (observe_routes(model, routes, lambda: (0, now["step"])) if routes is not None
             else contextlib.nullcontext())
    steps, launches = [], {}
    with watch:
        _sync(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        lg, cache = pre.fn(model, prompt)
        nxt = greedy_tokens(lg[:, -1:])
        _sync(dev)
        rec["prefill_s"] = time.perf_counter() - t0
        launches["prefill"] = kernels.launch_counts()
        logits = [_data_rows(lg.full_tensor() if isinstance(lg, DTensor) else lg, mesh)]
        if not int8:
            cache = extend_cache(cfg, cache, seq + gen)
        if each_step and first:
            whole = _full(cache, mesh)
            steps.append(_flat(whole) if dist.get_rank() == 0 else None)
        kernels.reset_launch_counts()
        tokens, walls = [nxt], []
        for i in range(gen):
            now["step"] = i
            n = torch.tensor([seq + i], dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            lg, cache = dec.fn(model, cache, {"tokens": nxt}, n)
            nxt = greedy_tokens(lg[:, -1:])
            _sync(dev)
            walls.append(1e3 * (time.perf_counter() - t0))
            logits.append(_data_rows(lg.full_tensor() if isinstance(lg, DTensor) else lg, mesh))
            tokens.append(nxt)
            if each_step:  # gathered on every rank, kept on rank 0's host
                whole = _full(cache, mesh)
                steps.append(_flat(whole) if dist.get_rank() == 0 else None)
    launches["decode"] = kernels.launch_counts()
    rec["launches"] = _launches(cfg, policy, gen, launches, dev)
    rec["decode_ms"] = walls
    rec["decode_ms_median"] = sorted(walls[1:] or walls)[len(walls[1:] or walls) // 2]
    rec["tokens"] = _data_rows(torch.cat(tokens, dim=1), mesh).cpu().tolist()
    final = _full(cache, mesh)  # before the recorded steps below write into it again
    if record:  # one more prefill and last decode step, counted, then profiled
        last = torch.tensor([seq + gen - 1], dtype=torch.int32, device=dev)
        for name, fn in (("prefill", lambda: pre.fn(model, prompt)),
                         ("decode", lambda: dec.fn(model, cache, {"tokens": nxt}, last))):
            comm = CommBytes()
            with comm, exchange_tally() as exchanges:
                fn()
                _sync(dev)
            rec[f"{name}_collectives"] = comm.counts()
            if cfg.moe is not None:  # the expert exchanges apart, by kind
                rec[f"{name}_expert_exchanges"] = exchanges
            rec[f"{name}_profile"] = _profiled(fn, dev)
    return logits, (steps if each_step else final), rec


def _single_run(cfg, policy, model, prompt: dict, seq: int, tokens, gen: int,
                routes: dict | None = None, each_step: bool = False):
    """One card's prefill and ``gen`` decode steps, decode step i fed
    ``tokens[:, i]`` (the sharded side's greedy tokens, [B, gen + 1]): the
    logits of each, the final cache (with ``each_step`` the cache after
    every decode step, on the host), and where its own greedy token
    differed."""
    now = {"step": None}
    watch = (observe_routes(model, routes, lambda: (0, now["step"])) if routes is not None
             else contextlib.nullcontext())
    steps = []
    with watch:
        lg, cache, pos = prefill(model, cfg, policy, prompt["tokens"], prompt.get("patches"),
                                 max_len=seq + gen)
        want, own = [lg], [greedy_tokens(lg[:, -1:])]
        for i in range(gen):
            now["step"] = i
            lg, cache = decode_step(model, cfg, policy, cache, tokens[:, i:i + 1], pos + i)
            want.append(lg)
            own.append(greedy_tokens(lg[:, -1:]))
            if each_step:
                steps.append(_flat(cache))
    differ = (torch.cat(own, dim=1) != tokens).cpu()
    return want, (steps if each_step else cache), differ


def _rel_err(got, want, until: list, dim: int, first: int = 0) -> float | None:
    """max |got - want| over max |want|, both over the entries of each
    sequence b (dim 0) at the positions before ``until[b]`` (``dim`` counts
    the positions from ``first``); None where no entry is held."""
    got, want = got.float().cpu(), want.float().cpu()
    n = got.shape[dim]
    held = (first + torch.arange(n))[None, :] < torch.tensor(until)[:, None]  # [B, n]
    held = held.reshape([len(until) if d == 0 else n if d == dim else 1
                         for d in range(got.dim())]).expand_as(got)
    if not held.any():
        return None
    return float((got - want).abs()[held].max() / want.abs()[held].max())


def _mesh(dev, spec: str | None):
    """The ('data', 'model') mesh of ``spec`` ('DxM'; None: (1, world))."""
    world = dist.get_world_size()
    data, model_ax = map(int, (spec or f"1x{world}").split("x"))
    if data * model_ax != world:
        raise SystemExit(f"mesh {spec} is not a world of {world}")
    return init_device_mesh(dev.type, (data, model_ax), mesh_dim_names=("data", "model"))


def _rows_of(prompt: dict, mesh) -> dict:
    """This data rank's rows of a prompt."""
    d, n = mesh.get_local_rank("data"), mesh.size(0)
    if prompt["tokens"].shape[0] % n:
        raise ValueError(f"--serve-batch {prompt['tokens'].shape[0]} does not split over {n} "
                         "data ranks")
    return {k: v[d * v.shape[0] // n:(d + 1) * v.shape[0] // n] for k, v in prompt.items()}


def _serve(opts, dev, rank, cfg, mesh_spec: str | None = None,
           variants: tuple = ("default",)) -> dict:
    """Parts (ii), (vi), (xix) and (xxi)'s full size: a model served in
    bfloat16 on ``mesh_spec`` (default (1, N); each data rank its rows of
    the batch), its weights drawn sharded, under each of ``variants`` in
    turn on the same weights (records by variant beside the default)."""
    base = ShardingPolicy(attn_chunk=min(1024, opts.prompt))
    mesh = _mesh(dev, mesh_spec)
    prompt = _rows_of(_prompt(cfg, opts.serve_batch, opts.prompt, 0, dev), mesh)
    recs, model, drawn = {}, None, None
    for name in variants:
        policy = _variant(base, name)
        if _layout(policy) != drawn:  # the weights drawn (again) in the variant's layout
            del model
            _release(dev)
            _peak_reset(dev)
            _sync(dev)
            t0 = time.perf_counter()
            model = init_sharded(cfg, mesh, seed=0, dtype=torch.bfloat16, device=dev,
                                 policy=policy)
            _sync(dev)
            init_s, drawn = time.perf_counter() - t0, _layout(policy)
            weights_gb = _weights_gb(model)
            weights_by_rank = _gather(weights_gb)
            init_peak = _peak_gb(dev)
            slabs = _slabs(model, cfg, mesh, policy)
        _peak_reset(dev)
        logits, cache, rec = _serve_run(cfg, mesh, policy, model, prompt, opts.prompt, opts.gen,
                                        dev, record=True)
        finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
        want = [opts.serve_batch, 1 if policy.prefill_last_logit_only else opts.prompt,
                cfg.vocab_size]
        rec.update(arch=cfg.name, layers=cfg.num_layers, dtype="bfloat16",
                   mesh=f"{mesh.size(0)}x{mesh.size(1)}",
                   batch=opts.serve_batch, prompt=opts.prompt, gen=opts.gen,
                   cache_entries=opts.prompt + opts.gen, init_s=init_s,
                   weights_gb_a_rank=weights_gb, weights_gb_by_rank=weights_by_rank,
                   init_peak_gb=init_peak, serve_peak_gb_by_rank=_gather(_peak_gb(dev)),
                   logits_shape=list(logits[0].shape), finite=finite, policy=VARIANTS[name],
                   expert_slabs=slabs,
                   ok=finite and list(logits[0].shape) == want and rec["launches"]["ok"]
                   and (slabs is None or slabs["ok"]))
        recs[name] = rec
        del cache, logits
        _release(dev)
    del model
    _release(dev)
    if rank != 0:
        return None
    if variants == ("default",):
        return recs["default"]
    return dict(variants=recs, ok=all(r["ok"] for r in recs.values()))


def _serve_check(opts, dev, rank, cfg, gen: int, seed: int = 1, seq: int | None = None,
                 family: bool = False, mesh_spec: str | None = None,
                 record: bool = False, variants: tuple = ("default",)) -> dict:
    """Parts (iii), (v), (vii) and the families' serving parts: ``cfg`` in
    float32 sharded on (1, N) against rank 0 alone (the same draws), the
    one-card side fed the sharded side's tokens, on a prompt of ``seq``
    positions (default ``--prompt``); an MoE model's routing compared, each
    sequence held before its first touched position.  ``family``: every
    cache leaf held after each decode step and the greedy tokens of the two
    sides equal; ``record``: the collectives and profile of one more
    prefill and decode step recorded.
    ``mesh_spec``: the sharded side's mesh (default (1, N)); each data rank
    serves its rows of the batch.  ``variants`` (:data:`VARIANTS`): the
    sharded side runs each in turn on the same weights, the one-card side
    its values (:func:`_one_card`; a last-position variant held to the
    whole prefill's last row); records by variant beside the default."""
    seq = seq or opts.prompt
    base_policy = ShardingPolicy(attn_chunk=min(1024, seq))
    mesh = _mesh(dev, mesh_spec)
    moe = cfg.moe is not None
    prompt = _prompt(cfg, opts.serve_batch, seq, seed, dev)
    sharded, model, drawn = {}, None, None
    for name in variants:
        policy = _variant(base_policy, name)
        if _layout(policy) != drawn:  # the same draws, in the variant's layout
            del model
            _release(dev)
            model = init_sharded(cfg, mesh, seed=seed, dtype=torch.float32, device=dev,
                                 policy=policy)
            drawn = _layout(policy)
            weights_gb = _weights_gb(model)
            weights_by_rank = _gather(weights_gb)
            slabs = _slabs(model, cfg, mesh, policy)
        routes = {} if moe else None
        _peak_reset(dev)
        logits, caches, rec = _serve_run(cfg, mesh, policy, model, _rows_of(prompt, mesh), seq,
                                         gen, dev, record=record,
                                         routes=routes, each_step=family)
        peaks = _gather(_peak_gb(dev))
        routes = _global_rows(routes, mesh) if moe else None
        if rank == 0:
            logits = [lg.cpu() for lg in logits]
            caches = caches if family else [_flat(caches)]
        rec.update(expert_slabs=slabs, weights_gb_a_rank=weights_gb,
                   weights_gb_by_rank=weights_by_rank)
        sharded[name] = (policy, logits, caches, rec, peaks, routes)
        del logits, caches
        _release(dev)
    del model
    _release(dev)
    if rank != 0:
        return None
    base = init_params(cfg, seed=seed, dtype=torch.float32, device=dev)
    outs = {}
    for name, (policy, logits, caches, rec, peaks, routes) in sharded.items():
        single = {} if moe else None
        tokens = torch.tensor(rec["tokens"], dtype=torch.int32, device=dev)
        want, c, differ = _single_run(cfg, _one_card(policy), base, prompt, seq, tokens, gen,
                                      single, each_step=family)
        last = policy.prefill_last_logit_only
        if last:  # the whole prefill's last row
            want[0] = want[0][:, -1:]
        want_caches = c if family else [_flat(c)]
        flips = (routing_flips(routes, single, opts.serve_batch, seq, cfg) if moe else None)
        # each sequence held before the first position an MoE layer touched
        since = flips["first_touched"].get(0, {}) if moe else {}
        until = [since.get(b, seq + gen) for b in range(opts.serve_batch)]
        keep = [b for b in range(opts.serve_batch) if b not in since]
        errs = {"logits": [_rel_err(a, b, until, 1, seq + i - 1 if i or last else 0)
                           for i, (a, b) in enumerate(zip(logits, want))]}
        for got, ref in zip(caches, want_caches):  # [L, B, S, ...] a leaf
            for leaf, t in ref.items():
                errs.setdefault(leaf, []).append(
                    _rel_err(got[leaf].transpose(0, 1), t.transpose(0, 1), until, 2))
        errs = {k: [x for x in v if x is not None] for k, v in errs.items()}
        errs = {k: max(v) for k, v in errs.items() if v}
        outs[name] = dict(
            arch=cfg.name, layers=cfg.num_layers,
            experts=cfg.moe.num_experts if moe else None, dtype="float32",
            mesh=f"{mesh.size(0)}x{mesh.size(1)}", batch=opts.serve_batch, prompt=seq,
            gen=gen, caches_held=len(caches), rel_err=errs, sequences_held=keep,
            held_until=until, flips=flips, serve_peak_gb_by_rank=peaks, policy=VARIANTS[name],
            prefill_logits_shape=list(logits[0].shape),
            own_greedy_differs=[[int(b), int(i)] for b, i in differ.nonzero().tolist()],
            ok=bool(errs) and max(errs.values()) <= SERVE_TOL
            and (flips is None or flips["ok"]) and not (family and differ.any())
            and rec["launches"]["ok"] and (rec["expert_slabs"] is None
                                           or rec["expert_slabs"]["ok"]),
            **{k: v for k, v in rec.items() if k != "tokens"})
        del c
        _release(dev)
    del base
    _release(dev)
    if variants == ("default",):
        return outs["default"]
    return dict(variants=outs, ok=all(r["ok"] for r in outs.values()))


def _unflat(flat: dict, dev) -> dict:
    """A cache tree from its leaves by dotted name (:func:`_flat`), on ``dev``."""
    tree: dict = {}
    for name, t in flat.items():
        *groups, leaf = name.split(".")
        node = tree
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = t.to(dev, copy=True)
    return tree


def _int8_leaves(got: dict, want: dict, rows: int) -> tuple:
    """Two caches' leaves by name: the int8 ones' entries a quantization
    step apart by batch row (any further apart fails), and the others'
    max |got - want| over max |want|."""
    flips, errs = torch.zeros(rows, dtype=torch.int64), {}
    for leaf, t in want.items():
        g = got[leaf]
        if t.dtype == torch.int8:
            gap = (g.to(torch.int32) - t.to(torch.int32)).abs()  # [L, B, ...]
            errs[leaf + ".max_step"] = int(gap.max())
            flips += (gap != 0).transpose(0, 1).reshape(rows, -1).sum(dim=1)
        else:  # a leaf still zero (the Mamba cache after a prefill, ROADMAP C.4): absolute
            top = t.float().abs().max()
            errs[leaf] = float((g.float() - t.float()).abs().max() / (top if top > 0 else 1))
    return flips, errs


def _int8_check(opts, dev, rank, cfg, gen: int, seq: int | None = None,
                variants: tuple = INT8_SERVE) -> dict:
    """Part (xxiv): ``cfg`` in float32 with the int8 KV cache on (1, N)
    under each of ``variants`` (with and without the kernels) against rank
    0 alone under the same values.  As ROADMAP C.5 holds an int8 cache: a
    K/V value within an ulp of a rounding boundary can quantize a step
    apart on the two sides, so the one card starts each decode step from
    the sharded side's cache before it (a flip cannot carry on).  Held:
    the prefill's logits within 1e-4 of their max |value|; each cache's
    int8 leaves at most a step apart (the flips counted by batch row) and
    its float leaves (the scales, the Mamba state and window) within 1e-4;
    each step's logits by batch row within 1e-4, and within 1e-3 on a row
    whose new entry flipped in that step; the greedy tokens equal; the
    kernels' launches exact."""
    seq = seq or opts.prompt
    base = ShardingPolicy(attn_chunk=min(1024, seq))
    mesh = _mesh(dev, None)
    model = init_sharded(cfg, mesh, seed=1, dtype=torch.float32, device=dev, policy=base)
    weights_gb = _weights_gb(model)
    prompt = _prompt(cfg, opts.serve_batch, seq, 1, dev)
    sharded = {}
    for name in variants:
        policy = _variant(base, name)
        _peak_reset(dev)
        logits, caches, rec = _serve_run(cfg, mesh, policy, model, _rows_of(prompt, mesh), seq,
                                         gen, dev, record=False, each_step=True, first=True)
        peaks = _gather(_peak_gb(dev))
        sharded[name] = (policy, [lg.cpu() for lg in logits] if rank == 0 else None, caches,
                         rec, peaks)
        del logits, caches
        _release(dev)
    del model
    _release(dev)
    if rank != 0:
        return None
    one = init_params(cfg, seed=1, dtype=torch.float32, device=dev)
    outs = {}
    for name, (policy, logits, caches, rec, peaks) in sharded.items():
        single = _one_card(policy)
        tokens = torch.tensor(rec["tokens"], dtype=torch.int32, device=dev)
        lg, cache, pos = prefill(one, cfg, single, prompt["tokens"], prompt.get("patches"),
                                 max_len=seq + gen)
        B = opts.serve_batch
        scale = lg.float().abs().max()
        errs = {"prefill_logits": float((logits[0].float() - lg.float().cpu()).abs().max()
                                        / scale)}
        flips, leaves = _int8_leaves(caches[0], _flat(cache), B)
        errs.update({f"prefill.{k}": v for k, v in leaves.items()})
        steps, differ = [], []
        for i in range(gen):
            lg, after = decode_step(one, cfg, single, _unflat(caches[i], dev), tokens[:, i:i + 1],
                                    pos + i)
            differ.append(bool((greedy_tokens(lg[:, -1:]) != tokens[:, i + 1:i + 2]).any()))
            step_flips, leaves = _int8_leaves(caches[i + 1], _flat(after), B)
            gap = (logits[i + 1].float() - lg.float().cpu()).abs()
            by_row = (gap.reshape(B, -1).amax(dim=1) / lg.float().abs().max().cpu()).tolist()
            steps.append(dict(row_err=by_row, flips=step_flips.tolist(), **leaves,
                              ok=all(e <= (FLIP_TOL if f else SERVE_TOL)
                                     for e, f in zip(by_row, step_flips.tolist()))))
        leaf_errs = [v for st in [errs, *steps] for k, v in st.items()
                     if k not in ("prefill_logits", "row_err", "flips", "ok")
                     and not k.endswith("max_step")]
        steps_max = [v for st in steps for k, v in st.items() if k.endswith("max_step")]
        outs[name] = dict(
            arch=cfg.name, layers=cfg.num_layers, dtype="float32",
            mesh=f"{mesh.size(0)}x{mesh.size(1)}", batch=B, prompt=seq, gen=gen,
            weights_gb_a_rank=weights_gb, serve_peak_gb_by_rank=peaks, policy=VARIANTS[name],
            rel_err=errs, prefill_flips=flips.tolist(), steps=steps, greedy_differs=differ,
            ok=errs["prefill_logits"] <= SERVE_TOL and max(leaf_errs) <= SERVE_TOL
            and max(v for k, v in errs.items() if k.endswith("max_step")) <= 1
            and max(steps_max) <= 1 and all(st["ok"] for st in steps) and not any(differ)
            and rec["launches"]["ok"],
            **{k: v for k, v in rec.items() if k != "tokens"})
        del cache, after
        _release(dev)
    del one
    _release(dev)
    return dict(variants=outs, ok=all(r["ok"] for r in outs.values()))


def _each_mesh(part, meshes: str) -> dict | None:
    """``part(mesh_spec)`` on each of ``meshes`` in turn: rank 0's records
    by mesh, ok where every mesh's is."""
    runs = {spec: part(spec) for spec in meshes.split(",")}
    if dist.get_rank() != 0:
        return None
    return dict(meshes=runs, ok=all(r["ok"] for r in runs.values()))


FAMILY_PARTS = tuple(f"{f}-{k}" for f in FAMILIES for k in ("train", "serve"))
EP_PARTS = ("moe-ep-train", "moe-ep-serve", "kimi-ep-check", "kimi-ep-serve")
LAYOUT_PARTS = ("layout-train", "layout-serve", "layout-families")
KERNEL_PARTS = ("kernels-serve", "int8-serve")
EXPERT_MODEL_PARTS = ("expert-model-train", "expert-model-serve")
PARTS = ("train", "check", "serve", "moe-train", "moe-serve", *FAMILY_PARTS, "kimi-check",
         "kimi-serve", *EP_PARTS, *LAYOUT_PARTS, *KERNEL_PARTS, *EXPERT_MODEL_PARTS,
         "kimi-kernels-serve")


def _layout_serve(opts, dev, rank) -> dict:
    """Part (xxi): ``--serve-arch`` cut to ``--check-layers`` layers in
    float32 on (1, N) under LAYOUT_SERVE against one card, as (iii); then at
    full size in bfloat16 under ``sp+last`` beside the default, as (ii)."""
    runs = {"check": _serve_check(opts, dev, rank,
                                  _cfg(opts, opts.serve_arch, opts.check_layers),
                                  opts.check_gen, record=True, variants=LAYOUT_SERVE),
            "full": _serve(opts, dev, rank, _cfg(opts, opts.serve_arch),
                           variants=("default", "sp+last"))}
    if rank != 0:
        return None
    return dict(runs=runs, ok=all(r["ok"] for r in runs.values()))


def _layout_families(opts, dev, rank) -> dict:
    """Part (xxii): the ssm, hybrid, audio and vlm families' models at
    FAMILY_TRAIN_LAYERS layers trained on the first of ``--meshes`` under
    ``sp`` and served on (1, N) under ``sp+last`` and ``noseqshard`` (hymba
    on twice its window); then deepseek-v2-lite-16b at MOE_TRAIN_LAYERS
    layers trained and served on ``--meshes`` under ``sp`` and ``dense``;
    each beside the default.  Rank 0 prints each run's record as it ends
    (a cut run keeps them in its log)."""
    def done(key, rec):
        if rank == 0:
            print(f"layout-families {key}: " + json.dumps(rec), flush=True)
        return rec

    runs = {}
    for arch in FAMILIES.values():
        cfg = _cfg(opts, arch, FAMILY_TRAIN_LAYERS)
        runs[f"{arch}-train"] = done(f"{arch}-train", _train_check(
            opts, dev, rank, cfg, opts.meshes.split(",")[0], variants=("default", "sp")))
        runs[f"{arch}-serve"] = done(f"{arch}-serve", _serve_check(
            opts, dev, rank, cfg, opts.check_gen, seq=2 * cfg.window or None, family=True,
            record=True, variants=("default", "sp+last", "noseqshard")))
    moe_cfg = _cfg(opts, MOE, MOE_TRAIN_LAYERS)
    runs[f"{MOE}-serve"] = done(f"{MOE}-serve", _each_mesh(lambda m: _serve_check(
        opts, dev, rank, moe_cfg, opts.check_gen, mesh_spec=m, record=True,
        variants=("default", "sp", "dense")), opts.meshes))
    runs[f"{MOE}-train"] = done(f"{MOE}-train", _train_check(
        opts, dev, rank, moe_cfg, variants=("default", "sp", "dense")))
    if rank != 0:
        return None
    return dict(runs=runs, ok=all(r["ok"] for r in runs.values()))


def _printed(rank, part: str):
    """Rank 0 prints each run's record as it ends (a cut run keeps them in
    its log)."""
    def done(key, rec):
        if rank == 0:
            print(f"{part} {key}: " + json.dumps(rec), flush=True)
        return rec

    return done


def _kernels_serve(opts, dev, rank) -> dict:
    """Part (xxiii): KERNEL_ARCHS at full width and depth in float32 on (1,
    N) under ``cuda`` against rank 0 alone under ``cuda``, as the families'
    serving parts (every cache leaf after each decode step, greedy tokens
    equal; hymba on twice its window), llama3.2-3b also on 2x2, the
    kernels' launches on every rank exact; then ``--serve-arch`` at full
    size in bfloat16 on (1, N) under KERNEL_SERVE, as (ii)."""
    done = _printed(rank, "kernels-serve")
    runs = {}
    for arch in KERNEL_ARCHS:
        cfg = _cfg(opts, arch)
        runs[arch] = done(arch, _serve_check(opts, dev, rank, cfg, opts.check_gen,
                                             seq=2 * cfg.window or None, family=True,
                                             variants=("cuda",)))
    cfg = _cfg(opts, KERNEL_ARCHS[0])
    runs[f"{cfg.name}-2x2"] = done(f"{cfg.name}-2x2", _serve_check(
        opts, dev, rank, cfg, opts.check_gen, family=True, mesh_spec="2x2", variants=("cuda",)))
    runs[opts.serve_arch] = done(opts.serve_arch, _serve(
        opts, dev, rank, _cfg(opts, opts.serve_arch), variants=KERNEL_SERVE))
    if rank != 0:
        return None
    return dict(runs=runs, ok=all(r["ok"] for r in runs.values()))


def _kimi_kernels_serve(opts, dev, rank) -> dict:
    """Part (xxvii): kimi-k2-1t-a32b at KIMI_CHECK's cut in float32 on (1, N)
    under ``cuda`` against rank 0 alone under ``cuda``, as (xxiii)'s models;
    then at KIMI_SERVE_LAYERS layers in bfloat16 on (1, N) under
    KERNEL_SERVE, as (vi).  The head dim stays kimi's 112 (also in the
    ``--smoke`` variant)."""
    done = _printed(rank, "kimi-kernels-serve")
    head_dim = get_arch(KIMI).head_dim
    check = dataclasses.replace(_cfg(opts, KIMI, *KIMI_CHECK), head_dim=head_dim)
    serve = dataclasses.replace(_cfg(opts, KIMI, KIMI_SERVE_LAYERS), head_dim=head_dim)
    runs = {"check": done("check", _serve_check(opts, dev, rank, check, opts.check_gen,
                                                family=True, variants=("cuda",))),
            "serve": done("serve", _serve(opts, dev, rank, serve, variants=KERNEL_SERVE))}
    if rank != 0:
        return None
    return dict(runs=runs, ok=all(r["ok"] for r in runs.values()))


def _int8_serve(opts, dev, rank) -> dict:
    """Part (xxiv): INT8_ARCHS at full width and depth (hymba on twice its
    window) under INT8_SERVE, each against one card (:func:`_int8_check`)."""
    done = _printed(rank, "int8-serve")
    runs = {}
    for arch in INT8_ARCHS:
        cfg = _cfg(opts, arch)
        runs[arch] = done(arch, _int8_check(opts, dev, rank, cfg, opts.check_gen,
                                            seq=2 * cfg.window or None))
    if rank != 0:
        return None
    return dict(runs=runs, ok=all(r["ok"] for r in runs.values()))


def _expert_model_train(opts, dev, rank) -> dict:
    """Part (xxv): deepseek-v2-lite-16b at MOE_TRAIN_LAYERS layers under
    ``expert_model`` on each group of EXPERT_MODEL_MESHES against one card,
    as (iv); then kimi-k2-1t-a32b at KIMI_CHECK's cut on the first group
    under ``expert_model`` against the default layout on the same mesh."""
    done = _printed(rank, "expert-model-train")
    runs = {f"{MOE} {m}": done(f"{MOE} {m}", _train_check(
        opts, dev, rank, _cfg(opts, MOE, MOE_TRAIN_LAYERS), m, variants=("expert_model",)))
        for m in EXPERT_MODEL_MESHES}
    runs[KIMI] = done(KIMI, _train_check(opts, dev, rank, _cfg(opts, KIMI, *KIMI_CHECK),
                                         EXPERT_MODEL_MESHES[0],
                                         variants=("default", "expert_model"),
                                         against="default"))
    if rank != 0:
        return None
    return dict(runs=runs, ok=all(r["ok"] for r in runs.values()))


def _expert_model_serve(opts, dev, rank) -> dict:
    """Part (xxvi): deepseek-v2-lite-16b whole in float32 under
    ``expert_model`` on the first group of EXPERT_MODEL_MESHES against rank
    0 alone, as (v) with every cache leaf held after each decode step and the
    greedy tokens equal; then kimi-k2-1t-a32b at KIMI_SERVE_LAYERS layers in
    bfloat16 on (1, N), its weights drawn sharded in each layout, under
    ``expert_model`` beside the default, as (vi)."""
    done = _printed(rank, "expert-model-serve")
    runs = {MOE: done(MOE, _each_mesh(lambda m: _serve_check(
                opts, dev, rank, _cfg(opts, MOE), opts.gen, mesh_spec=m, family=True,
                record=True, variants=("expert_model",)), EXPERT_MODEL_MESHES[0])),
            KIMI: done(KIMI, _serve(opts, dev, rank, _cfg(opts, KIMI, KIMI_SERVE_LAYERS),
                                    variants=("default", "expert_model")))}
    if rank != 0:
        return None
    return dict(runs=runs, ok=all(r["ok"] for r in runs.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke variants")
    ap.add_argument("--check-arch", default="llama3.2-3b")
    ap.add_argument("--meshes", default="1x4,2x2", help="data x model meshes of (i) and (iv)")
    ap.add_argument("--check-batch", type=int, default=8, help="global rows in (i) and (iv)")
    ap.add_argument("--check-steps", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--serve-arch", default="mistral-large-123b")
    ap.add_argument("--serve-batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--check-layers", type=int, default=2)
    ap.add_argument("--check-gen", type=int, default=4)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"which of {', '.join(PARTS)} to run, in this order")
    ap.add_argument("--out", default=str(REPO / "build" / "tp_dist.json"))
    opts = ap.parse_args(argv)
    parts = opts.parts.split(",")
    if set(parts) - set(PARTS):
        raise SystemExit(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    args = cli.parse_args(["--arch", opts.check_arch,
                           *(["--device", opts.device] if opts.device else [])])
    backend = cli.init_data_group(args)
    if backend is None:
        raise SystemExit("run under torchrun with more than one process")
    dev = torch.device(args.device)
    rank = dist.get_rank()
    run = {
        "train": lambda: _train_check(opts, dev, rank, _cfg(opts, opts.check_arch)),
        "check": lambda: _serve_check(opts, dev, rank,
                                      _cfg(opts, opts.serve_arch, opts.check_layers),
                                      opts.check_gen),
        "serve": lambda: _serve(opts, dev, rank, _cfg(opts, opts.serve_arch)),
        "moe-train": lambda: _train_check(opts, dev, rank, _cfg(opts, MOE, MOE_TRAIN_LAYERS)),
        "moe-serve": lambda: _serve_check(opts, dev, rank, _cfg(opts, MOE), opts.gen),
        "kimi-check": lambda: _serve_check(opts, dev, rank, _cfg(opts, KIMI, *KIMI_CHECK),
                                           opts.check_gen),
        "kimi-serve": lambda: _serve(opts, dev, rank, _cfg(opts, KIMI, KIMI_SERVE_LAYERS)),
        "layout-train": lambda: _train_check(opts, dev, rank, _cfg(opts, opts.check_arch),
                                             variants=LAYOUT_TRAIN),
        "layout-serve": lambda: _layout_serve(opts, dev, rank),
        "layout-families": lambda: _layout_families(opts, dev, rank),
        "kernels-serve": lambda: _kernels_serve(opts, dev, rank),
        "int8-serve": lambda: _int8_serve(opts, dev, rank),
        "kimi-kernels-serve": lambda: _kimi_kernels_serve(opts, dev, rank),
        "expert-model-train": lambda: _expert_model_train(opts, dev, rank),
        "expert-model-serve": lambda: _expert_model_serve(opts, dev, rank),
        "moe-ep-train": lambda: _train_check(opts, dev, rank, _cfg(opts, MOE, MOE_TRAIN_LAYERS),
                                             EP_MESHES),
        "moe-ep-serve": lambda: _each_mesh(lambda m: _serve_check(
            opts, dev, rank, _cfg(opts, MOE), opts.gen, mesh_spec=m, record=True),
            EP_MESHES),
        "kimi-ep-check": lambda: _each_mesh(lambda m: _serve_check(
            opts, dev, rank, _cfg(opts, KIMI, *KIMI_CHECK), opts.check_gen, mesh_spec=m),
            EP_MESHES),
        "kimi-ep-serve": lambda: _serve(opts, dev, rank, _cfg(opts, KIMI, KIMI_SERVE_LAYERS),
                                        EP_MESHES.split(",")[-1]),
    }
    for family, arch in FAMILIES.items():
        run[f"{family}-train"] = (lambda a=arch: _train_check(
            opts, dev, rank, _cfg(opts, a, FAMILY_TRAIN_LAYERS)))
        run[f"{family}-serve"] = (lambda c=_cfg(opts, arch): _serve_check(
            opts, dev, rank, c, opts.check_gen, seq=2 * c.window or None, family=True,
            record=True))
    t0 = time.perf_counter()
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
            if dev.type == "cuda" else ["cpu"])
    rec = {}
    for part in parts:
        t1 = time.perf_counter()
        raised = 0
        try:
            rec[part] = run[part]()
        except Exception as e:
            raised = 1
            rec[part] = dict(ok=False, error=f"{type(e).__name__}: {e}",
                             traceback=traceback.format_exc()[-3000:])
            traceback.print_exc()
        flag = torch.tensor([raised], device=dev)
        dist.all_reduce(flag)
        n_raised = int(flag)
        if rank == 0:
            rec[part]["wall_s"] = time.perf_counter() - t1
            if n_raised:
                rec[part].update(ok=False, ranks_raised=n_raised)
            print(f"part {part}: ok={rec[part]['ok']} in {rec[part]['wall_s']:.1f} s", flush=True)
            rec.update(cards=card, backend=backend, torch=torch.__version__,
                       world=dist.get_world_size(), wall_s=time.perf_counter() - t0)
            os.makedirs(os.path.dirname(opts.out), exist_ok=True)
            with open(opts.out, "w") as f:  # after each part: a cut run keeps what it did
                f.write(json.dumps(rec) + "\n")
        _release(dev)
        if 0 < n_raised < dist.get_world_size():
            print(f"rank {rank}: {n_raised} of the ranks raised in {part}: the run stops",
                  flush=True)
            return 1
    ok = True
    if rank == 0:
        print(json.dumps(rec), flush=True)
        ok = all(rec[part]["ok"] for part in parts)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
