"""One train step on the card under ``torch.profiler``, its device time
grouped into matrix products, attention, the optimizer, collectives and
the rest.  ``chip_smoke.py`` (phase 9) and ``scripts/fsdp_dist.py`` report
a profiled step this way.  :class:`CommBytes` counts a step's collectives
and their bytes (``scripts/fsdp_dist.py``, ``scripts/tp_dist.py``, the dry
run).  :func:`observe_routes` and :func:`routing_flips` record two runs' MoE
routing and find the tokens they route apart (ROADMAP C.16: near-ties a
~1e-7 difference flips), so that ``scripts/tp_dist.py`` and
``chip_smoke.py`` hold each sequence before its first touched position."""

from __future__ import annotations

import contextlib
import time
from collections import Counter

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.models.transformer as transformer
import repro_torch.runtime.train as rt
from repro_torch.models.layers import constrain
from repro_torch.models.moe import capacity

__all__ = ["device_time_by_group", "busy_ms", "profile_train_step", "CommBytes",
           "observe_routes", "kept_slots", "routing_flips", "TIE_MARGIN"]

TIE_MARGIN = 1e-6  # a routing flip with a larger margin is no near-tie


class CommBytes(CommDebugMode):
    """``CommDebugMode`` that also adds up, by op, the bytes of the whole
    tensor each collective works on: an all-gather's output, a
    reduce-scatter's input, an all-reduce's or an all-to-all's tensor
    (FSDP's ``c10d`` ops and DTensor's functional collectives alike)."""

    def __init__(self):
        super().__init__()
        self.bytes = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = _op_name(getattr(func, "_overloadpacket", func))
        if out is NotImplemented or "wait_tensor" in name:
            return out
        if name.startswith("c10d."):
            first = args[1] if "reduce_scatter" in name else (args[0] if args else None)
        elif name.startswith(("c10d_functional.", "dtensor.")):  # dtensor.shard_dim_alltoall
            first = out if "all_gather" in name else args[0]
        else:
            return out
        tensors = first if isinstance(first, (list, tuple)) else [first]
        self.bytes[name] += sum(t.numel() * t.element_size() for t in tensors
                                if isinstance(t, torch.Tensor))
        return out

    def counts(self) -> dict:
        """Collectives by op, with their bytes: ``{op: {"count", "bytes"}}``."""
        return {_op_name(k): {"count": int(v), "bytes": int(self.bytes.get(_op_name(k), 0))}
                for k, v in self.get_comm_counts().items()}


def _op_name(op) -> str:
    """An op's name without the leading underscore of its private namespace
    (the counts and the dispatcher name ``_c10d_functional`` ops apart)."""
    return str(op).lstrip("_")


def busy_ms(prof) -> float:
    """The device's busy milliseconds in a profile: the union of its
    operations' intervals (their summed durations may overlap)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return busy_us / 1e3


def device_time_by_group(prof) -> tuple:
    """Device milliseconds of one profiled train step by group: the
    collectives (NCCL's kernels, on a sharded step), the optimizer (every
    other kernel under the ``optimizer`` scope), attention (the
    kernels of the ops under the ``attention`` scope, in the forward and in
    its recomputation, and of the backward nodes of those ops, matched by
    the autograd sequence number the profiler records for both), the
    other matrix products (cuBLAS/CUTLASS kernels) and the rest; and the
    number of device operations."""
    events = [e for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA]

    def scopes(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    backward = "autograd::engine::evaluate_function"
    attn_seq = set()
    for e in events:
        chain = [a.name for a in scopes(e)]
        if (e.sequence_nr >= 0 and "attention" in chain
                and not any(n.startswith(backward) for n in chain)):
            attn_seq.add(e.sequence_nr)
    groups = {"matmul": 0.0, "attention": 0.0, "optimizer": 0.0, "collective": 0.0, "other": 0.0}
    n_ops = 0
    for e in events:
        if not e.kernels:
            continue
        chain = list(scopes(e))
        names = [a.name for a in chain]
        if any("nccl" in k.name.lower() for k in e.kernels):
            key = "collective"  # a sharded step's all-gathers, reduce-scatters, all-reduces
        elif "optimizer" in names:
            key = "optimizer"
        elif "attention" in names or any(a.name.startswith(backward)
                                         and a.sequence_nr in attn_seq for a in chain):
            key = "attention"
        else:
            key = None
        for k in e.kernels:
            n_ops += 1
            kk = key or ("matmul" if any(t in k.name.lower()
                                         for t in ("gemm", "cutlass", "splitkreduce"))
                         else "other")
            groups[kk] += k.duration / 1e3
    return groups, n_ops


def profile_train_step(cfg, policy, tcfg, state, batch) -> dict:
    """One train step under torch.profiler, the attention and the optimizer
    marked by record_function scopes around their calls for this step
    only: device ms by group, the wall, the busy share."""
    attention, adamw_update = transformer.attention, rt.adamw_update

    def scoped(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    transformer.attention = scoped("attention", attention)
    rt.adamw_update = scoped("optimizer", adamw_update)
    try:
        step = rt.make_train_step(cfg, policy, tcfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        transformer.attention, rt.adamw_update = attention, adamw_update
    groups, n_ops = device_time_by_group(prof)
    busy = busy_ms(prof)
    return dict(device_ms=groups, device_total_ms=sum(groups.values()), device_busy_ms=busy,
                wall_ms=1e3 * wall, busy_share=busy / 1e3 / wall, device_ops=n_ops,
                loss=float(m["loss"]))


@contextlib.contextmanager
def observe_routes(model, record: dict, key):
    """Record each MoE layer's routing of this rank's rows while inside:
    ``record[(key(), layer)]`` = (the experts of each token, sorted [N, k];
    the k-th minus the (k+1)-th router probability [N]), on the host.  A
    recomputed block (remat) records the same again."""
    layer_of = {id(blk.moe): l for l, blk in enumerate(model.blocks)}
    ffn = transformer.moe_ffn

    def observed(p, x, cfg, **kw):
        with torch.no_grad():
            h = constrain(x, ("pod", "data"), None, None)
            h = (h.to_local() if isinstance(h, DTensor) else h).reshape(-1, cfg.d_model)
            w = p.router.to_local() if isinstance(p.router, DTensor) else p.router
            top = torch.softmax(h.float() @ w.float(), dim=-1).topk(cfg.moe.top_k + 1, dim=-1)
            k = cfg.moe.top_k
            record[(key(), layer_of[id(p)])] = (
                top.indices[:, :k].sort(dim=-1).values.cpu(),
                (top.values[:, k - 1] - top.values[:, k]).cpu())
        return ffn(p, x, cfg, **kw)

    transformer.moe_ffn = observed
    try:
        yield record
    finally:
        transformer.moe_ffn = ffn


def kept_slots(experts, cap: int, n_experts: int):
    """Which experts keep each token's slot [N, E] under gshard at capacity
    ``cap``: a token's slot is its expert's nth, n counted over the earlier
    tokens in order (a token picks an expert once), and kept under ``cap``."""
    chose = torch.zeros(experts.shape[0], n_experts, dtype=torch.int64).scatter_(1, experts, 1)
    return (chose > 0) & (chose.cumsum(0) - chose < cap)


def routing_flips(sharded: dict, single: dict, batch: int, seq: int, cfg) -> dict:
    """The (token, layer) pairs the two sides route apart.  Keys are
    ``((group, step), layer)``: ``step`` None for a pass over whole
    sequences (positions 0..seq-1), else a decode step at position seq +
    step.  A token is touched at a layer where its top-k differs (a flip)
    or, its top-k the same, gshard's capacity keeps other slots of it (an
    earlier token's flip moved its expert's count).  A flip is primary
    unless, in its group and sequence, a token at an earlier layer and the
    same or an earlier position was touched, or an earlier group flipped
    at all.  Returns every flip, the primary ones' count and largest
    margin, the touched sequences of each group and the first position
    touched in each, and ``ok`` (no primary flip above the near-tie
    margin)."""
    if set(sharded) != set(single):
        raise ValueError("the two sides recorded other MoE calls")
    flips, touched = [], []
    for (group, step), layer in sorted(single, key=repr):
        (ea, ma), (eb, mb) = sharded[((group, step), layer)], single[((group, step), layer)]
        cap = capacity(cfg, ea.shape[0])
        E = cfg.moe.num_experts
        flip = (ea != eb).any(dim=-1)
        moved = flip | (kept_slots(ea, cap, E) != kept_slots(eb, cap, E)).any(dim=-1)
        for t in moved.nonzero().flatten().tolist():
            seq_i, pos = (t // seq, t % seq) if step is None else (t, seq + step)
            at = dict(group=group, layer=layer, seq=seq_i, pos=pos)
            touched.append(at)
            if flip[t]:
                flips.append(dict(at, margin=max(float(ma[t]), float(mb[t]))))
    first = min((f["group"] for f in flips), default=None)
    primary = [f for f in flips if f["group"] == first and not any(
        g["seq"] == f["seq"] and g["group"] == first and g["layer"] < f["layer"]
        and g["pos"] <= f["pos"] for g in touched)]
    worst = max((f["margin"] for f in primary), default=0.0)
    since: dict = {}
    for g in touched:
        at = since.setdefault(g["group"], {})
        at[g["seq"]] = min(at.get(g["seq"], g["pos"]), g["pos"])
    return dict(flips=flips[:200], n_flips=len(flips), n_primary=len(primary),
                n_touched=len(touched), primary_margin_max=worst, first_group=first,
                flipped_seqs={g: sorted(v) for g, v in since.items()},
                first_touched=since, ok=worst <= TIE_MARGIN)
