"""One train step on the card under ``torch.profiler``, its device time
grouped into matrix products, attention, the optimizer, collectives and
the rest.  ``chip_smoke.py`` (phase 9) and ``scripts/fsdp_dist.py`` report
a profiled step this way.  :class:`CommBytes` counts a step's collectives
and their bytes (``scripts/fsdp_dist.py``, ``scripts/tp_dist.py``, the dry
run)."""

from __future__ import annotations

import time
from collections import Counter

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.models.transformer as transformer
import repro_torch.runtime.train as rt

__all__ = ["device_time_by_group", "busy_ms", "profile_train_step", "CommBytes"]


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
