"""Batched ASAP replay of packed buckets on a device.

The port of ``repro/engine/batched_sim.py``.  The reference ran the replay
as a vmapped ``lax.scan`` (``_durations``, ``_asap_chain``, ``_asap_star``)
or through its Pallas kernel; here every bucket goes through
:func:`repro_torch.kernels.asap_replay` — the CUDA kernel on the card, its
plain PyTorch version (the same recurrence, vectorized over the batch) on
the CPU.  ``m == 1`` buckets take the same route.

Everything is float64; the operations are the IEEE max/add/mul of the
serial simulator, so results match it to the last few ulps (tested at
<= 1e-9).  Padded cells carry zero durations — their latency term is
masked by ``cell_valid`` in the forward and return phases alike — so they
never push any time past the real makespan.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.core.schedule import Schedule
from repro_torch.kernels import asap_replay
from repro_torch.kernels.asap_replay import outputs_to_numpy

from .arena import InstanceArena, PackedBucket

__all__ = ["simulate_bucket", "simulate_many", "makespans"]


def simulate_bucket(bucket: PackedBucket, gamma: np.ndarray, device=None):
    """ASAP-replay a [B, m, T] fraction batch on ``device`` (None: the card).

    Returns the fixed 7-slot NumPy tuple ``(cs, ce, ps, pe, rs, re, mk)``;
    ``rs``/``re`` are None unless the bucket activates the result-return
    phase.  ``gamma`` must already be padded to the bucket shape (see
    :meth:`PackedBucket.gamma_padded`); returned arrays are bucket-shaped —
    use :meth:`PackedBucket.unpad` to strip padding.
    """
    dev = resolve_device(device)
    with_ret = bool(bucket.has_returns) and bucket.m > 1
    fields = [bucket.w_cell, bucket.z, bucket.latency, bucket.tau, bucket.vcomm_cell,
              bucket.vcomp_cell, bucket.rel_cell, bucket.cell_valid, gamma]
    if with_ret:
        fields.append(bucket.ret_cell)
    # one host buffer (page-locked for the card, from PyTorch's caching host
    # allocator), one copy to the device, the kernel's inputs views of it
    host = [np.asarray(a, dtype=np.float64) for a in fields]
    buf = torch.empty(sum(a.size for a in host), dtype=torch.float64,
                      pin_memory=dev.type == "cuda")
    np.concatenate([a.ravel() for a in host], out=buf.numpy())
    flat = buf.to(dev, non_blocking=True)
    args = [x.view(a.shape) for x, a in zip(flat.split([a.size for a in host]), host)]
    ret = args.pop() if with_ret else None
    return outputs_to_numpy(asap_replay(*args, ret, topology=bucket.topology))


def simulate_many(instances: list, gammas: list, pad_shapes: bool = True,
                  device=None) -> list:
    """Batched counterpart of ``[simulate(i, g) for i, g in zip(...)]``.

    Returns a list of :class:`repro_torch.core.schedule.Schedule` in caller
    order; numerically interchangeable with the serial simulator (<= 1e-9).
    """
    if len(instances) != len(gammas):
        raise ValueError("need one gamma per instance")
    dev = resolve_device(device)
    arena = InstanceArena(instances, pad_shapes=pad_shapes)
    results = []
    for bucket in arena.buckets:
        g = bucket.gamma_padded([gammas[i] for i in bucket.indices])
        cs, ce, ps, pe, rs, re, mk = simulate_bucket(bucket, g, device=dev)
        if rs is not None:
            rs, re = bucket.unpad(rs), bucket.unpad(re)
        cs, ce = bucket.unpad(cs), bucket.unpad(ce)
        ps, pe = bucket.unpad(ps), bucket.unpad(pe)
        results.append([
            Schedule(
                instance=bucket.instances[b],
                gamma=np.asarray(gammas[bucket.indices[b]], dtype=np.float64),
                comm_start=cs[b],
                comm_end=ce[b],
                comp_start=ps[b],
                comp_end=pe[b],
                makespan=float(mk[b]),
                ret_start=rs[b] if rs is not None else None,
                ret_end=re[b] if re is not None else None,
            )
            for b in range(bucket.B)
        ])
    return arena.scatter(results)


def makespans(instances: list, gammas: list, pad_shapes: bool = True,
              device=None) -> np.ndarray:
    """Just the achieved makespans, [len(instances)] — the sweep fast path."""
    dev = resolve_device(device)
    arena = InstanceArena(instances, pad_shapes=pad_shapes)
    per_bucket = []
    for bucket in arena.buckets:
        g = bucket.gamma_padded([gammas[i] for i in bucket.indices])
        *_, mk = simulate_bucket(bucket, g, device=dev)
        per_bucket.append(list(mk))
    return np.array(arena.scatter(per_bucket), dtype=np.float64)
