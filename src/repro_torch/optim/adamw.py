"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule.

The port of the reference's ``optim/adamw.py``, with its arithmetic in the
same order leaf by leaf: the clip scale ``min(1, clip / max(gnorm,
1e-12))``, the moments in float32, ``mhat / (sqrt(vhat) + eps) + wd * p``,
and each result cast back to the leaf's and the state's dtypes.  Not
``torch.optim.AdamW``: that places eps and the bias corrections otherwise,
and its state would not match the checkpoint layout.

A parameter tree is an ``nn.Module`` (its named parameters) or a flat
mapping of names to tensors; the moments ``m`` and ``v`` are dicts under
the same names.  :func:`adamw_update` updates the parameters and moments
**in place**, one leaf at a time (the reference returns new trees), so a
step holds one leaf's temporaries and never a second copy of the
parameters.  The moments may be kept in bfloat16 (``state_dtype``), as the
reference allows for its largest configurations.

A model sharded with FSDP (:func:`repro_torch.runtime.sharding.shard_model`)
has DTensor parameters and gradients: its moments are made as DTensors of
the same placements (each rank holds its shard: ZeRO), the update runs on
each rank's local shards, and :func:`global_norm` adds each leaf's
squares over all its shards once (one all-reduce of the per-leaf sums).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr", "global_norm", "named_leaves"]


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # scalar int32 on the parameters' device
    m: dict  # name -> tensor like the parameter
    v: dict


def named_leaves(params) -> dict:
    """The tree's leaves by name: an ``nn.Module``'s named parameters, or
    the mapping itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params, state_dtype=torch.float32) -> AdamWState:
    leaves = named_leaves(params)
    device = next(iter(leaves.values())).device

    def zeros():  # a DTensor parameter's moments are DTensors of its placements
        return {n: (torch.zeros_like(p, dtype=state_dtype, requires_grad=False)
                    if isinstance(p, DTensor) else
                    torch.zeros(p.shape, dtype=state_dtype, device=p.device))
                for n, p in leaves.items()}

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros(), v=zeros())


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    the leaves' sums added in order, as the reference's Python ``sum``.  A
    DTensor leaf sharded over a 1-D mesh counts every shard once: the
    shards' sums are all-reduced (one call for all such leaves) before the
    leaves' sums are added."""
    leaves = list(named_leaves(tree).values())
    sharded = [isinstance(x, DTensor) and any(p.is_shard() for p in x.placements)
               for x in leaves]
    sums = []
    for x in leaves:
        xf = _local(x).float()
        sums.append(torch.sum(xf * xf))
    if any(sharded):
        x0 = leaves[sharded.index(True)]
        if x0.device_mesh.ndim != 1:
            raise ValueError("global_norm sums shards over a 1-D mesh (FSDP's)")
        part = torch.stack([s for s, sh in zip(sums, sharded) if sh])
        torch.distributed.all_reduce(part, group=x0.device_mesh.get_group())
        it = iter(part)
        sums = [next(it) if sh else s for s, sh in zip(sums, sharded)]
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)


def cosine_lr(step, base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; float32 on the step's
    device."""
    step = step.float()
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, beta1=0.9, beta2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0):
    """One AdamW step: ``params`` and ``state`` updated in place and
    returned, as (params, state, {"grad_norm": pre-clip global norm}).
    ``grads`` holds a gradient under each parameter's name; ``lr`` is a
    float or a float32 scalar tensor."""
    leaves = named_leaves(params)
    flat_g = named_leaves(grads)
    if flat_g.keys() != leaves.keys():
        raise ValueError(f"gradients for {sorted(flat_g)} do not match the parameters "
                         f"{sorted(leaves)}")
    gnorm = global_norm(flat_g)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0) if grad_clip else 1.0
    state.step += 1
    t = state.step.float()
    bc1 = 1.0 - beta1 ** t
    bc2 = 1.0 - beta2 ** t
    for name, p in leaves.items():
        m, v = state.m[name], state.v[name]
        sharded = isinstance(m, DTensor)
        pl, ml, vl = _local(p), _local(m), _local(v)  # a rank's shards
        g = _local(flat_g[name]).float() * scale
        m_new = beta1 * ml.float()
        m_new += (1 - beta1) * g
        v_new = (1 - beta2) * g
        v_new *= g
        v_new += beta2 * vl.float()
        del g
        delta = m_new / bc1
        denom = v_new / bc2
        denom.sqrt_()
        denom += eps
        delta /= denom
        del denom
        delta += weight_decay * pl.float()
        delta *= lr
        if sharded:
            ml.copy_(m_new)
            vl.copy_(v_new)
        else:
            state.m[name] = m_new.to(m.dtype)
            state.v[name] = v_new.to(v.dtype)
        del m, v, ml, vl, m_new, v_new
        pl.copy_(pl.float() - delta)
    return params, state, {"grad_norm": gnorm}
