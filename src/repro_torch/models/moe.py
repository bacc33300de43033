"""Mixture-of-Experts FFN: shared experts + routed top-k.

The port of the reference's ``models/moe.py``.  Two dispatch
implementations, as there:

  "gshard"  — capacity-bucketed dispatch: each (token, choice) slot goes to
              position ``pos`` of its expert's buffer [E, C, D], ``pos``
              counted by a cumsum over the slots in order; slots at or past
              the capacity ``C = max(1, round(cf * N * k / E))`` are dropped
              (their gate is 0 and they read the expert's last position, as
              in the reference).  In a decode step of 4 tokens C is 1, so a
              second token choosing the same expert loses it (ROADMAP C).
              The buffer holds min(C, N) positions an expert: a token picks
              an expert once.
  "dense"   — every token through every expert, weighted by the router
              (exact; O(E) FLOPs), the oracle gshard is held to.

Router: softmax top-k with the Switch-style load-balancing auxiliary loss.

Plain PyTorch: the reference has no kernel here (its dispatch is ``jnp``
einsums and scatters).  The k slots of a token are summed in slot order
(a ``view(N, k, D).sum(1)``) instead of the reference's scatter-add, so
the card's result does not depend on the order of atomics.

Sharded, as the reference's partitioned program (its ``constrain`` sites):

  * on a model axis wider than 1 (``x`` a DTensor replicated there) the
    routing and the dispatch run on the replicated local tensors, every
    model rank alike, and the experts' products are DTensor operations:
    each expert's d_ff over 'model' (``ff_axis``).  ``w_down``'s partial
    sums stay partial through the gather back and the gates' weighted sum
    (both linear) and through the shared experts' (the dense MLP's
    layout), and one all-reduce of the [B, S, D] output at its constraint
    sums them.  The experts are not sharded over 'data' (``expert_axis``
    reaches :func:`constrain`, which moves only the model axis): each rank
    runs its own slots through every expert (ROADMAP A.18);
  * on a data group wider than 1 (the batch axes of the active mesh: FSDP,
    or ``(data, model)``) each rank routes its own rows, but the capacity,
    the slot positions and the aux loss are the global batch's, as the
    reference's partitioner computes them (ROADMAP C.19): a slot's position
    in its expert is the count of the earlier ranks' slots there (one
    all-reduce of the ranks' E counts) plus the rank's own cumsum, so the same slots
    are dropped, and the aux loss's means are sums all-reduced over the
    ranks (differentiable: the gradient averaging over the ranks then gives
    the global batch's gradient).  A rank runs only its own kept slots:
    the experts act row by row.  One card and a data group of 1 run none of
    these collectives.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.config import ArchConfig
from .layers import constrain, current_mesh, replicated

__all__ = ["init_moe", "moe_ffn", "capacity"]


def init_moe(init, cfg: ArchConfig):
    mo = cfg.moe
    d, f, E = cfg.d_model, mo.d_ff_expert, mo.num_experts
    p = {
        "router": init.normal((d, E), scale=0.02),
        "w_gate": init.normal((E, d, f)),
        "w_up": init.normal((E, d, f)),
        "w_down": init.normal((E, f, d)),
    }
    if mo.num_shared:
        p["shared"] = {
            "w_gate": init.normal((d, f * mo.num_shared)),
            "w_up": init.normal((d, f * mo.num_shared)),
            "w_down": init.normal((f * mo.num_shared, d)),
        }
    return p


def _act(cfg: ArchConfig):
    if cfg.act == "swiglu":
        return F.silu
    return lambda g: F.gelu(g, approximate="tanh")  # jax.nn.gelu's default


DP = ("pod", "data")


def _batch_groups() -> list:
    """The process groups of the active mesh's batch axes wider than 1,
    the major axis first ('pod', then 'data'): the ranks whose rows make
    the global batch."""
    mesh = current_mesh()
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    return [mesh.get_group(a) for a in DP if a in names and mesh.size(names.index(a)) > 1]


def _ranks(groups) -> int:
    return math.prod(g.size() for g in groups)


def _sum_over(t, groups):
    """``t`` summed over the ranks of ``groups``."""
    for g in groups:
        t = funcol.all_reduce(t, "sum", g)
    return funcol.wait_tensor(t)


class _SumOverRanks(torch.autograd.Function):
    """``t`` summed over the ranks of ``groups``; its gradient is summed
    over them too, as the sum's adjoint (each rank's loss holds the global
    sum)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _sum_over(t, groups)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.groups), None


def _earlier_ranks(counts, groups):
    """The sum of ``counts`` [E] over the ranks of ``groups`` that come
    before this one in the global batch's order (the first group major):
    one all-reduce of a [ranks, E] table that holds each rank's counts in
    its row."""
    index, size = 0, 1
    for g in reversed(groups):  # the innermost axis varies fastest
        index += dist.get_group_rank(g, dist.get_rank()) * size
        size *= g.size()
    table = torch.zeros(size, counts.shape[0], dtype=counts.dtype, device=counts.device)
    table[index] = counts
    return _sum_over(table, groups)[:index].sum(dim=0)


def _router(p, x2d, mo, groups=()):
    """x2d [N, D] float32 -> (gates [N, k], experts [N, k] int64, aux loss);
    the aux loss's means over the global batch of ``groups``' ranks."""
    logits = x2d @ _local(p.router).float()
    probs = torch.softmax(logits, dim=-1)  # [N, E]
    gates, experts = torch.topk(probs, mo.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    top1 = F.one_hot(experts[:, 0], mo.num_experts).float()
    if groups:
        n = x2d.shape[0] * _ranks(groups)
        me, ce = (_SumOverRanks.apply(torch.stack([probs.sum(dim=0), top1.sum(dim=0)]),
                                      groups) / n).unbind(0)
    else:
        me, ce = probs.mean(dim=0), top1.mean(dim=0)
    aux = mo.num_experts * torch.sum(me * ce)
    return gates, experts, aux


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Positions of each expert's buffer for ``n_tokens`` tokens (gshard)."""
    mo = cfg.moe
    return max(1, int(round(mo.capacity_factor * n_tokens * mo.top_k / mo.num_experts)))


def _local(t):
    """A DTensor replicated, or a partial sum, over the model axis as its
    local tensor (every model rank holds and computes the same, or its own
    term; the gradient of either is the whole, replicated); a plain tensor
    as itself."""
    if not isinstance(t, DTensor):
        return t
    if any(isinstance(pl, Shard) for pl in t.placements):
        raise ValueError(f"a local view of a sharded DTensor ({t.placements})")
    return t.to_local(grad_placements=[Replicate()] * t.device_mesh.ndim)


def _against(t, like):
    """``t`` (a plain tensor equal on every model rank) to multiply with
    ``_local(like)``.  Where ``like`` is a partial sum, so is each rank's
    gradient of ``t``: the backward all-reduces it."""
    if not isinstance(like, DTensor) or not any(pl.is_partial() for pl in like.placements):
        return t
    return DTensor.from_local(t, like.device_mesh, [Replicate()] * like.device_mesh.ndim,
                              run_check=False).to_local(grad_placements=like.placements)


def _like(t, like):
    """``t``, computed linearly from ``_local(like)``, as a DTensor with
    ``like``'s placements (replicated, or a partial sum); else ``t``."""
    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements, run_check=False)


def _expert_ffn(p, buf, act_fn, expert_axis, ff_axis):
    """buf [E, C, D] -> [E, C, D] through each expert's gated MLP; on a
    model axis a partial sum over it (``w_down`` sharded on its input)."""
    g = constrain(torch.bmm(buf, p.w_gate), expert_axis, None, ff_axis)
    u = constrain(torch.bmm(buf, p.w_up), expert_axis, None, ff_axis)
    return torch.bmm(act_fn(g) * u, p.w_down)


def moe_ffn(p, x, cfg: ArchConfig, impl: str = "gshard", expert_axis: str = "data",
            ff_axis: str = "model"):
    """x [B, S, D] -> ([B, S, D], aux loss times ``router_aux_weight``).
    ``expert_axis`` and ``ff_axis``: the mesh axes of the experts and of
    each expert's d_ff (the policy's ``expert_axis`` and
    ``expert_ff_axis``), as the reference's arguments."""
    mo = cfg.moe
    x = constrain(x, DP, None, None)
    B, S, D = x.shape
    N, E, k = B * S, mo.num_experts, mo.top_k
    x2d = _local(x).reshape(N, D)
    act_fn = _act(cfg)
    groups = _batch_groups()
    gates, experts, aux = _router(p, x2d.float(), mo, groups)

    if impl == "dense":
        g = torch.einsum("nd,edf->nef", x2d, p.w_gate)
        u = torch.einsum("nd,edf->nef", x2d, p.w_up)
        per_e = torch.einsum("nef,efd->ned", act_fn(g) * u, p.w_down)  # [N, E, D]
        w = torch.zeros(N, E, dtype=torch.float32, device=x.device).scatter_add_(1, experts,
                                                                                gates)
        y = replicated(torch.einsum("ned,ne->nd", per_e.float(), w).to(x.dtype).reshape(B, S, D),
                       x)
    elif impl == "gshard":
        C = capacity(cfg, N * _ranks(groups))
        flat_e = experts.reshape(-1)  # [N k] expert of each slot
        flat_g = gates.reshape(-1)
        # position of each slot within its expert (cumsum over slot order):
        # among this rank's slots, and in the global batch's slot order
        onehot = F.one_hot(flat_e, E)
        mine = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
        flat_pos = mine + _earlier_ranks(onehot.sum(dim=0), groups)[flat_e] if groups else mine
        keep = flat_pos < C
        flat_g = torch.where(keep, flat_g, 0.0)
        R = min(C, N)  # this rank's kept slots of an expert, at most
        safe_pos = torch.where(keep, mine, R - 1)
        # the kept slots into [E, R, D] (each position written once); the
        # dropped ones into one spare row past the buffer
        row = torch.where(keep, flat_e * R + mine, E * R)
        buf = torch.zeros(E * R + 1, D, dtype=x.dtype, device=x.device)
        buf.index_copy_(0, row, x2d.repeat_interleave(k, dim=0))
        out_buf = _expert_ffn(p, replicated(buf[:E * R].view(E, R, D), x), act_fn,
                              expert_axis, ff_axis)
        # gather back, weighted by gates; a token's k slots summed in order
        # (on a model axis, each rank its partial sums: linear in them; the
        # gates' gradient is then partial too, and ``_against`` sums it)
        y2 = _local(out_buf)[flat_e, safe_pos] * _against(flat_g, out_buf)[:, None].to(x.dtype)
        y = _like(y2.float().view(N, k, D).sum(dim=1).to(x.dtype).reshape(B, S, D), out_buf)
    else:
        raise ValueError(impl)

    if mo.num_shared:
        sp = p.shared
        g = constrain(x @ sp.w_gate, DP, None, ff_axis)
        u = constrain(x @ sp.w_up, DP, None, ff_axis)
        y = y + (act_fn(g) * u) @ sp.w_down
    return constrain(y, DP, None, None), replicated(aux, x) * mo.router_aux_weight
