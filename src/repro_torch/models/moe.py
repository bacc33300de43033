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
    sums them;
  * on a data group wider than 1 (the batch axes of the active mesh: FSDP,
    or ``(data, model)``) each rank routes its own rows, but the capacity,
    the slot positions and the aux loss are the global batch's, as the
    reference's partitioner computes them (ROADMAP C.19): a slot's position
    in its expert is the count of the earlier ranks' slots there (one
    all-reduce of the ranks' E counts) plus the rank's own cumsum, so the
    same slots are dropped, and the aux loss's means are sums all-reduced
    over the ranks (differentiable: the gradient averaging over the ranks
    then gives the global batch's gradient);
  * there, under the default ``expert_axis="data"``, the experts are split
    over those ranks (expert parallelism: each rank holds E / ranks routed
    experts, :mod:`repro_torch.runtime.sharding`).  The gshard slots go to
    them by all-to-all over the batch axes ('pod' and 'data' as one
    group), with variable splits: the count table above, read to the host
    once a layer (the only host read), says how many kept slots each rank
    sends each expert, so only kept slots travel.  Each rank puts the slots
    it gets at their global positions in the reference's [E / ranks, C, D]
    buffer, runs its experts on it (d_ff over 'model' as above), and the
    reverse all-to-all brings each output back to the row it left.  Both
    go through ``_AllToAll``, whose gradient is the reverse exchange; an
    expert's gradient so sums every rank's loss's, and the train step
    divides it by the ranks once
    (:func:`repro_torch.runtime.sharding.mean_expert_grads`).  ``"dense"``
    sends every rank's tokens to every rank's experts and the weighted
    sums back;
  * ``"dense"`` on a model axis: each rank runs every token through its
    d_ff slab of every expert it holds (all of them, or its E / ranks
    under expert parallelism), weighted by the router: partial sums over
    'model', reduced once at the output's constraint, as gshard's are.
    Under ``expert_axis="model"`` on a model axis of 1 every
    rank runs its slots through every expert (FSDP gathers them).  A mesh
    whose batch ranks the experts are not split over as the policy says
    raises.  One card and a data group of 1 run none of these collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.config import ArchConfig
from .layers import DP, constrain, current_mesh, model_mesh, replicated

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


def _batch_group():
    """The process group of the active mesh's batch axes wider than 1
    ('pod' and 'data' flattened into one, the pod major): the ranks whose
    rows make the global batch, in its order; ``None`` where that is one
    rank."""
    mesh = current_mesh()
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    axes = tuple(a for a in DP if a in names and mesh.size(names.index(a)) > 1)
    if not axes:
        return None
    return mesh[axes]._flatten().get_group() if len(axes) > 1 else mesh.get_group(axes[0])


def _sum_over(t, group):
    """``t`` summed over the ranks of ``group``."""
    return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))


class _SumOverRanks(torch.autograd.Function):
    """``t`` summed over the ranks of ``group``; its gradient is summed
    over them too, as the sum's adjoint (each rank's loss holds the global
    sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum_over(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.group), None


def _by_rank(counts, group):
    """[ranks, E]: every rank of ``group``'s ``counts`` [E] in its row, in
    the global batch's order (one all-reduce of a table that holds this
    rank's counts in its row)."""
    table = counts.new_zeros(group.size(), counts.shape[0])
    table[dist.get_group_rank(group, dist.get_rank())] = counts
    return _sum_over(table, group)


def _router(p, x2d, mo, group=None):
    """x2d [N, D] float32 -> (gates [N, k], experts [N, k] int64, aux loss);
    the aux loss's means over the global batch of ``group``'s ranks."""
    logits = x2d @ _local(p.router).float()
    probs = torch.softmax(logits, dim=-1)  # [N, E]
    gates, experts = torch.topk(probs, mo.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    top1 = F.one_hot(experts[:, 0], mo.num_experts).float()
    if group is not None:
        n = x2d.shape[0] * group.size()
        me, ce = (_SumOverRanks.apply(torch.stack([probs.sum(dim=0), top1.sum(dim=0)]),
                                      group) / n).unbind(0)
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


def _exchange(t, send: list, recv: list, group):
    """An all-to-all over ``group``: ``t``'s first ``send[0]`` rows go to
    rank 0, the next ``send[1]`` to rank 1, ...; returns the rows every
    rank sent here, rank 0's first (``recv[j]`` of them from rank j)."""
    return funcol.wait_tensor(funcol.all_to_all_single(t.contiguous(), recv, send, group))


class _AllToAll(torch.autograd.Function):
    """:func:`_exchange`; its gradient goes back by the reverse exchange
    (what came from rank j returns to rank j, into the rows it left)."""

    @staticmethod
    def forward(ctx, t, send, recv, group):
        ctx.args = recv, send, group
        return _exchange(t, send, recv, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, *ctx.args), None, None, None


def _slab(w, ff_dim: int):
    """This rank's experts of an expert leaf split over the batch axes: its
    local slab, on a model axis wider than 1 a DTensor there with each
    expert's d_ff on ``ff_dim`` (the leaf's own split: the gradient of the
    slab is the leaf's local gradient)."""
    local = w.to_local()
    tp = model_mesh()
    return local if tp is None else DTensor.from_local(local, tp, [Shard(ff_dim)], run_check=False)


def _split(w) -> int:
    """The ranks an expert leaf's E is split over (its E over the experts
    this rank holds)."""
    return w.shape[0] // (w.to_local() if isinstance(w, DTensor) else w).shape[0]


def _expert_ffn(w_gate, w_up, w_down, buf, act_fn, expert_axis, ff_axis):
    """buf [E, C, D] -> [E, C, D] through each expert's gated MLP; on a
    model axis a partial sum over it (``w_down`` sharded on its input)."""
    g = constrain(torch.bmm(buf, w_gate), expert_axis, None, ff_axis)
    u = constrain(torch.bmm(buf, w_up), expert_axis, None, ff_axis)
    return torch.bmm(act_fn(g) * u, w_down)


def _host_counts(kept, table, C: int, slots: int) -> list:
    """``kept`` [ranks, E] as lists on the host: the all-to-alls' split
    sizes, one read a layer.  On the meta device (the dry run, which has no
    data) the balanced routing's instead: each rank's ``slots`` spread
    evenly over the experts, kept up to the capacity ``C``."""
    if not kept.is_meta:
        return kept.tolist()
    ranks, E = table.shape
    each = [slots // E + (e < slots % E) for e in range(E)]
    return [[min(max(C - r * n, 0), n) for n in each] for r in range(ranks)]


def _dispatched(p, x2d, flat_e, mine, keep, table, C, group, x, act_fn, expert_axis, ff_axis):
    """Expert parallelism (gshard): this rank's kept slots through the
    experts that live on the ranks of ``group`` and back.  ``table`` [ranks,
    E] holds every rank's slots by expert, ``mine`` each slot's position
    among this rank's.  The slots go out in expert order, which groups them
    by the rank that holds their expert (variable splits, read from the
    table: only kept slots travel); each rank puts the ones it gets at
    their global positions in the reference's [E / ranks, C, D] buffer of
    its experts (a rank's slots of an expert follow the earlier ranks'),
    runs its experts on it (d_ff over 'model' as on one card), and sends
    each slot's output back by the reverse all-to-all to the row it left.
    Returns (each slot's output [N k, D], a dropped slot's 0, as this
    rank's local tensor; the experts' output, on a model axis a DTensor
    whose placements that local tensor has)."""
    ranks, me, (N, D) = group.size(), dist.get_group_rank(group, dist.get_rank()), x2d.shape
    E = table.shape[1]
    here = slice(me * E // ranks, (me + 1) * E // ranks)  # this rank's experts
    earlier = table.cumsum(dim=0) - table  # each rank's first global position an expert
    kept = torch.minimum((C - earlier).clamp(min=0), table)  # [ranks, E]
    sizes = _host_counts(kept, table, C, flat_e.shape[0])
    send = [sum(sizes[me][r * E // ranks:(r + 1) * E // ranks]) for r in range(ranks)]
    recv = [sum(row[here]) for row in sizes]
    # this rank's kept slots in expert order, each expert's in position
    # order; a dropped slot into one spare row past them, never sent
    start = kept[me].cumsum(dim=0) - kept[me]
    row = torch.where(keep, start[flat_e] + mine, sum(send))
    rows = x2d.new_zeros(sum(send) + 1, D).index_copy(
        0, row, x2d.repeat_interleave(flat_e.shape[0] // N, dim=0))  # k a token
    got = _AllToAll.apply(rows[:sum(send)], send, recv, group)
    # a received row's place in [E / ranks, C, D]: its expert's C positions,
    # its sending rank's first one there, its order among that rank's
    depth = min(C, N * ranks)
    n = kept[:, here].reshape(-1)  # by sending rank, then expert
    first = (torch.arange(E // ranks, device=x2d.device) * depth + earlier[:, here]).reshape(-1)
    total = sum(recv)
    at = (torch.repeat_interleave(first - (n.cumsum(dim=0) - n), n, output_size=total)
          + torch.arange(total, device=x2d.device))
    buf = x2d.new_zeros(E // ranks * depth, D).index_copy(0, at, got)
    out = _expert_ffn(_slab(p.w_gate, 2), _slab(p.w_up, 2), _slab(p.w_down, 1),
                      replicated(buf.view(E // ranks, depth, D), x), act_fn, expert_axis,
                      ff_axis)
    # on a model axis each model rank sends back its own partial sums (the
    # local tensor of a Partial DTensor) over its own batch group: they reach
    # the model rank of the same index, so they stay its partial sums, summed
    # once at the output's constraint
    back = _AllToAll.apply(_local(out).reshape(-1, D)[at], recv, send, group)
    return torch.cat([back, back.new_zeros(1, D)])[row], out


def _model_partial_grad(t):
    """``t`` (a plain tensor equal on every model rank) fed to products with
    each rank's d_ff slab: on a model axis its gradient there is a partial
    sum over the ranks, all-reduced by the backward; else ``t``."""
    tp = model_mesh()
    if tp is None:
        return t
    return DTensor.from_local(t, tp, [Replicate()], run_check=False).to_local(
        grad_placements=[Partial()])


def _dense_local(p, x2d, w, act_fn):
    """moe_impl 'dense' with every expert here: [N, D] float32, the router's
    ``w`` [N, E]-weighted sum of every expert's output (on a model axis
    each rank's d_ff slab's partial sum)."""
    wg, wu, wd = (t.to_local() if isinstance(t, DTensor) else t
                  for t in (p.w_gate, p.w_up, p.w_down))
    g = torch.einsum("nd,edf->nef", x2d, wg)
    u = torch.einsum("nd,edf->nef", x2d, wu)
    per_e = torch.einsum("nef,efd->ned", act_fn(g) * u, wd)  # [N, E, D]
    return torch.einsum("ned,ne->nd", per_e.float(), w)


def _dense_dispatched(p, x2d, w, group, act_fn):
    """moe_impl 'dense' with the experts split over the ranks of ``group``
    (a model axis of 1): every rank's tokens and their router weights ``w``
    [N, E] for each rank's experts go to that rank (one all-to-all each),
    each rank sums its E / ranks experts' outputs weighted by them, and the
    reverse all-to-all brings the sums back, added in the ranks' order (the
    experts'); on a model axis each model rank's d_ff slab's partial sums,
    over its own batch group, as gshard's."""
    ranks, (N, D), E = group.size(), x2d.shape, w.shape[1]
    n = [N] * ranks
    xs = _AllToAll.apply(x2d.repeat(ranks, 1), n, n, group)  # [ranks N, D]
    ws = _AllToAll.apply(w.view(N, ranks, E // ranks).transpose(0, 1).reshape(ranks * N, -1),
                         n, n, group)
    g = torch.einsum("nd,edf->nef", xs, p.w_gate.to_local())
    u = torch.einsum("nd,edf->nef", xs, p.w_up.to_local())
    per_e = torch.einsum("nef,efd->ned", act_fn(g) * u, p.w_down.to_local())
    part = torch.einsum("ned,ne->nd", per_e.float(), ws)
    return _AllToAll.apply(part, n, n, group).view(ranks, N, D).sum(dim=0)


def moe_ffn(p, x, cfg: ArchConfig, impl: str = "gshard", expert_axis: str = "data",
            ff_axis: str = "model", out_spec=None):
    """x [B, S, D] -> ([B, S, D], aux loss times ``router_aux_weight``).
    ``expert_axis`` and ``ff_axis``: the mesh axes of the experts and of
    each expert's d_ff (the policy's ``expert_axis`` and
    ``expert_ff_axis``), as the reference's arguments.  ``out_spec``: the
    residual stream's spec for the output (a sequence-sharded ``x``,
    ``sp_activations``, is gathered first, and the partial sums reach a
    sequence-sharded stream by a reduce-scatter)."""
    mo = cfg.moe
    x = constrain(x, DP, None, None)
    B, S, D = x.shape
    N, E, k = B * S, mo.num_experts, mo.top_k
    x2d = _local(x).reshape(N, D)
    act_fn = _act(cfg)
    group = _batch_group()
    ranks = 1 if group is None else group.size()
    parallel = ranks > 1 and expert_axis == "data"  # expert parallelism
    if _split(p.w_gate) != (ranks if parallel else 1):
        raise ValueError(
            f"the experts are split over {_split(p.w_gate)} batch ranks and the batch over "
            f"{ranks}: under expert_axis {expert_axis!r} they are split on E over the batch "
            "axes exactly when those are wider than 1 (runtime.sharding.tp_distribute, "
            "init_sharded or shard_model)")
    gates, experts, aux = _router(p, x2d.float(), mo, group)

    if impl == "dense":
        w = torch.zeros(N, E, dtype=torch.float32, device=x.device).scatter_add_(1, experts,
                                                                                gates)
        # on a model axis both feed each rank's d_ff slab: their gradients partial
        xin, w = _model_partial_grad(x2d), _model_partial_grad(w)
        y = (_dense_dispatched(p, xin, w, group, act_fn) if parallel else
             _dense_local(p, xin, w, act_fn)).to(x.dtype).reshape(B, S, D)
        if isinstance(x, DTensor):  # each model rank its d_ff slabs' partial sums
            y = DTensor.from_local(y, x.device_mesh, [Partial()], run_check=False)
    elif impl == "gshard":
        C = capacity(cfg, N * ranks)
        flat_e = experts.reshape(-1)  # [N k] expert of each slot
        flat_g = gates.reshape(-1)
        # position of each slot within its expert (cumsum over slot order):
        # among this rank's slots, and in the global batch's slot order
        onehot = F.one_hot(flat_e, E)
        mine = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
        if group is None:
            flat_pos = mine
        else:
            table = _by_rank(onehot.sum(dim=0), group)  # [ranks, E]
            me = dist.get_group_rank(group, dist.get_rank())
            flat_pos = mine + (table[:me].sum(dim=0))[flat_e]
        keep = flat_pos < C
        flat_g = torch.where(keep, flat_g, 0.0)
        if parallel:
            back, out_buf = _dispatched(p, x2d, flat_e, mine, keep, table, C, group, x, act_fn,
                                        expert_axis, ff_axis)
        else:  # every expert here: this rank's slots into [E, R, D]
            R = min(C, N)  # this rank's kept slots of an expert, at most
            safe_pos = torch.where(keep, mine, R - 1)
            # the kept slots into [E, R, D] (each position written once); the
            # dropped ones into one spare row past the buffer
            row = torch.where(keep, flat_e * R + mine, E * R)
            buf = torch.zeros(E * R + 1, D, dtype=x.dtype, device=x.device)
            buf.index_copy_(0, row, x2d.repeat_interleave(k, dim=0))
            out_buf = _expert_ffn(p.w_gate, p.w_up, p.w_down,
                                  replicated(buf[:E * R].view(E, R, D), x), act_fn, expert_axis,
                                  ff_axis)
            back = _local(out_buf)[flat_e, safe_pos]
        # gather back, weighted by gates; a token's k slots summed in order
        # (on a model axis, each rank its partial sums: linear in them; the
        # gates' gradient is then partial too, and ``_against`` sums it)
        y2 = back * _against(flat_g, out_buf)[:, None].to(x.dtype)
        y = _like(y2.float().view(N, k, D).sum(dim=1).to(x.dtype).reshape(B, S, D), out_buf)
    else:
        raise ValueError(impl)

    if mo.num_shared:
        sp = p.shared
        g = constrain(x @ sp.w_gate, DP, None, ff_axis)
        u = constrain(x @ sp.w_up, DP, None, ff_axis)
        y = y + (act_fn(g) * u) @ sp.w_down
    return (constrain(y, *(out_spec or (DP, None, None))),
            replicated(aux, x) * mo.router_aux_weight)
