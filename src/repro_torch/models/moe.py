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
    'model', reduced once at the output's constraint, as gshard's are;
  * under ``expert_axis="model"``, ``expert_ff_axis="data"`` (the
    reference's ``expert_model``), on any mesh wider than one rank, model
    rank m holds the experts E_m (E / M of them) and each of their d_ff
    split over the 'data' axis (:func:`_over_model`).  Each rank routes its
    own rows (capacity, positions and aux loss the global batch's, as
    above); its kept slots of E_m go to every data rank (a variable
    all-gather through ``_AllToAll``, sizes from the count table's one host
    read a layer), each rank runs its F slabs on the reference's [E / M, C,
    D] buffer of its pod's slots, the reverse exchange brings each slot's
    partial output back to its owner, which adds the data ranks' partials
    in rank order, and a token's gated sum holds only E_m's slots: a
    partial sum over 'model', reduced by the one all-reduce at the output's
    constraint (the inputs' and gates' gradients partial there too).
    ``"dense"`` gathers every data rank's tokens and router weights for E_m
    (N rows from each) and sends the partial sums back the same way.  A
    data axis of 1 exchanges nothing;
  * the shared experts' hidden is over 'model', their weights' layout,
    under either expert layout.  The reference constrains it over
    ``ff_axis``, which under ``expert_model`` names 'data' beside the batch
    axes, and JAX refuses that spec (ROADMAP C.21); a layout moves no
    number.

A mesh whose ranks the experts are not split over as the policy says
raises.  One card runs none of these collectives.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.config import ArchConfig
from .layers import DP, constrain, current_mesh, model_mesh, replicated

__all__ = ["init_moe", "moe_ffn", "capacity", "exchange_tally"]


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


_TALLY: list = []  # the open exchange_tally()s' dicts


@contextlib.contextmanager
def exchange_tally():
    """Count the experts' exchanges while inside, by kind: ``{kind:
    {"count", "bytes"}}`` with the bytes each sends (its input), where a
    kind is ``"out"`` / ``"back"`` (expert parallelism's all-to-alls),
    ``"gather"`` / ``"return"`` (``expert_axis="model"``: the slots to
    every data rank, the partial outputs to their owners), each backward
    exchange as ``"<kind> backward"``.  ``CommDebugMode`` counts them all
    as ``all_to_all_single``; this tells them apart."""
    tally: dict = {}
    _TALLY.append(tally)
    try:
        yield tally
    finally:
        _TALLY.remove(tally)


def _partial(t, x):
    """``t``, each model rank its own term, as a partial sum over the model
    axis where ``x`` is a DTensor there; else ``t``."""
    if not isinstance(x, DTensor):
        return t
    return DTensor.from_local(t, x.device_mesh, [Partial()], run_check=False)


def _exchange(t, send: list, recv: list, group, kind: str):
    """An all-to-all over ``group``: ``t``'s first ``send[0]`` rows go to
    rank 0, the next ``send[1]`` to rank 1, ...; returns the rows every
    rank sent here, rank 0's first (``recv[j]`` of them from rank j)."""
    for tally in _TALLY:
        entry = tally.setdefault(kind, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += t.numel() * t.element_size()
    return funcol.wait_tensor(funcol.all_to_all_single(t.contiguous(), recv, send, group))


class _AllToAll(torch.autograd.Function):
    """:func:`_exchange`; its gradient goes back by the reverse exchange
    (what came from rank j returns to rank j, into the rows it left)."""

    @staticmethod
    def forward(ctx, t, send, recv, group, kind):
        ctx.args = recv, send, group, f"{kind} backward"
        return _exchange(t, send, recv, group, kind)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, *ctx.args), None, None, None, None


def _slab(w, ff_dim: int):
    """This rank's experts of an expert leaf split over the batch axes: its
    local slab, on a model axis wider than 1 a DTensor there with each
    expert's d_ff on ``ff_dim`` (the leaf's own split: the gradient of the
    slab is the leaf's local gradient)."""
    local = w.to_local()
    tp = model_mesh()
    return local if tp is None else DTensor.from_local(local, tp, [Shard(ff_dim)], run_check=False)


def _plain(w):
    """A DTensor's local tensor (this rank's shard); a plain tensor as itself."""
    return w.to_local() if isinstance(w, DTensor) else w


def _split(w) -> int:
    """The ranks an expert leaf's E is split over (its E over the experts
    this rank holds)."""
    return w.shape[0] // _plain(w).shape[0]


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
    got = _AllToAll.apply(rows[:sum(send)], send, recv, group, "out")
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
    back = _AllToAll.apply(_local(out).reshape(-1, D)[at], recv, send, group, "back")
    return torch.cat([back, back.new_zeros(1, D)])[row], out


def _data_axis():
    """The process group of the active mesh's 'data' axis and this rank's
    index on it; ``(None, 0)`` where that axis is one rank."""
    mesh = current_mesh()
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "data" not in names or mesh.size(names.index("data")) == 1:
        return None, 0
    return mesh.get_group("data"), mesh.get_local_rank("data")


def _slab_ffn(w_gate, w_up, w_down, buf, act_fn):
    """buf [E', R, D] through the gated MLPs of local expert slabs [E', D,
    F'] / [E', F', D] (plain tensors)."""
    return torch.bmm(act_fn(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up), w_down)


def _model_experts(E: int) -> tuple:
    """(this model rank's first expert, its count E / M) under
    ``expert_axis="model"``."""
    tp = model_mesh()
    n = E if tp is None else E // tp.size()
    return (0 if tp is None else tp.get_local_rank() * n), n


def _over_model(p, xin, flat_e, mine, keep, table, me, C, act_fn):
    """``expert_axis="model"``, ``expert_ff_axis="data"`` (gshard): this
    model rank holds experts E_m (E / M of them), each one's d_ff split
    over the 'data' axis (F / D_data columns here).  Returns each slot's
    output [N k, D] summed over the data ranks' d_ff slabs, 0 for a slot
    dropped or of another model rank's experts: a partial sum over
    'model'.

    On a 'data' axis of one rank every slot of E_m is here: they go into
    [E / M, R, D] at their positions among this rank's slots.  Wider, each
    data rank holds an F slab of every expert of E_m, so every data rank
    needs every data rank's slots of them: this rank's kept slots of E_m,
    in expert order, go to every data rank (a variable all-gather through
    ``_AllToAll``, sizes from the count ``table`` [batch ranks, E] read to
    the host once, ``_host_counts``); each rank puts the rows it gets at
    the slots' positions in the reference's [E / M, C, D] buffer (counted
    from its pod's first rank; ``me``: this rank's row of the table), runs
    its slabs on it, and the reverse exchange brings each slot's partial
    output back to the rank that owns its token, which adds the data
    ranks' partials in rank order."""
    (N, D), k = xin.shape, flat_e.shape[0] // xin.shape[0]
    lo, n_e = _model_experts(p.w_gate.shape[0])
    local_e = flat_e - lo
    ours = keep & (local_e >= 0) & (local_e < n_e)
    local_e = local_e.clamp(0, n_e - 1)
    slabs = [_plain(w) for w in (p.w_gate, p.w_up, p.w_down)]
    slots = xin.repeat_interleave(k, dim=0)
    group, d = _data_axis()
    if group is None:
        R = min(C, N)
        row = torch.where(ours, local_e * R + mine, n_e * R)
        buf = xin.new_zeros(n_e * R + 1, D).index_copy(0, row, slots)
        out = _slab_ffn(*slabs, buf[:n_e * R].view(n_e, R, D), act_fn).reshape(-1, D)
        return torch.cat([out, out.new_zeros(1, D)])[row]
    ranks, cols = group.size(), slice(lo, lo + n_e)
    pod = slice(me - d, me - d + ranks)  # this pod's data ranks' rows of the table
    earlier = table.cumsum(dim=0) - table  # each rank's first global position an expert
    kept = torch.minimum((C - earlier).clamp(min=0), table)  # [batch ranks, E]
    sizes = _host_counts(kept, table, C, flat_e.shape[0])
    recv = [sum(row[cols]) for row in sizes[pod]]
    n_me = recv[d]
    start = kept[me, cols].cumsum(dim=0) - kept[me, cols]
    row = torch.where(ours, start[local_e] + mine, n_me)  # a spare row past the kept ones
    rows = xin.new_zeros(n_me + 1, D).index_copy(0, row, slots)[:n_me]
    got = _AllToAll.apply(rows.repeat(ranks, 1), [n_me] * ranks, recv, group, "gather")
    # a received row's place in [E / M, C, D]: its expert's positions, its
    # sender's first one there (from the pod's first rank), its order there
    depth = min(C, N * ranks)
    n = kept[pod, cols].reshape(-1)  # by sending rank, then expert
    first = (torch.arange(n_e, device=xin.device) * depth
             + earlier[pod, cols] - earlier[pod.start, cols]).reshape(-1)
    total = sum(recv)
    at = (torch.repeat_interleave(first - (n.cumsum(dim=0) - n), n, output_size=total)
          + torch.arange(total, device=xin.device))
    buf = xin.new_zeros(n_e * depth, D).index_copy(0, at, got)
    out = _slab_ffn(*slabs, buf.view(n_e, depth, D), act_fn).reshape(-1, D)
    parts = _AllToAll.apply(out[at], recv, [n_me] * ranks, group, "return")
    summed = parts.float().view(ranks, n_me, D).sum(dim=0).to(xin.dtype)
    return torch.cat([summed, summed.new_zeros(1, D)])[row]


def _dense_over_model(p, xin, w, act_fn):
    """moe_impl 'dense' under ``expert_axis="model"``: [N, D] float32, the
    router's ``w`` [N, E]-weighted sum of this model rank's experts'
    outputs (a partial sum over 'model').  On a 'data' axis wider than one
    rank every data rank's tokens and their weights for E_m come here (an
    exchange each, N rows from every rank), this rank's d_ff slabs run on
    them, and each owner adds the partial sums that come back in rank
    order."""
    lo, n_e = _model_experts(w.shape[1])
    w = w[:, lo:lo + n_e]
    group, _ = _data_axis()
    (N, D), ranks = xin.shape, 1 if group is None else group.size()
    n = [N] * ranks
    if group is not None:
        xin = _AllToAll.apply(xin.repeat(ranks, 1), n, n, group, "gather")
        w = _AllToAll.apply(w.repeat(ranks, 1), n, n, group, "gather")
    wg, wu, wd = (_plain(t) for t in (p.w_gate, p.w_up, p.w_down))
    g = torch.einsum("nd,edf->nef", xin, wg)
    u = torch.einsum("nd,edf->nef", xin, wu)
    part = torch.einsum("ned,ne->nd", torch.einsum("nef,efd->ned", act_fn(g) * u, wd).float(), w)
    if group is None:
        return part
    return _AllToAll.apply(part, n, n, group, "return").view(ranks, N, D).sum(dim=0)


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
    wg, wu, wd = (_plain(t) for t in (p.w_gate, p.w_up, p.w_down))
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
    xs = _AllToAll.apply(x2d.repeat(ranks, 1), n, n, group, "out")  # [ranks N, D]
    ws = _AllToAll.apply(w.view(N, ranks, E // ranks).transpose(0, 1).reshape(ranks * N, -1),
                         n, n, group, "out")
    g = torch.einsum("nd,edf->nef", xs, p.w_gate.to_local())
    u = torch.einsum("nd,edf->nef", xs, p.w_up.to_local())
    per_e = torch.einsum("nef,efd->ned", act_fn(g) * u, p.w_down.to_local())
    part = torch.einsum("ned,ne->nd", per_e.float(), ws)
    return _AllToAll.apply(part, n, n, group, "back").view(ranks, N, D).sum(dim=0)


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
    tp = model_mesh()
    parallel = ranks > 1 and expert_axis == "data"  # expert parallelism
    over_model = expert_axis == "model" and (ranks > 1 or tp is not None)
    data_group, _ = _data_axis()
    want = ((1 if tp is None else tp.size(), 1 if data_group is None else data_group.size())
            if over_model else (ranks if parallel else 1, None))
    got = (_split(p.w_gate), p.w_gate.shape[2] // _plain(p.w_gate).shape[2])
    if got[0] != want[0] or want[1] not in (None, got[1]):
        raise ValueError(
            f"the experts are split {got[0]} ways on E and {got[1]} on d_ff, against {ranks} "
            f"batch ranks: under expert_axis {expert_axis!r} they are split on E over the batch "
            "axes where those are wider than 1, or (expert_axis 'model') on E over 'model' and "
            "on d_ff over 'data' on any mesh wider than one rank (runtime.sharding."
            "tp_distribute, init_sharded or shard_model)")
    gates, experts, aux = _router(p, x2d.float(), mo, group)

    if impl == "dense":
        w = torch.zeros(N, E, dtype=torch.float32, device=x.device).scatter_add_(1, experts,
                                                                                gates)
        # on a model axis both feed each rank's d_ff slab (or experts): their gradients partial
        xin, w = _model_partial_grad(x2d), _model_partial_grad(w)
        y = _partial((_dense_over_model(p, xin, w, act_fn) if over_model else
                      _dense_dispatched(p, xin, w, group, act_fn) if parallel else
                      _dense_local(p, xin, w, act_fn)).to(x.dtype).reshape(B, S, D), x)
    elif impl == "gshard":
        C = capacity(cfg, N * ranks)
        flat_e = experts.reshape(-1)  # [N k] expert of each slot
        flat_g = gates.reshape(-1)
        # position of each slot within its expert (cumsum over slot order):
        # among this rank's slots, and in the global batch's slot order
        onehot = F.one_hot(flat_e, E)
        mine = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
        table = me = None
        if group is None:
            flat_pos = mine
        else:
            table = _by_rank(onehot.sum(dim=0), group)  # [ranks, E]
            me = dist.get_group_rank(group, dist.get_rank())
            flat_pos = mine + (table[:me].sum(dim=0))[flat_e]
        keep = flat_pos < C
        flat_g = torch.where(keep, flat_g, 0.0)
        if over_model:  # each model rank its experts' slots
            back = _over_model(p, _model_partial_grad(x2d), flat_e, mine, keep, table, me, C,
                               act_fn)
        elif parallel:
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
        if over_model:
            gate, wrap = _model_partial_grad(flat_g), lambda t: _partial(t, x)
        else:
            gate, wrap = _against(flat_g, out_buf), lambda t: _like(t, out_buf)
        y2 = back * gate[:, None].to(x.dtype)
        y = wrap(y2.float().view(N, k, D).sum(dim=1).to(x.dtype).reshape(B, S, D))
    else:
        raise ValueError(impl)

    if mo.num_shared:  # d_ff over 'model', their weights' layout, under either expert layout
        sp = p.shared
        g = constrain(x @ sp.w_gate, DP, None, "model")
        u = constrain(x @ sp.w_up, DP, None, "model")
        y = y + (act_fn(g) * u) @ sp.w_down
    return (constrain(y, *(out_spec or (DP, None, None))),
            replicated(aux, x) * mo.router_aux_weight)
