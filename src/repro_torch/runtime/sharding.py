"""Sharding rules: a :class:`~repro_torch.models.layers.PartitionSpec` for
every parameter, optimizer moment, batch and cache leaf, their DTensor
placements on a ``DeviceMesh``, and FSDP training over the data axis.  The
port of the reference's ``runtime/sharding.py``, its rules kept as data.

Conventions (mesh axes: optional 'pod', 'data', 'model'):
  * weights [.., d_in, d_out]:  d_in over 'data' (FSDP/ZeRO-3), d_out over
    'model' (TP) — flipped for down/output projections so TP contracts;
  * expert weights [E, D, F]: E over ('pod', 'data') (expert parallelism),
    F over 'model'; or E over 'model', F over 'data' (``expert_axis="model"``);
  * embeddings [V, D]: V over 'model', D over 'data';
  * activations: batch over ('pod', 'data');
  * KV caches: sequence over 'model' (split-KV decode), batch over dp;
  * optimizer moments inherit their parameter's spec (ZeRO).

The reference keys its rules on a leaf's rank in its layer-stacked tree
(``[L, ...]`` for every block leaf); the port keeps a module a layer, so
:func:`param_specs` evaluates each rule at the reference's rank and drops
the layer's entry.

:func:`shard_model` trains a model with FSDP2 (``fully_shard``) over the
mesh's 'data' axis: each block and the root are sharded modules, each
weight split on the dim its spec puts over 'data' (so ``embed`` [V, D] on
D, as the reference).  A leaf whose spec names no data axis (the norms,
the Mamba mixer's ``A_log``, ``D``, ``dt_bias``, ``conv_w`` and ``norm_w``)
stays whole on every data rank, outside FSDP (``ignored_params``);
:func:`reduce_replicated_grads` averages its gradients over the data
ranks, on a model axis after reducing a partial sum over it to the leaf's
own placement (``conv_w`` and ``norm_w`` are sharded there, the others
replicated, and each rank's use of its own heads of ``A_log``, ``D`` and
``dt_bias`` makes their gradients partial sums).  The AdamW moments are created like their
parameters (:func:`repro_torch.optim.adamw_init`), so each rank holds
its shard of them too (ZeRO).

A model axis wider than 1 (tensor parallelism, the reference's production
layout) runs for every family under the default policy: dense, moe (MLA
included), ssm and hybrid (the Mamba mixer's d_inner, conv channels and
heads over 'model', hymba's sliding window on the sequence-sharded rows
and ring cache), audio (each codebook's table and head vocabulary-sharded)
and vlm (the replicated patch prefix beside the vocabulary-sharded text).
Each weight becomes a DTensor on the mesh's 'model' submesh with the
placement its spec's model entry gives (:func:`tp_distribute`;
:func:`init_sharded` draws a model no card holds leaf by leaf, each rank
keeping its shard); the activations follow the reference's ``constrain``
sites (:func:`repro_torch.models.layers.constrain`).  An MoE model's routed
expert leaves take both entries of their spec instead, a DTensor on the
whole mesh, under either expert layout of the reference: on batch axes
wider than 1 ('pod' and 'data' together, any model axis; the FSDP-only
(N, 1) mesh too) under the default ``expert_axis="data"``, E over the
batch axes and F over 'model' (expert parallelism: each rank holds its E /
ranks experts, and the gshard slots travel to them by all-to-all); on any
mesh wider than one rank under ``expert_axis="model"`` with
``expert_ff_axis="data"``, E over 'model' and F over 'data', replicated
over 'pod' (each rank holds E / M experts' F / D_data columns, and every
data rank's slots of them are gathered to it; :mod:`repro_torch.models.moe`).
For training :func:`shard_model` then applies FSDP2 over the 'data'
submesh, the usual 2-D composition (the model-axis placement first), with
the expert leaves left out of it (``ignored_params``: they are split
already and FSDP never gathers them); their gradients, each the sum of the
losses' of the ranks whose slots reach them, are divided by those ranks
once a step (:func:`mean_expert_grads`), and AdamW, its global norm and the
checkpoint take them as any sharded leaf.  An SSM head count the axis does
not divide (hymba-1.5b's 50 heads over 4 or 16) puts the head dim over
'model' instead, in the scan and in the decode state, as
:func:`cache_specs` does for the state (why: :mod:`repro_torch.models.ssm`).
Every policy value runs on a model axis wider than 1 (the activation
layouts, the int8 KV cache, the hand-written kernels in serving: they have
no backward) but a model axis named other than 'model' (ROADMAP A.18: the
reference's mesh names no other axis).  Refused too: an MoE model's
experts and their d_ff over one axis (``expert_ff_axis`` equal to
``expert_axis``: the reference's spec would name the axis twice; C.20),
and widths a sharded dim does not divide, the experts over their ranks
included (:func:`check_model_axis`).  Each rank computes its loss over its
own rows; an MoE layer's capacity, slot positions and aux loss are still
the global batch's, as the reference's partitioner computes them, so every
family trains as one process does.

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch llama3.2-3b --smoke --device cpu --steps 4 --batch 4
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.config import ArchConfig, ShardingPolicy
from repro_torch.convert import reference_key
from repro_torch.models.layers import PartitionSpec as P
from repro_torch.models.layers import DP, batch_ranks, fix_spec, model_mesh, placements

__all__ = ["param_specs", "batch_specs", "cache_specs", "shardings_for", "named",
           "NamedSharding", "placements", "shard_model", "is_sharded", "check_model_axis",
           "tp_distribute", "init_sharded", "data_group", "reduce_replicated_grads",
           "mean_over_ranks", "mean_expert_grads", "is_expert_leaf"]


def _rule(path_keys: tuple, shape: tuple, policy: ShardingPolicy) -> P:
    """Spec for one parameter leaf, keyed on its reference tree path + rank."""
    name = path_keys[-1]
    # ZeRO/FSDP shards over BOTH dp axes; fix_spec drops 'pod' on single-pod meshes
    d = ("pod", "data") if policy.fsdp_params else None
    m = policy.model_axis
    nd = len(shape)

    # --- embeddings / heads ---
    if name == "embed":
        if nd == 3:  # audio [K,V,D]
            return P(None, m, d)
        return P(m, d)
    if name == "heads":  # audio [K,D,V]
        return P(None, d, m)
    if name == "head":  # [D,V]
        return P(d, m)
    if name == "patch_proj":
        return P(None, d)
    # --- MoE --- (the expert dim joins the pod axis too)
    e_ax = ("pod", policy.expert_axis) if policy.expert_axis == "data" else policy.expert_axis
    if "moe" in path_keys and name in ("w_gate", "w_up") and nd == 4:  # [L,E,D,F]
        return P(None, e_ax, None, policy.expert_ff_axis)
    if "moe" in path_keys and name == "w_down" and nd == 4:  # [L,E,F,D]
        return P(None, e_ax, policy.expert_ff_axis, None)
    if name == "router":  # [L,D,E]
        return P(None, d, None)
    # --- MLA ---
    if name in ("w_dkv", "w_kr"):  # [L,D,r]
        return P(None, d, None)
    if name in ("w_uk", "w_uv"):  # [L,r,H*dh]
        return P(None, None, m)
    # --- mamba ---
    if name in ("w_z", "w_xbc"):  # [L,D,d_in] / [L,D,conv_dim]
        return P(None, d, m)
    if name == "w_dt":  # [L,D,H]
        return P(None, d, None)
    if name == "conv_w":  # [L,k,C]
        return P(None, None, m)
    if name in ("A_log", "D", "dt_bias"):  # [L,H]
        return P(None, None)
    if name == "norm_w":  # [L,d_inner]
        return P(None, m)
    if name == "w_out":  # [L,d_inner,D]
        return P(None, m, d)
    # --- attention / MLP ---
    if name in ("w_q", "w_k", "w_v", "w_gate", "w_up"):  # [L,D,X] or [D,X]
        return P(*([None] * (nd - 2)), d, m)
    if name in ("w_o", "w_down"):  # [L,X,D]
        return P(*([None] * (nd - 2)), m, d)
    if name == "w":  # generic linear
        return P(*([None] * (nd - 2)), d, m)
    # --- norms & scalars ---
    return P(*([None] * nd))


def param_specs(tree, policy: ShardingPolicy | None = None) -> dict:
    """Spec of every leaf of a parameter (or optimizer moment) tree — a
    :class:`~repro_torch.models.Transformer` (meta ones included) or a
    mapping of the port's parameter names to tensors — by name.  A block
    leaf's rule is evaluated at its rank in the reference's stacked tree
    and the layer's entry dropped."""
    from repro_torch.optim.adamw import named_leaves

    policy = policy or ShardingPolicy()
    return {name: _leaf_spec(name, t.shape, policy) for name, t in named_leaves(tree).items()}


def _leaf_spec(name: str, shape, policy: ShardingPolicy) -> P:
    """The spec of the port's parameter ``name`` of ``shape``."""
    key, layer = reference_key(name)
    spec = _rule(tuple(key.split("/")), (1, *shape) if layer is not None else tuple(shape), policy)
    return spec if layer is None else P(*spec[1:])


def batch_specs(cfg: ArchConfig, policy: ShardingPolicy | None = None,
                batch_size: int | None = None) -> dict:
    """Specs for a train/prefill batch dict."""
    dp = DP
    if batch_size is not None and batch_size == 1:
        dp = None  # single-stream decode cannot shard batch
    spec = {"tokens": P(dp, None), "labels": P(dp, None)}
    if cfg.family == "audio":
        spec = {"tokens": P(dp, None, None), "labels": P(dp, None, None)}
    if cfg.family == "vlm":
        spec["patches"] = P(dp, None, None)
    return spec


def cache_specs(cfg: ArchConfig, policy: ShardingPolicy | None = None,
                batch_size: int | None = None, model_divisor: int | None = None) -> dict:
    """Specs for the decode cache tree (layer-stacked, as the port's cache).

    ``model_divisor``: the model-axis size when the cache is a step's
    argument (arguments must divide exactly).  When the SSM head count
    doesn't divide it, the head_dim axis is sharded instead."""
    policy = policy or ShardingPolicy()
    m = policy.model_axis
    dp = DP if (batch_size is None or batch_size > 1) else None
    c: dict = {}
    if cfg.has_attention:
        if cfg.mla is not None:
            c["mla"] = {
                "c_kv": P(None, dp, m, None),  # [L,B,S,r] seq over model
                "k_pe": P(None, dp, m, None),
            }
        else:
            c["k"] = P(None, dp, m, None, None)  # [L,B,S,KVH,hd]
            c["v"] = P(None, dp, m, None, None)
            if policy.kv_cache_dtype == "int8":
                c["k_scale"] = P(None, dp, m, None)  # [L,B,S,KVH]
                c["v_scale"] = P(None, dp, m, None)
    if cfg.has_ssm:
        h = cfg.ssm.n_heads(cfg.d_model)
        heads_ok = model_divisor is None or h % model_divisor == 0
        c["ssm"] = {
            "conv": P(None, dp, None, m),  # [L,B,k-1,C]
            # [L,B,H,P,N]: heads over model when divisible, else head_dim
            "state": (
                P(None, dp, m, None if dp else "data", None)
                if heads_ok else P(None, dp, None, m, None)
            ),
        }
    return c


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, with its DTensor placements (JAX's
    ``NamedSharding``)."""

    mesh: object
    spec: P
    placements: tuple

    def shard_shape(self, shape) -> tuple:
        """This rank's shard of a tensor of ``shape`` (DTensor's own split:
        the first ranks of an uneven dim take the larger pieces)."""
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        local, _ = compute_local_shape_and_global_offset(tuple(shape), self.mesh, self.placements)
        return tuple(local)


def named(mesh, spec_tree):
    """A tree of specs (nested dicts, or one spec) as the same tree of
    :class:`NamedSharding` on ``mesh``."""
    if isinstance(spec_tree, P):
        spec = fix_spec(mesh, spec_tree)
        return NamedSharding(mesh, spec, placements(mesh, spec))
    return {k: named(mesh, v) for k, v in spec_tree.items()}


def shardings_for(mesh, cfg: ArchConfig, policy: ShardingPolicy, shape_tree) -> dict:
    """:class:`NamedSharding` of every leaf of a parameter tree, by name."""
    return named(mesh, param_specs(shape_tree, policy))


# ---------------------------------------------------------------- FSDP


def _data_mesh(mesh):
    """The 1-D 'data' mesh of a ('data', 'model') mesh (or a 1-D 'data' mesh)."""
    names = tuple(mesh.mesh_dim_names or ())
    if "data" not in names or set(names) - {"data", "model"}:
        raise ValueError(f"FSDP runs over a ('data', 'model') mesh; got axes {names}")
    return mesh["data"] if len(names) > 1 else mesh


def check_model_axis(cfg: ArchConfig, policy: ShardingPolicy, size: int, batch: int = 1,
                     data: int | None = None) -> None:
    """Raise unless ``cfg`` under ``policy`` runs on a model axis of
    ``size``, batch axes of ``batch`` ranks together and a 'data' axis of
    ``data`` ranks (default ``batch``: no 'pod'): every family, every
    policy value but a model axis not named 'model' (ROADMAP A.18: the
    reference's mesh names no other axis, and ``fix_spec`` would drop the
    name), at widths every sharded dim divides.  An MoE model on a mesh
    wider than one rank takes one of the two expert layouts: E over the
    batch axes and d_ff over 'model' (``expert_axis="data"``, expert
    parallelism: the batch ranks divide the experts), or E over 'model' and
    d_ff over 'data' (``expert_axis="model"``, ``expert_ff_axis="data"``:
    the model axis divides the experts, the data axis each expert's d_ff).
    The experts and their d_ff over one axis are refused (ROADMAP C.20)."""
    data = batch if data is None else data
    if size > 1 and policy.model_axis != "model":
        raise ValueError(f"{cfg.name}: the layout of {{'model_axis': {policy.model_axis!r}}} "
                         "is not ported to a model axis wider than 1 (ROADMAP A.18: the "
                         "reference's mesh names no other axis, and fix_spec would drop it)")
    mo = cfg.moe
    if mo is not None and (size > 1 or batch > 1):
        pair = (policy.expert_axis, policy.expert_ff_axis)
        if pair[0] == pair[1]:
            raise ValueError(f"{cfg.name}: expert_ff_axis {pair[1]!r} beside expert_axis "
                             f"{pair[0]!r} puts the experts and each expert's d_ff over the same "
                             f"mesh axis (the reference's spec names {pair[0]!r} twice, which JAX "
                             "refuses; ROADMAP C.20)")
        if pair not in (("data", "model"), ("model", "data")):
            raise ValueError(f"{cfg.name}: the experts over {pair[0]!r} and their d_ff over "
                             f"{pair[1]!r}: the reference's mesh has 'data' and 'model' only")
        if pair[0] == "data" and mo.num_experts % batch:
            raise ValueError(f"{cfg.name}: {{'num_experts': {mo.num_experts}}} do not "
                             f"divide over batch axes of {batch} ranks (expert parallelism)")
        if pair[0] == "model":
            uneven = {k: w for k, w, n in (("num_experts", mo.num_experts, size),
                                           ("d_ff_expert", mo.d_ff_expert, data)) if w % n}
            if uneven:
                raise ValueError(f"{cfg.name}: {uneven} do not divide over the experts' model "
                                 f"axis of {size} and their d_ff's data axis of {data} ranks")
    if size == 1:
        return
    widths = {"padded_vocab": cfg.padded_vocab}  # audio: each codebook's
    if mo is None:
        widths["d_ff"] = cfg.d_ff  # 0 for an ssm block
    else:  # the shared experts' d_ff over 'model' under either layout (C.21)
        if policy.expert_axis == "data":
            widths["d_ff_expert"] = mo.d_ff_expert
        widths["d_ff_shared"] = mo.d_ff_expert * mo.num_shared
    if cfg.mla is not None:  # MLA's heads: each rank scores its own
        widths["mla_heads"] = cfg.num_heads
    if cfg.has_ssm:  # z and the gated norm on d_inner, the conv on its channels
        ssm = cfg.ssm
        widths.update(d_inner=ssm.d_inner(cfg.d_model),
                      conv_channels=ssm.d_inner(cfg.d_model) + 2 * ssm.d_state)
        if ssm.n_heads(cfg.d_model) % size:  # the heads' fallback: their head dim
            widths["ssm_head_dim"] = ssm.head_dim
    uneven = {k: w for k, w in widths.items() if w % size}
    if uneven:
        raise ValueError(f"{cfg.name}: {uneven} do not divide over a model axis of {size}")


EXPERT_LEAVES = ("blocks/moe/w_gate", "blocks/moe/w_up", "blocks/moe/w_down")


def is_expert_leaf(name: str) -> bool:
    """Whether the port's parameter ``name`` is a routed expert leaf ([E, D,
    F] or [E, F, D]; the shared experts' are not)."""
    return reference_key(name)[0] in EXPERT_LEAVES


def _experts_on_mesh(mesh, cfg: ArchConfig, policy: ShardingPolicy) -> bool:
    """Whether ``cfg``'s routed experts are DTensors on the whole of
    ``mesh``: split over its batch axes (expert parallelism), or under
    ``expert_axis="model"`` on any mesh wider than one rank (E over
    'model', each expert's d_ff over 'data')."""
    if cfg.moe is None:
        return False
    if policy.expert_axis == "model":
        return batch_ranks(mesh) > 1 or _model_width(mesh) > 1
    return batch_ranks(mesh) > 1


def _check(cfg: ArchConfig, policy: ShardingPolicy, mesh) -> None:
    """:func:`check_model_axis` at ``mesh``'s widths."""
    names = tuple(mesh.mesh_dim_names or ())
    data = mesh.size(names.index("data")) if "data" in names else 1
    check_model_axis(cfg, policy, _model_width(mesh), batch_ranks(mesh), data)


def _place(mesh, policy: ShardingPolicy, experts: bool):
    """``place(name, leaf)`` -> the DTensor of this rank's shard of a leaf
    (a whole tensor, or a :class:`~repro_torch.models.layers.Deferred` one,
    of which only the rows of dim 0 the shard needs are made): with
    ``experts``, a routed expert leaf on the whole mesh (E over the batch
    axes and F over 'model', or E over 'model' and F over 'data'), every
    other leaf on the model submesh (a plain tensor, whole, where the model
    axis is 1)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    tp = model_mesh(mesh)

    def place(name, leaf):
        shape = tuple(leaf.shape)
        on = mesh if experts and is_expert_leaf(name) else tp
        if on is None:
            return leaf() if callable(leaf) else leaf
        pl = placements(on, _leaf_spec(name, shape, policy))
        size, offset = compute_local_shape_and_global_offset(shape, on, pl)
        rows = slice(offset[0], offset[0] + size[0])
        t = leaf(rows) if callable(leaf) else leaf[rows]
        index = tuple(slice(o, o + n) for o, n in zip(offset[1:], size[1:]))
        local = t[(slice(None), *index)].clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, on, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    return place


def _model_width(mesh) -> int:
    tp = model_mesh(mesh)
    return 1 if tp is None else tp.size()


def tp_distribute(model, mesh, policy: ShardingPolicy | None = None):
    """Make ``model``'s weights DTensors on ``mesh`` in place, each with the
    placement its spec gives: a routed expert leaf of an MoE model on the
    whole mesh (:func:`_experts_on_mesh`: E over 'pod' and 'data' and F
    over 'model' under expert parallelism, E over 'model' and F over
    'data' under ``expert_axis="model"``), every other weight on the model
    submesh (its spec's model entry); returns the model (unchanged on a
    model axis of 1 without experts on the mesh).  Each rank keeps its
    shard of the whole weights it holds."""
    policy = policy or ShardingPolicy()
    width, experts = _model_width(mesh), _experts_on_mesh(mesh, model.cfg, policy)
    if width == 1 and not experts:
        return model
    _check(model.cfg, policy, mesh)
    place = _place(mesh, policy, experts)
    for name, p in list(model.named_parameters()):
        if isinstance(p, DTensor):
            raise ValueError(f"{name} is already sharded")
        owner, leaf = model.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
        setattr(owner, leaf, torch.nn.Parameter(place(name, p.detach()),
                                                requires_grad=p.requires_grad))
    return model


def init_sharded(cfg: ArchConfig, mesh, seed: int = 0, dtype=torch.bfloat16, device=None,
                 policy: ShardingPolicy | None = None):
    """:func:`repro_torch.models.init_params`'s model, the same draws, each
    weight placed as :func:`tp_distribute` places it as it is drawn: a
    rank draws only the rows of dim 0 its shard needs (an expert leaf:
    its experts, the generator run on past the others; then its d_ff
    columns cut), and never holds more than one leaf whole (how a model no
    card holds is made)."""
    from repro_torch.models import init_params

    policy = policy or ShardingPolicy()
    width, experts = _model_width(mesh), _experts_on_mesh(mesh, cfg, policy)
    if width == 1 and not experts:
        return init_params(cfg, seed, dtype, device)
    _check(cfg, policy, mesh)
    return init_params(cfg, seed, dtype, device, place=_place(mesh, policy, experts))


def _data_dim(spec) -> int | None:
    """The tensor dim ``spec`` puts over the 'data' axis, if any."""
    for dim, entry in enumerate(spec):
        if entry is not None and "data" in ((entry,) if isinstance(entry, str) else entry):
            return dim
    return None


def shard_model(model, mesh, policy: ShardingPolicy | None = None):
    """Shard ``model`` for training over a ``(data, model)`` mesh (or a 1-D
    'data' mesh), in place; returns it.  A model axis wider than 1 first
    makes each weight a DTensor on the model submesh
    (:func:`tp_distribute`, unless the model is already sharded so).  Then
    FSDP2 over 'data': each block, then the root, becomes an FSDP module;
    each weight is split on the dim :func:`param_specs` puts over 'data';
    the leaves it puts over none stay whole on every data rank (see the
    module doc).  Call before the optimizer state is made."""
    from torch.distributed.fsdp import fully_shard

    policy = policy or ShardingPolicy()
    dp = _data_mesh(mesh)
    if not any(isinstance(p, DTensor) for p in model.parameters()):  # else: init_sharded's
        tp_distribute(model, mesh, policy)
    specs = param_specs(model, policy)
    dims = {p: _data_dim(specs[n]) for n, p in model.named_parameters()}
    # kept whole on every data rank, or (the experts on the mesh) split already
    whole = {p for p, d in dims.items() if d is None}
    if _experts_on_mesh(mesh, model.cfg, policy):
        whole |= {p for n, p in model.named_parameters() if is_expert_leaf(n)}

    def placement(p):
        return Shard(dims[p])

    for blk in model.blocks:
        fully_shard(blk, mesh=dp, shard_placement_fn=placement, ignored_params=whole)
    fully_shard(model, mesh=dp, shard_placement_fn=placement, ignored_params=whole)
    return model


def is_sharded(model) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def data_group(model):
    """The process group of a sharded model's data ranks (``None`` for a
    model that is not sharded)."""
    if not is_sharded(model):
        return None
    for p in model.parameters():
        names = tuple(p.device_mesh.mesh_dim_names or ()) if isinstance(p, DTensor) else ()
        if "data" in names:
            return p.device_mesh.get_group("data")
    raise ValueError("a sharded model without a sharded parameter")


def _all_reduce_mean(tensors: list, group) -> None:
    """Average ``tensors`` over ``group``'s ranks in place, in one flat
    all-reduce (gloo has no average: a sum, then the division)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _replicated_over_data(p) -> bool:
    """A leaf every data rank holds whole: a plain tensor, or a DTensor on
    the model submesh only (FSDP's leaves and the experts on the whole
    mesh are DTensors on a mesh with 'data')."""
    return not isinstance(p, DTensor) or "data" not in (p.device_mesh.mesh_dim_names or ())


@torch.no_grad()
def reduce_replicated_grads(model) -> None:
    """Average over the data ranks the gradients of the leaves a sharded
    model keeps whole (FSDP reduce-scatters its own; an expert leaf on the
    whole mesh is no replica: :func:`mean_expert_grads`).  On a
    model axis such a leaf's gradient can come back as a partial sum over
    it: it is reduced to the leaf's own placement first."""
    group = data_group(model)
    if group is None:
        return
    grads = []
    for p in model.parameters():
        if not _replicated_over_data(p) or p.grad is None:
            continue
        if isinstance(p.grad, DTensor):
            if tuple(p.grad.placements) != tuple(p.placements):
                p.grad = p.grad.redistribute(placements=p.placements)
            grads.append(p.grad.to_local())
        else:
            grads.append(p.grad)
    _all_reduce_mean(grads, group)


@torch.no_grad()
def mean_expert_grads(model, grads: dict) -> None:
    """Divide each expert leaf's gradient in ``grads`` (by name, in place)
    by the batch ranks whose slots reach its slab: those it is split over
    (on E under expert parallelism, on d_ff under ``expert_axis="model"``).
    The slab's gradient comes back through the exchange's backward as the
    sum of those ranks' losses' gradients; the global batch's is their
    mean, as FSDP's reduce-scatter averages the other leaves'.  Once a
    step, after the last microbatch (the division is linear).  A slab
    replicated over 'pod' would need its replicas averaged too, but FSDP
    trains on ('data', 'model') meshes only (:func:`shard_model`)."""
    for name, p in model.named_parameters():
        if is_expert_leaf(name) and isinstance(p, DTensor):
            names, ranks = p.device_mesh.mesh_dim_names, 1
            for i, pl in enumerate(p.placements):
                if names[i] in DP and pl.is_shard():
                    ranks *= p.device_mesh.size(i)
            if ranks > 1:
                g = grads[name]
                (g.to_local() if isinstance(g, DTensor) else g).div_(ranks)


@torch.no_grad()
def mean_over_ranks(t: torch.Tensor, model) -> torch.Tensor:
    """``t`` averaged over a sharded model's data ranks (``t`` itself for a
    model that is not sharded)."""
    group = data_group(model)
    if group is None:
        return t
    out = t.detach().clone().float()
    _all_reduce_mean([out], group)
    return out
