"""Sharding rules: a :class:`~repro_torch.models.layers.PartitionSpec` for
every parameter, optimizer moment, batch and cache leaf, their DTensor
placements on a ``DeviceMesh``, and FSDP training over the data axis.  The
port of the reference's ``runtime/sharding.py``, its rules kept as data.

Conventions (mesh axes: optional 'pod', 'data', 'model'):
  * weights [.., d_in, d_out]:  d_in over 'data' (FSDP/ZeRO-3), d_out over
    'model' (TP) — flipped for down/output projections so TP contracts;
  * expert weights [E, D, F]: E over 'data' (expert parallelism), F over
    'model';
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
the Mamba mixer's ``A_log``, ``D``, ``dt_bias`` and ``conv_w``: ``P(None)``
in the reference) stays whole on every rank, outside FSDP
(``ignored_params``); :func:`reduce_replicated_grads` averages its
gradients over the ranks.  The AdamW moments are created like their
parameters (:func:`repro_torch.optim.adamw_init`), so each rank holds
its shard of them too (ZeRO).  A model axis wider than 1 (tensor parallelism)
is not run by any entry point of either package and is refused here.
Each rank computes its loss over its own rows, so an MoE layer's aux loss
and gshard capacity are those of the rank's tokens, where the reference's
partitioner computes them over the global batch (ROADMAP C.19); dense
families train as one process does.

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch llama3.2-3b --smoke --device cpu --steps 4 --batch 4
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.config import ArchConfig, ShardingPolicy
from repro_torch.convert import reference_key
from repro_torch.models.layers import PartitionSpec as P
from repro_torch.models.layers import fix_spec

__all__ = ["param_specs", "batch_specs", "cache_specs", "shardings_for", "named",
           "NamedSharding", "placements", "shard_model", "is_sharded",
           "data_group", "reduce_replicated_grads", "mean_over_ranks"]

DP = ("pod", "data")


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
    out = {}
    for name, t in named_leaves(tree).items():
        key, layer = reference_key(name)
        spec = _rule(tuple(key.split("/")), (1, *t.shape) if layer is not None else tuple(t.shape),
                     policy)
        out[name] = spec if layer is None else P(*spec[1:])
    return out


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


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (axes the mesh lacks
    dropped): a tensor dim over several mesh axes is ``Shard`` on each of
    them, the first major, as JAX orders them."""
    spec = fix_spec(mesh, spec)
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in ((entry,) if isinstance(entry, str) else entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {dim} is sharded over mesh axes out of the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


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
    """The 1-D 'data' mesh of a ('data', 'model') mesh whose model axis is 1."""
    names = tuple(mesh.mesh_dim_names or ())
    if "data" not in names or set(names) - {"data", "model"}:
        raise ValueError(f"FSDP runs over a ('data', 'model') mesh; got axes {names}")
    if "model" in names and mesh.size(names.index("model")) != 1:
        raise ValueError("a model axis wider than 1 (tensor parallelism) is not run by any "
                         "entry point of the port or the reference")
    return mesh["data"] if len(names) > 1 else mesh


def _data_dim(spec) -> int | None:
    """The tensor dim ``spec`` puts over the 'data' axis, if any."""
    for dim, entry in enumerate(spec):
        if entry is not None and "data" in ((entry,) if isinstance(entry, str) else entry):
            return dim
    return None


def shard_model(model, mesh, policy: ShardingPolicy | None = None):
    """Shard ``model`` for training with FSDP2 over ``mesh``'s 'data' axis
    (a ``(data, model)`` mesh with a model axis of 1, or a 1-D 'data'
    mesh), in place; returns it.  Each block, then the root, becomes an
    FSDP module; each weight is split on the dim :func:`param_specs` puts
    over 'data'; the leaves it puts over none stay whole on every rank
    (see the module doc).  Call before the optimizer state is made."""
    from torch.distributed.fsdp import fully_shard

    dp = _data_mesh(mesh)
    specs = param_specs(model, policy)
    dims = {p: _data_dim(specs[n]) for n, p in model.named_parameters()}
    whole = {p for p, d in dims.items() if d is None}

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
    """The process group a sharded model's weights are split over (``None``
    for a model that is not sharded)."""
    if not is_sharded(model):
        return None
    for p in model.parameters():
        if isinstance(p, DTensor):
            return p.device_mesh.get_group()
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


@torch.no_grad()
def reduce_replicated_grads(model) -> None:
    """Average over the data ranks the gradients of the leaves a sharded
    model keeps whole (FSDP reduce-scatters the others itself)."""
    group = data_group(model)
    if group is not None:
        _all_reduce_mean([p.grad for p in model.parameters()
                          if not isinstance(p, DTensor) and p.grad is not None], group)


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
