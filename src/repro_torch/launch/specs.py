"""Dry-run cell construction: (arch x shape x mesh) -> (step function,
inputs on the meta device, their placements).  The port of the
reference's ``launch/specs.py``.

``input_specs`` returns tensors on the meta device in place of the
reference's ``ShapeDtypeStruct``s: every model input's shape and dtype,
nothing allocated; the full configurations are only ever touched through
them.  ``build_cell`` pairs the step function (``make_train_step``, a
prefill function, or ``make_serve_step``) with the :class:`NamedSharding`
of each input leaf and output on a mesh (a ``DeviceMesh``, e.g. the
production mesh over a fake process group:
:mod:`repro_torch.launch.dryrun`).  The step runs under
:func:`~repro_torch.models.layers.activate_mesh` of the cell's mesh, so on
a mesh with a model axis wider than 1 it runs on real ranks with DTensor
inputs (the model sharded by :mod:`repro_torch.runtime.sharding`) as the
reference's partitioned program (every family), and an MoE model's train,
prefill and decode steps on batch axes wider than 1 run expert
parallelism (each rank its E / ranks experts, the slots sent to them by
all-to-all: :mod:`repro_torch.models.moe`), or under
``expert_axis="model"`` the experts over 'model' and their d_ff over
'data' (every data rank's slots gathered to each rank's slabs).  The
serving cells take the int8 KV cache and the hand-written kernels
(``attention_impl="cuda"``) on a mesh too; a model axis not named 'model'
raises when its step runs (ROADMAP A.18), and so do an MoE model's experts
and their d_ff over one axis (C.20).

Cell skip policy: ``long_500k`` runs only for sub-quadratic archs (ssm /
hybrid-with-SWA); dense-attention archs get a recorded skip (a 500k dense
KV cache is not deployable).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.config import (SHAPES, ArchConfig, ShapeConfig, ShardingPolicy, TrainConfig,
                                get_arch)
from repro_torch.models import activate_mesh, cache_shapes, param_shapes, prefill
from repro_torch.models.layers import PartitionSpec as P
from repro_torch.models.layers import batch_ranks
from repro_torch.optim import AdamWState
from repro_torch.runtime import TrainState, make_serve_step, make_train_state, make_train_step
from repro_torch.runtime.sharding import (DP, batch_specs, cache_specs, check_model_axis, named,
                                          param_specs)

__all__ = ["Cell", "input_specs", "build_cell", "cell_skip_reason", "all_cells", "mesh_axis_size"]


@dataclasses.dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeConfig
    kind: str  # train | prefill | decode
    fn: Callable
    args: tuple  # inputs on the meta device
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple  # the inputs the step updates in place (the reference donates them)


def cell_skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "long_500k needs sub-quadratic attention / bounded decode state; "
            f"{cfg.name} is full-attention (dense 500k KV cache undeployable)"
        )
    return None


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_specs(cfg: ArchConfig, batch: int, seq: int, kind: str) -> dict:
    """Meta tensors for one batch of model inputs."""
    i32 = torch.int32
    if kind in ("train", "prefill"):
        if cfg.family == "audio":
            toks = _meta((batch, seq, cfg.num_codebooks), i32)
        elif cfg.family == "vlm":
            toks = _meta((batch, seq - cfg.num_patches), i32)
        else:
            toks = _meta((batch, seq), i32)
        out = {"tokens": toks}
        if cfg.family == "vlm":
            out["patches"] = _meta((batch, cfg.num_patches, cfg.patch_dim), torch.float32)
        if kind == "train":
            out["labels"] = _meta(toks.shape, i32)
        return out
    # decode: one new token against a cache of seq_len
    if cfg.family == "audio":
        return {"tokens": _meta((batch, 1, cfg.num_codebooks), i32)}
    return {"tokens": _meta((batch, 1), i32)}


def input_specs(arch: str | ArchConfig, shape: str | ShapeConfig,
                policy: ShardingPolicy | None = None, tcfg: TrainConfig | None = None,
                param_dtype=torch.bfloat16) -> dict:
    """Meta-device (no-allocation) inputs of one (arch, shape) cell.

    train  -> {state, batch}
    prefill-> {params, batch}
    decode -> {params, cache, batch, cache_len}
    """
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    policy = policy or ShardingPolicy()
    tcfg = tcfg or TrainConfig()
    B, S = shp.global_batch, shp.seq_len
    batch = _token_specs(cfg, B, S, shp.kind)
    params = param_shapes(cfg, policy, dtype=param_dtype)
    if shp.kind == "train":
        return {"state": make_train_state(params, tcfg), "batch": batch}
    if shp.kind == "prefill":
        return {"params": params, "batch": batch}
    cache = cache_shapes(cfg, B, S, dtype=param_dtype, kv_dtype=policy.kv_cache_dtype)
    return {"params": params, "cache": cache, "batch": batch,
            "cache_len": _meta((), torch.int32)}


def mesh_axis_size(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names)
    return mesh.size(names.index(axis)) if axis in names else 1


def _batch_shardings(mesh, cfg: ArchConfig, kind: str, batch_size: int, policy) -> dict:
    spec = batch_specs(cfg, policy, batch_size=batch_size)
    if kind == "prefill":
        spec.pop("labels", None)
    if kind == "decode":
        dp = DP if batch_size > 1 else None
        spec = {"tokens": P(dp, None) if cfg.family != "audio" else P(dp, None, None)}
    return named(mesh, spec)


def _on_mesh(fn, mesh, cfg: ArchConfig, policy: ShardingPolicy):
    """``fn`` run under ``mesh``; on a mesh wider than one rank only where
    ``check_model_axis`` lets the policy's layout run."""
    width, batch = mesh_axis_size(mesh, "model"), batch_ranks(mesh)

    def step(*args):
        if width > 1 or batch > 1:
            check_model_axis(cfg, policy, width, batch, mesh_axis_size(mesh, "data"))
        with activate_mesh(mesh):
            return fn(*args)

    return step


def build_cell(mesh, arch: str | ArchConfig, shape: str | ShapeConfig,
               policy: ShardingPolicy | None = None, tcfg: TrainConfig | None = None,
               param_dtype=torch.bfloat16) -> Cell:
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    policy = policy or ShardingPolicy()
    tcfg = tcfg or TrainConfig()
    reason = cell_skip_reason(cfg, shp)
    if reason:
        raise ValueError(f"skipped cell: {reason}")
    specs = input_specs(cfg, shp, policy, tcfg, param_dtype)
    kind = shp.kind
    rep = named(mesh, P())

    if kind == "train":
        state = specs["state"]
        p_sh = named(mesh, param_specs(state.params, policy))
        state_sh = TrainState(params=p_sh, opt=AdamWState(step=rep, m=p_sh, v=p_sh))
        b_sh = _batch_shardings(mesh, cfg, kind, shp.global_batch, policy)
        fn = _on_mesh(make_train_step(cfg, policy, tcfg), mesh, cfg, policy)
        return Cell(cfg, shp, kind, fn, (state, specs["batch"]), (state_sh, b_sh),
                    (state_sh, None), donate_argnums=(0,))

    p_sh = named(mesh, param_specs(specs["params"], policy))
    mdiv = mesh_axis_size(mesh, policy.model_axis)
    c_sh = named(mesh, cache_specs(cfg, policy, batch_size=shp.global_batch,
                                   model_divisor=mdiv))
    b_sh = _batch_shardings(mesh, cfg, kind, shp.global_batch, policy)

    if kind == "prefill":
        def prefill_fn(params, batch):
            logits, cache, _ = prefill(params, cfg, policy, batch["tokens"], batch.get("patches"),
                                       max_len=shp.seq_len)
            return logits, cache

        return Cell(cfg, shp, kind, _on_mesh(prefill_fn, mesh, cfg, policy),
                    (specs["params"], specs["batch"]),
                    (p_sh, b_sh), (None, c_sh), donate_argnums=())

    serve = make_serve_step(cfg, policy)

    def serve_fn(params, cache, batch, cache_len):
        return serve(params, cache, batch["tokens"], cache_len)

    return Cell(cfg, shp, kind, _on_mesh(serve_fn, mesh, cfg, policy),
                (specs["params"], specs["cache"], specs["batch"], specs["cache_len"]),
                (p_sh, c_sh, b_sh, rep), (None, c_sh), donate_argnums=(1,))


def all_cells() -> list:
    """Every assigned (arch, shape) pair, with skip markers."""
    from repro_torch.config import list_archs

    out = []
    for a in list_archs():
        if a.endswith("-smoke"):
            continue
        cfg = get_arch(a)
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            out.append((a, s, cell_skip_reason(cfg, SHAPES[s])))
    return out
