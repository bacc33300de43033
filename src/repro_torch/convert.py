"""Devices, and the reference's state carried into the port.

:func:`resolve_device` is the port's one device rule: ``None`` means the
CUDA card, and asking for the card where there is none raises — nothing
moves to the CPU on its own.  Only an explicit ``device="cpu"`` runs there.

:func:`from_reference` turns state of the JAX package, given as NumPy
(instance arrays, packed bucket arrays, LP stacks, cached gammas, warm
bases), into tensors on a device, checking dtypes and shapes.
:func:`params_from_reference`, :func:`cache_from_reference` and
:func:`policy_from_reference` carry a model's parameter tree, decode cache
and policy across; :func:`train_state_from_reference` and
:func:`train_state_to_reference` carry a training state (parameters, AdamW
moments, step) both ways, in the reference's tree: the blocks' leaves
stacked ``[L, ...]`` where the port keeps one module a layer.  The port
never imports the JAX package; the state arrives as plain arrays, dicts of
them, or objects whose fields are arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["resolve_device", "from_reference", "instance_from_reference", "to_tensor",
           "params_from_reference", "cache_from_reference", "policy_from_reference",
           "reference_key", "leaves_to_reference", "array_to_tensor", "tensor_to_numpy",
           "flatten_tree", "train_state_from_reference", "train_state_to_reference"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless the "
            "caller passes device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu'; got {dev}")
    return dev


_FLOAT_KINDS = ("f",)
_INT_KINDS = ("i", "u")


def to_tensor(arr, device, dtype=None) -> torch.Tensor:
    """One NumPy array as a contiguous tensor on ``device``.

    Floating arrays must be float64 (the engine is float64 end to end) and
    integer arrays keep their width; booleans stay booleans.  ``dtype``
    converts explicitly (e.g. a bool mask to float64)."""
    a = np.asarray(arr)
    if dtype is None:
        if a.dtype.kind in _FLOAT_KINDS and a.dtype != np.float64:
            raise TypeError(f"expected float64 state, got {a.dtype}")
        if a.dtype.kind not in _FLOAT_KINDS + _INT_KINDS + ("b",):
            raise TypeError(f"cannot carry {a.dtype} state into a tensor")
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype).contiguous()


# expected shapes of the reference's packed bucket fields, by field name,
# in terms of (B, m, T)
_BUCKET_SHAPES = {
    "w_cell": ("B", "m", "T"), "z": ("B", "m-1"), "latency": ("B", "m-1"),
    "tau": ("B", "m"), "vcomm_cell": ("B", "T"), "vcomp_cell": ("B", "T"),
    "rel_cell": ("B", "T"), "ret_cell": ("B", "T"), "cell_valid": ("T",),
    "load_of_cell": ("T",),
}


def _check_bucket(fields: dict) -> None:
    B, m, T = fields["w_cell"].shape
    dims = {"B": B, "m": m, "m-1": m - 1, "T": T}
    for name, spec in _BUCKET_SHAPES.items():
        want = tuple(dims[d] for d in spec)
        got = tuple(np.shape(fields[name]))
        if got != want:
            raise ValueError(f"bucket field {name} is {got}, expected {want}")


def _check_lp_stack(fields: dict) -> None:
    c = np.shape(fields["c"])
    for a, b in (("A_ub", "b_ub"), ("A_eq", "b_eq")):
        A, rhs = np.shape(fields[a]), np.shape(fields[b])
        if len(A) != 3 or rhs != A[:2] or A[2] != c[-1] or (len(c) == 2 and A[0] != c[0]):
            raise ValueError(f"LP stack {a} {A} / {b} {rhs} disagree with c {c}")


def from_reference(state, device=None):
    """The reference's state as tensors on ``device`` (see the module doc).

    ``state`` may be a NumPy array (-> a tensor), a mapping of arrays (->
    a dict of tensors), a dataclass such as the reference's
    ``PackedBucket``, ``BatchedLP`` or ``CachedSolution`` (-> a dict of its
    array fields as tensors; other fields are passed through), or a list of
    any of these.  Packed buckets (``w_cell`` ...) and LP stacks
    (``A_ub``/``b_ub``/``A_eq``/``b_eq`` beside ``c``) are checked for
    consistent shapes.  A list of warm bases with ``None`` rows converts row
    by row, keeping the ``None`` rows."""
    dev = resolve_device(device)
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return [from_reference(s, dev) for s in state]
    if isinstance(state, np.ndarray) or np.isscalar(state):
        return to_tensor(state, dev)
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    elif isinstance(state, dict):
        fields = dict(state)
    else:
        raise TypeError(f"cannot carry a {type(state).__name__} into the port")
    if _BUCKET_SHAPES.keys() <= fields.keys():
        _check_bucket(fields)
    if {"A_ub", "b_ub", "A_eq", "b_eq", "c"} <= fields.keys():
        _check_lp_stack(fields)
    return {k: to_tensor(v, dev) if isinstance(v, np.ndarray) else v
            for k, v in fields.items()}


def instance_from_reference(inst):
    """The port's :class:`~repro_torch.core.instance.Instance` with the same
    arrays as a reference instance (NumPy stays NumPy: instances are host
    data in both packages)."""
    from repro_torch.core.instance import Chain, Instance, Loads, Star

    kinds = {"chain": Chain, "star": Star}
    p, ld = inst.platform, inst.loads
    if p.kind not in kinds:
        raise ValueError(f"unknown topology {p.kind!r}")
    platform = kinds[p.kind](w=p.w.copy(), z=p.z.copy(), tau=p.tau.copy(),
                             latency=p.latency.copy())
    loads = Loads(v_comm=ld.v_comm.copy(), v_comp=ld.v_comp.copy(),
                  release=ld.release.copy(), return_ratio=ld.return_ratio.copy())
    wpl = None if inst.w_per_load is None else np.array(inst.w_per_load)
    return Instance(platform, loads, q=tuple(inst.q), w_per_load=wpl)


# ---------------------------------------------------------------- models


def _model_tensor(arr, device, what: str, shape: tuple, dtypes: tuple) -> torch.Tensor:
    """One reference leaf as a tensor, its shape and dtype checked.  NumPy has
    no bfloat16 of its own: a bfloat16 leaf (``ml_dtypes``) crosses as its
    16-bit pattern."""
    a = np.asarray(arr)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{what} is {tuple(a.shape)}, expected {tuple(shape)}")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    elif a.dtype.name in ("float32", "int8"):
        t = torch.from_numpy(np.array(a))
    else:
        raise TypeError(f"{what} is {a.dtype}; the port takes float32, bfloat16 or int8")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} is {t.dtype}, expected one of {dtypes}")
    return t.to(device)


def _block_layout(cfg) -> dict:
    """Shapes of one block's leaves in the reference's tree, by family."""
    D, H, KVH, hd, F = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    layout: dict = {"ln1": (D,)}
    if cfg.mla is not None:
        m = cfg.mla
        dn, dr, dv, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank
        layout["attn"] = {"w_q": (D, H * (dn + dr)), "w_dkv": (D, r), "w_kr": (D, dr),
                          "w_uk": (r, H * dn), "w_uv": (r, H * dv), "w_o": (H * dv, D)}
    elif cfg.family != "ssm":
        layout["attn"] = {"w_q": (D, H * hd), "w_k": (D, KVH * hd), "w_v": (D, KVH * hd),
                          "w_o": (H * hd, D)}
    if cfg.family in ("ssm", "hybrid"):
        ssm = cfg.ssm
        d_in, h = ssm.d_inner(D), ssm.n_heads(D)
        conv = d_in + 2 * ssm.d_state
        layout["mamba"] = {"w_z": (D, d_in), "w_xbc": (D, conv), "w_dt": (D, h),
                           "conv_w": (ssm.d_conv, conv), "A_log": (h,), "D": (h,),
                           "dt_bias": (h,), "norm_w": (d_in,), "w_out": (d_in, D)}
    if cfg.family == "moe":
        mo = cfg.moe
        E, f = mo.num_experts, mo.d_ff_expert
        layout["ln2"] = (D,)
        layout["moe"] = {"router": (D, E), "w_gate": (E, D, f), "w_up": (E, D, f),
                         "w_down": (E, f, D)}
        if mo.num_shared:
            fs = f * mo.num_shared
            layout["moe"]["shared"] = {"w_gate": (D, fs), "w_up": (D, fs), "w_down": (fs, D)}
    elif cfg.family != "ssm":
        layout["ln2"] = (D,)
        layout["mlp"] = {"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
    return layout


def _top_layout(cfg) -> dict:
    """Shapes of the leaves outside the blocks, by family."""
    D, V = cfg.d_model, cfg.padded_vocab
    if cfg.family == "audio":
        layout = {"embed": (cfg.num_codebooks, V, D), "heads": (cfg.num_codebooks, D, V)}
    else:
        layout = {"embed": (V, D)} | ({} if cfg.tie_embeddings else {"head": (D, V)})
    if cfg.family == "vlm":
        layout["patch_proj"] = (cfg.patch_dim, D)
    return layout | {"ln_f": (D,)}


# leaves the reference keeps in float32 whatever the parameters' dtype
_FLOAT32_LEAVES = {"mamba.A_log", "mamba.D", "mamba.dt_bias"}


def params_from_reference(params_np: dict, cfg, device=None):
    """The reference's parameter tree (``init_params``'s dict, leaves as
    NumPy, blocks stacked ``[L, ...]``) as the port's
    :class:`~repro_torch.models.Transformer` on ``device``, for every
    family.  The tree's keys and every leaf's shape are checked against
    ``cfg``, and all leaves must share one dtype (float32 or bfloat16)
    except the Mamba mixer's ``A_log``, ``D`` and ``dt_bias``, which are
    float32."""
    from repro_torch.models import Transformer

    dev = resolve_device(device)
    L = cfg.num_layers
    top = _top_layout(cfg)
    if set(params_np) != set(top) | {"blocks"}:
        raise ValueError(f"parameter tree has {sorted(params_np)}, expected "
                         f"{sorted(set(top) | {'blocks'})}")
    dtype = np.asarray(params_np["embed"]).dtype.name
    floats = {"float32": (torch.float32,), "bfloat16": (torch.bfloat16,)}.get(dtype)
    if floats is None:
        raise TypeError(f"embed is {dtype}; the port takes float32 or bfloat16 parameters")

    def carry(tree, layout, what, lead=()):
        """``tree`` checked against ``layout`` (nested dicts of shapes), its
        leaves as tensors; ``lead`` the stacked layer axis."""
        if not isinstance(tree, dict) or set(tree) != set(layout):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{what} has {got}, expected {sorted(layout)}")
        out = {}
        for name, spec in layout.items():
            path = f"{what}.{name}" if what else name
            if isinstance(spec, dict):
                out[name] = carry(tree[name], spec, path, lead)
            else:
                kinds = (torch.float32,) if path[len("blocks."):] in _FLOAT32_LEAVES else floats
                out[name] = _model_tensor(tree[name], dev, path, (*lead, *spec), kinds)
        return out

    def layer(t, l):
        return {k: layer(v, l) if isinstance(v, dict) else v[l] for k, v in t.items()}

    tree = carry({k: v for k, v in params_np.items() if k != "blocks"}, top, "")
    stacked = carry(params_np["blocks"], _block_layout(cfg), "blocks", (L,))
    tree["blocks"] = [layer(stacked, l) for l in range(L)]
    return Transformer(cfg, tree)


def cache_from_reference(cache_np: dict, cfg, device=None) -> dict:
    """The reference's decode cache (``init_cache``/``prefill``'s dict,
    leaves as NumPy) as the port's dict of tensors on ``device``, in the same
    tree: with attention ``k``/``v`` ``[L, B, S, KVH, hd]`` (float32,
    bfloat16 or int8 alike) and for int8 the float32 ``k_scale``/``v_scale``
    ``[L, B, S, KVH]``; with an SSM ``ssm`` = {``conv`` ``[L, B, d_conv - 1,
    conv_dim]`` (float32 or bfloat16), ``state`` ``[L, B, H, P, N]``
    (float32)}.  The port keeps the reference's tree, so a leaf's
    ``.numpy()`` is the reference's array again.  With MLA the attention
    cache is ``mla`` = {``c_kv`` ``[L, B, S, r]``, ``k_pe`` ``[L, B, S,
    dr]``} (float32 or bfloat16) in place of ``k``/``v``."""
    dev = resolve_device(device)
    names = set(cache_np)
    if cfg.mla is not None:
        if names != {"mla"} or set(cache_np["mla"]) != {"c_kv", "k_pe"}:
            raise ValueError(f"cache has {sorted(names)}; the port's MLA cache is "
                             "{'mla': {'c_kv', 'k_pe'}}")
        m, L = cfg.mla, cfg.num_layers
        c_kv = np.asarray(cache_np["mla"]["c_kv"])
        B, S = c_kv.shape[1:3] if c_kv.ndim == 4 else (-1, -1)  # the caller's
        out = {name: _model_tensor(cache_np["mla"][name], dev, f"cache mla.{name}",
                                   (L, B, S, width), (torch.float32, torch.bfloat16))
               for name, width in (("c_kv", m.kv_lora_rank), ("k_pe", m.qk_rope_head_dim))}
        if out["k_pe"].dtype != out["c_kv"].dtype:
            raise TypeError(f"cache c_kv is {out['c_kv'].dtype}, k_pe {out['k_pe'].dtype}")
        return {"mla": out}
    kv = {"k", "v"} if cfg.has_attention else set()
    ssm_names = {"ssm"} if cfg.has_ssm else set()
    allowed = [kv | ssm_names] + ([kv | {"k_scale", "v_scale"} | ssm_names] if kv else [])
    if names not in allowed:
        raise ValueError(f"cache has {sorted(names)}; the port's {cfg.family} cache is "
                         f"{sorted(allowed[0])} (and k_scale, v_scale for int8)")
    out: dict = {}
    if kv:
        k = np.asarray(cache_np["k"])
        if k.ndim != 5 or k.shape[0] != cfg.num_layers or k.shape[3:] != (cfg.num_kv_heads,
                                                                           cfg.head_dim):
            raise ValueError(f"cache k is {k.shape}, expected [L={cfg.num_layers}, B, S, "
                             f"KVH={cfg.num_kv_heads}, hd={cfg.head_dim}]")
        int8 = "k_scale" in names
        kv_types = (torch.int8,) if int8 else (torch.float32, torch.bfloat16)
        for n in ("k", "v"):
            out[n] = _model_tensor(cache_np[n], dev, f"cache {n}", k.shape, kv_types)
        if out["v"].dtype != out["k"].dtype:
            raise TypeError(f"cache k is {out['k'].dtype}, v {out['v'].dtype}")
        if int8:
            for n in ("k_scale", "v_scale"):
                out[n] = _model_tensor(cache_np[n], dev, f"cache {n}", k.shape[:-1],
                                       (torch.float32,))
    if cfg.has_ssm:
        ssm_np = cache_np["ssm"]
        if set(ssm_np) != {"conv", "state"}:
            raise ValueError(f"cache ssm has {sorted(ssm_np)}, expected ['conv', 'state']")
        ssm, D, L = cfg.ssm, cfg.d_model, cfg.num_layers
        conv = np.asarray(ssm_np["conv"])
        B = conv.shape[1] if conv.ndim > 1 else -1  # the batch is the caller's
        out["ssm"] = {
            "conv": _model_tensor(conv, dev, "cache ssm.conv",
                                  (L, B, ssm.d_conv - 1, ssm.d_inner(D) + 2 * ssm.d_state),
                                  (torch.float32, torch.bfloat16)),
            "state": _model_tensor(ssm_np["state"], dev, "cache ssm.state",
                                   (L, B, ssm.n_heads(D), ssm.head_dim, ssm.d_state),
                                   (torch.float32,)),
        }
    return out


def policy_from_reference(policy):
    """The port's :class:`~repro_torch.config.ShardingPolicy` with the fields
    of a reference policy that the serving, training and sharding paths read; the reference's
    ``"pallas"`` kernels are the port's ``"cuda"`` ones."""
    from repro_torch.config import ShardingPolicy

    impl = {"pallas": "cuda"}.get(policy.attention_impl, policy.attention_impl)
    return ShardingPolicy(remat=policy.remat, attention_impl=impl, attn_chunk=policy.attn_chunk,
                          attn_block_skip=policy.attn_block_skip,
                          logits_fp32=policy.logits_fp32,
                          kv_cache_dtype=policy.kv_cache_dtype, moe_impl=policy.moe_impl,
                          model_axis=policy.model_axis, fsdp_params=policy.fsdp_params,
                          expert_axis=policy.expert_axis, expert_ff_axis=policy.expert_ff_axis,
                          shard_seq_attn=policy.shard_seq_attn,
                          qkv_feature_shard=policy.qkv_feature_shard,
                          prefill_last_logit_only=policy.prefill_last_logit_only,
                          sp_activations=policy.sp_activations)


# ---------------------------------------------------------- training state


def reference_key(name: str) -> tuple:
    """A port parameter name as (the reference tree's path, the layer):
    ``"blocks.3.attn.w_q"`` -> ``("blocks/attn/w_q", 3)``, ``"embed"`` ->
    ``("embed", None)``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return "/".join(["blocks", *parts[2:]]), int(parts[1])
    return "/".join(parts), None


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor on the host as NumPy (never a view of a CPU
    tensor: a snapshot); bfloat16 as its 16-bit patterns in a 2-byte void
    array, the bytes the reference's checkpoints hold for it (NumPy has no
    bfloat16 of its own)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def array_to_tensor(arr) -> torch.Tensor:
    """A NumPy array as a tensor on the host; bfloat16 (``ml_dtypes``, or the
    2-byte void patterns of a checkpoint) as torch.bfloat16."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def leaves_to_reference(named: dict) -> dict:
    """Port leaves by parameter name (a model's named parameters, or AdamW
    moments under the same names) as the reference's flat leaves by path,
    NumPy on the host, the blocks' leaves stacked ``[L, ...]`` a leaf at a
    time."""
    out: dict = {}
    layers: dict = {}
    for name, t in named.items():
        key, layer = reference_key(name)
        if layer is None:
            out[key] = tensor_to_numpy(t)
        else:
            layers.setdefault(key, {})[layer] = t
    for key, per in layers.items():
        out[key] = np.stack([tensor_to_numpy(per[l]) for l in range(len(per))])
    return out


def _nest_tree(flat: dict) -> dict:
    """Leaves by ``/``-joined path as nested dicts."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts as their leaves by ``/``-joined path (the reference
    checkpoint's keys)."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out: dict = {}
    for k, v in tree.items():
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def _field(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def train_state_to_reference(state) -> dict:
    """A port :class:`~repro_torch.runtime.TrainState` as the reference's
    ``TrainState`` tree of NumPy arrays: ``{"params": ..., "opt": {"step",
    "m", "v"}}`` with the blocks stacked (what the checkpoint writer
    stores)."""
    named = dict(state.params.named_parameters())
    return {"params": _nest_tree(leaves_to_reference(named)),
            "opt": {"step": np.asarray(int(state.opt.step), dtype=np.int32),
                    "m": _nest_tree(leaves_to_reference(state.opt.m)),
                    "v": _nest_tree(leaves_to_reference(state.opt.v))}}


def train_state_from_reference(state_np, cfg, device=None):
    """The reference's ``TrainState`` (its ``params`` and ``opt`` with
    ``step``, ``m`` and ``v``, as NumPy; a dataclass or a dict) as the port's
    :class:`~repro_torch.runtime.TrainState` on ``device``: the parameters
    through :func:`params_from_reference` (and switched to
    ``requires_grad``), each moment checked against its parameter's shape
    and kept in its own dtype (float32 or bfloat16)."""
    from repro_torch.optim import AdamWState
    from repro_torch.runtime.train import TrainState

    dev = resolve_device(device)
    model = params_from_reference(_field(state_np, "params"), cfg, dev).requires_grad_(True)
    opt = _field(state_np, "opt")
    named = dict(model.named_parameters())

    def moments(tree, what):
        flat = flatten_tree(tree)
        if set(flat) != {reference_key(n)[0] for n in named}:
            raise ValueError(f"opt.{what} has {sorted(flat)}, expected the parameters' paths")
        out = {}
        for name, p in named.items():
            key, layer = reference_key(name)
            arr = np.asarray(flat[key])
            t = array_to_tensor(arr if layer is None else arr[layer])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"opt.{what}.{key} is {tuple(t.shape)} a layer, expected "
                                 f"{tuple(p.shape)}")
            if t.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"opt.{what}.{key} is {t.dtype}; moments are float32 or bfloat16")
            out[name] = t.to(dev)
        return out

    step = torch.tensor(int(np.asarray(_field(opt, "step"))), dtype=torch.int32, device=dev)
    return TrainState(params=model, opt=AdamWState(step=step, m=moments(_field(opt, "m"), "m"),
                                                   v=moments(_field(opt, "v"), "v")))
