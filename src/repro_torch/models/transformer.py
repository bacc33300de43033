"""Decoder-only LM assembled from an ArchConfig: the serving path of every
family of the reference — dense (GQA attention + gated MLP, full or
sliding-window attention), moe (GQA or MLA attention + routed experts),
ssm (Mamba-2), hybrid (parallel attention + Mamba branches, Hymba), vlm
(a patch-embedding prefix, PaliGemma) and audio (parallel codebooks,
MusicGen).

The port of the reference's ``models/transformer.py``.  Weights live in a
:class:`Transformer` module whose parameter names follow the reference's
parameter tree (``embed``, ``blocks.<l>.ln1``, ``blocks.<l>.attn.w_q``,
``blocks.<l>.moe.shared.w_up`` ...); the functions mirror the reference's:

  init_params                     — a seeded :class:`Transformer`
  param_shapes                    — the same module on the meta device (no
                                    allocation, no draws: the dry run's)
  forward                         — logits for a full sequence (prefill, and
                                    the training forward)
  loss_fn                         — the training loss (cross-entropy plus the
                                    MoE aux loss)
  init_cache                      — stacked decode caches: KV [L, B, S, KVH, hd],
                                    the MLA latents and/or the Mamba conv
                                    window and state
  cache_shapes                    — the same caches on the meta device
  prefill                         — logits + populated cache
  decode_step                     — one-token serve step against the cache

On a model axis wider than 1 (every family's weights as DTensors on the
model mesh: :mod:`repro_torch.runtime.sharding`, under
:func:`~repro_torch.models.layers.activate_mesh`) every function runs as
the reference's partitioned program: the same ``constrain`` sites, the
embedding looked up vocabulary-sharded (each rank its own rows, summed;
audio a table a codebook; vlm's replicated patch prefix joined to the
reduced text), the logits vocabulary-sharded (audio each codebook's, the
reference's ``(DP, None, None, model)``; a padded vocabulary's pad columns
at -inf, the loss's logsumexp and the greedy argmax reduced over the
shards, and only a caller's logits cut, by a neighbour shift), the decode
caches split as the reference's ``cache_specs`` puts them on 'model' (KV,
sliding-window ring and MLA latents on their sequence, the Mamba conv
window on its channels and state on its heads or head dim) and decode
attention split-KV across the ranks; a hybrid block's two branches
reduced once, together; the
Mamba mixer, the experts and MLA as :mod:`~repro_torch.models.ssm`,
:mod:`~repro_torch.models.moe` and :mod:`~repro_torch.models.mla` say.
The policy's activation layouts there: ``sp_activations`` (Megatron
sequence parallelism) keeps the residual stream sequence-sharded between
sub-layers: k and v are projected on each rank's rows (the weights
gathered) and then gathered, each sub-layer that needs the whole sequence
gathers its input, and the sub-layers' partial sums reach the stream by
a reduce-scatter; ``shard_seq_attn=False`` attends on each rank's heads
(:func:`~repro_torch.models.attention.attention`);
``prefill_last_logit_only`` takes the final hidden state's last position
before the head (on a sequence-sharded stream from the rank that holds
it), so the [B, S, V] logits are never made.  The hand-written kernels
(``attention_impl="cuda"``) run there on each rank's local tensors: flash
attention on its q rows from their offset, decode attention on its cache
shard, the SSD scan on its heads or head-dim columns.  An int8 KV cache
(``kv_cache_dtype="int8"``) is quantized by each rank over its own entries
and written with its scales into the sequence-sharded values and scales,
and each rank dequantizes its shard before decode attention, as the
reference dequantizes before its decode attention; the MLA latent cache
and the Mamba cache stay in their dtypes there, as in the reference.  A
model axis not named 'model' is refused (ROADMAP A.18:
:func:`~repro_torch.runtime.sharding.check_model_axis`).

As in the reference, ``prefill`` fills the KV (or latent) cache but leaves
the Mamba state and conv window at zero (ROADMAP C.4).  A vlm prompt's
patch embeddings are given to ``forward``/``prefill`` only: the prefix is
in the cache afterwards.  ``prefill`` and ``decode_step`` run without
autograd (the decode step writes the caches in place); ``forward`` and
``loss_fn`` follow the caller's grad mode, so training differentiates
them.  A serving model's parameters do not require grad, so its forward
builds no graph either way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig, ShardingPolicy
from repro_torch.convert import resolve_device
from .attention import attention, decode_attention
from .layers import (Initializer, activate_mesh, apply_rope, constrain, cross_entropy,
                     current_mesh, glu_mlp, init_glu_mlp, local_offset, placements, replicated,
                     rms_norm, rope, write_prefix, write_slot)
from .mla import init_mla, init_mla_cache, mla_attention, mla_decode_step
from .moe import init_moe, moe_ffn
from .ssm import init_mamba, init_mamba_cache, mamba_decode_step, mamba_mixer

__all__ = [
    "Transformer",
    "init_params",
    "param_shapes",
    "cache_shapes",
    "forward",
    "loss_fn",
    "init_cache",
    "quantize_kv",
    "dequantize_kv",
    "prefill",
    "decode_step",
    "params_dtype",
    "greedy_tokens",
    "extend_cache",
]

DP = ("pod", "data")


def _param(x):
    return nn.Parameter(x, requires_grad=False)


class _Params(nn.Module):
    """A named group of weights (``attn``, ``mlp``, ``mamba``, ``moe`` and
    its ``shared`` experts)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, _Params(t) if isinstance(t, dict) else _param(t))


class Block(nn.Module):
    """One decoder block: ``ln1``, then by family ``attn`` (``w_q``, ``w_k``,
    ``w_v``, ``w_o``; with MLA ``w_q``, ``w_dkv``, ``w_kr``, ``w_uk``,
    ``w_uv``, ``w_o``), ``mamba`` (``w_z``, ``w_xbc``, ``w_dt``, ``conv_w``,
    ``A_log``, ``D``, ``dt_bias``, ``norm_w``, ``w_out``), ``ln2`` and
    ``mlp`` (``w_gate``, ``w_up``, ``w_down``) or ``moe`` (``router``,
    ``w_gate``, ``w_up``, ``w_down`` [E, ...], ``shared``)."""

    def __init__(self, p: dict):
        super().__init__()
        for name, val in p.items():
            setattr(self, name, _Params(val) if isinstance(val, dict) else _param(val))

    def forward(self, x, cfg: ArchConfig, policy: ShardingPolicy, positions,
                collect_cache=False):
        """:func:`_block`'s (x, aux, cache), the cache only when asked for."""
        x, aux, cache = _block(self, x, cfg, policy, positions)
        return x, aux, (cache if collect_cache else None)


class Transformer(nn.Module):
    """The weights of a decoder: ``embed`` ``[V, d_model]`` (audio: ``[K, V,
    d_model]``, one table a codebook), the head (``embed`` itself when
    embeddings are tied, else ``head`` ``[d_model, V]``; audio: ``heads``
    ``[K, d_model, V]``), vlm's ``patch_proj`` ``[patch_dim, d_model]``, the
    blocks, and ``ln_f``.  Matrices are ``[d_in, d_out]`` (``x @ w``), as in
    the reference.  ``params`` is the reference's tree with the blocks as a
    list (one dict per layer) instead of stacked leaves."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(params["embed"])
        if cfg.family == "audio":
            self.heads = _param(params["heads"])
        elif not cfg.tie_embeddings:
            self.head = _param(params["head"])
        if cfg.family == "vlm":
            self.patch_proj = _param(params["patch_proj"])
        self.blocks = nn.ModuleList(Block(p) for p in params["blocks"])
        self.ln_f = _param(params["ln_f"])

    def forward(self, cfg: ArchConfig, policy: ShardingPolicy, tokens, patches=None,
                collect_cache=False, last_only=False):
        """See the module function :func:`forward`."""
        return _forward(self, cfg, policy, tokens, patches, collect_cache, last_only)


def _init_attn(init: Initializer, cfg: ArchConfig):
    D, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "w_q": init.normal((D, H * hd)),
        "w_k": init.normal((D, KVH * hd)),
        "w_v": init.normal((D, KVH * hd)),
        "w_o": init.normal((H * hd, D)),
    }


def _init_block(init: Initializer, cfg: ArchConfig):
    p: dict = {"ln1": init.ones((cfg.d_model,))}
    if cfg.family == "moe":
        p["attn"] = init_mla(init, cfg) if cfg.mla else _init_attn(init, cfg)
    elif cfg.family != "ssm":
        p["attn"] = _init_attn(init, cfg)
    if cfg.family in ("ssm", "hybrid"):
        p["mamba"] = init_mamba(init, cfg)
    if cfg.family == "moe":
        p["ln2"] = init.ones((cfg.d_model,))
        p["moe"] = init_moe(init, cfg)
    elif cfg.family != "ssm":  # an ssm block is the residual mixer alone
        p["ln2"] = init.ones((cfg.d_model,))
        p["mlp"] = init_glu_mlp(init, cfg.d_model, cfg.d_ff)
    return p


def _placed(tree: dict, place, prefix: str = "") -> dict:
    """``tree``'s deferred leaves made and placed in order, one at a time."""
    return {k: (_placed(v, place, f"{prefix}{k}.") if isinstance(v, dict) else
                place(f"{prefix}{k}", v)) for k, v in tree.items()}


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None, place=None) -> Transformer:
    """A :class:`Transformer` drawn from ``seed`` on ``device`` (``None``: the
    card, raising without one; the draws are made there, never in host
    memory, and are not the reference's numbers).  ``place(name, leaf)``,
    if given, makes each leaf in turn (a
    :class:`~repro_torch.models.layers.Deferred` one, or a tensor made
    already) and returns what the model keeps of it (a rank's shard:
    :func:`repro_torch.runtime.sharding.init_sharded`, which draws only
    the rows of dim 0 its shard needs), so a model no card holds is never
    whole, nor is more than one of its leaves; the draws are the same."""
    init = Initializer(seed, dtype=dtype, device=device)
    place = place or (lambda name, leaf: leaf() if callable(leaf) else leaf)
    V, D = cfg.padded_vocab, cfg.d_model
    top: dict = {}
    if cfg.family == "audio":
        top["embed"] = init.normal((cfg.num_codebooks, V, D), scale=0.02)
        top["heads"] = init.normal((cfg.num_codebooks, D, V))
    else:
        top["embed"] = init.normal((V, D), scale=0.02)
        if not cfg.tie_embeddings:
            top["head"] = init.normal((D, V))
    if cfg.family == "vlm":
        top["patch_proj"] = init.normal((cfg.patch_dim, D))
    params = _placed(top, place)
    params["blocks"] = [_placed(_init_block(init, cfg), place, f"blocks.{l}.")
                        for l in range(cfg.num_layers)]
    params["ln_f"] = place("ln_f", init.ones((D,)))
    return Transformer(cfg, params)


def param_shapes(cfg: ArchConfig, policy: ShardingPolicy | None = None,
                 dtype=torch.bfloat16) -> Transformer:
    """:func:`init_params`'s module on the meta device: every leaf's shape
    and dtype (the Mamba mixer's ``A_log``, ``D`` and ``dt_bias`` float32,
    as the reference keeps them), nothing allocated and nothing drawn.
    ``policy`` is the reference's argument; no shape depends on it."""
    from repro_torch.convert import _FLOAT32_LEAVES, _block_layout, _top_layout

    def build(layout, path=""):
        return {name: (build(spec, f"{path}{name}.") if isinstance(spec, dict) else
                       torch.empty(spec, device="meta",
                                   dtype=torch.float32 if f"{path}{name}" in _FLOAT32_LEAVES
                                   else dtype))
                for name, spec in layout.items()}

    params = build(_top_layout(cfg))
    params["blocks"] = [build(_block_layout(cfg)) for _ in range(cfg.num_layers)]
    return Transformer(cfg, params)


def params_dtype(model: Transformer):
    return model.embed.dtype


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _window(cfg: ArchConfig) -> int:
    return cfg.window if cfg.attn_type == "swa" else 0


def _rope_tables(positions, like, cfg: ArchConfig):
    """RoPE's cos/sin [B, S, 1, hd/2], replicated beside a DTensor ``like``."""
    cos, sin = rope(positions, cfg.head_dim, cfg.rope_theta)
    return replicated(cos[:, :, None], like), replicated(sin[:, :, None], like)


def _out_proj(o, w_o):
    """``o @ w_o``.  On a model axis ``o`` goes feature-sharded first (an
    all-to-all from sequence-sharded, a free split from replicated), so
    the product with the row-sharded ``w_o`` is a partial sum over the
    ranks and no weight moves."""
    if isinstance(o, DTensor):
        o = o.redistribute(placements=[Shard(o.ndim - 1)])
    return o @ w_o


def _heads(t, n: int, hd: int):
    """``t`` [B, S, n * hd] as [B, S, n, hd].  A feature-sharded DTensor
    whose ``n`` heads do not split evenly over the model axis (8 KV heads
    over 16 ranks) is replicated first: DTensor cannot cut a head."""
    if isinstance(t, DTensor) and n % t.device_mesh.size() and t.placements[0].is_shard(2):
        t = t.redistribute(placements=[Replicate()])
    return t.reshape(*t.shape[:2], n, hd)


def _rows(x, w):
    """``x @ w`` for a sequence-sharded DTensor ``x`` [B, S, D]: each rank
    its own rows against ``w`` gathered whole (``w``'s gradient a partial
    sum over the ranks, reduce-scattered back), sequence-sharded too."""
    w_all = w.redistribute(placements=[Replicate()]).to_local(grad_placements=[Partial()])
    out = x.to_local() @ w_all
    shape = (*x.shape[:2], w.shape[-1])
    return DTensor.from_local(out, x.device_mesh, x.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _sp(x) -> bool:
    """Whether ``x`` is a sequence-sharded DTensor (``sp_activations``)."""
    return isinstance(x, DTensor) and x.placements[0].is_shard(1)


def _attn_op(p, x, cfg: ArchConfig, policy: ShardingPolicy, positions):
    """The attention branch: (output, (k, v)).  On a model axis the output
    is a partial sum over the ranks (the block reduces it).  On a
    sequence-sharded ``x`` (``sp_activations``) k and v are projected on
    each rank's rows and gathered by the attention, as the reference's
    constraints put them (the GQA-small k and v move, not the hidden
    state); q is projected feature-sharded from the gathered rows under
    ``qkv_feature_shard``, else on each rank's rows too: sequence-sharded,
    the layout the sequence-sharded attention reads, so q never moves and
    only ``w_q`` is gathered."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if _sp(x):
        k = _heads(_rows(x, p.w_k), KVH, hd)
        v = _heads(_rows(x, p.w_v), KVH, hd)
        q = (constrain(x, DP, None, None) @ p.w_q if policy.qkv_feature_shard else
             _rows(x, p.w_q))
        q = _heads(q, H, hd)
    else:
        q = _heads(x @ p.w_q, H, hd)
        k = _heads(x @ p.w_k, KVH, hd)
        v = _heads(x @ p.w_v, KVH, hd)
    if policy.qkv_feature_shard:
        q = constrain(q, DP, None, policy.model_axis, None)
    cos, sin = _rope_tables(positions, q, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = attention(q, k, v, impl=policy.attention_impl, causal=True, window=_window(cfg),
                    q_chunk=policy.attn_chunk, kv_chunk=policy.attn_chunk,
                    block_skip=policy.attn_block_skip, model_axis=policy.model_axis,
                    shard_seq=policy.shard_seq_attn)
    return _out_proj(out.reshape(B, S, H * hd), p.w_o), (k, v)


def _res_spec(policy: ShardingPolicy, seq_len: int):
    """The residual stream's spec: batch over the data axes, and under
    ``sp_activations`` the sequence over the model axis (a decode step's
    one position never)."""
    if policy.sp_activations and seq_len > 1:
        return (DP, policy.model_axis, None)
    return (DP, None, None)


def _ssm_impl(policy: ShardingPolicy) -> str:
    return {"naive": "reference", "chunked": "chunked", "cuda": "cuda"}[policy.attention_impl]


def _ffn(p: Block, h2, cfg: ArchConfig, policy: ShardingPolicy):
    """The block's second half: (output, MoE aux loss or None)."""
    if cfg.family == "moe":
        return moe_ffn(p.moe, h2, cfg, impl=policy.moe_impl, expert_axis=policy.expert_axis,
                       ff_axis=policy.expert_ff_axis, out_spec=_res_spec(policy, h2.shape[1]))
    return glu_mlp(p.mlp, h2, act=cfg.act, model_axis=policy.model_axis,
                   out_spec=_res_spec(policy, h2.shape[1])), None


def _block(p: Block, x, cfg: ArchConfig, policy: ShardingPolicy, positions):
    """One decoder block (prefill form).  Returns (x, aux or None, cache
    entries: (k, v), MLA's {"c_kv", "k_pe"}, or None)."""
    res = _res_spec(policy, x.shape[1])
    x = constrain(x, *res)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if cfg.family == "ssm":
        out = mamba_mixer(p.mamba, h, cfg, impl=_ssm_impl(policy))
        return x + constrain(out, *res), None, None
    if cfg.mla is not None:
        attn_out, cache = mla_attention(p.attn, h, cfg, positions, model_axis=policy.model_axis,
                                        out_spec=res)
    else:
        attn_out, cache = _attn_op(p.attn, h, cfg, policy, positions)
    if cfg.family == "hybrid":  # both branches partial sums on a model axis: one reduction
        attn_out = 0.5 * (attn_out + mamba_mixer(p.mamba, h, cfg, impl=_ssm_impl(policy)))
    x = x + constrain(attn_out, *res)
    ff, aux = _ffn(p, rms_norm(x, p.ln2, cfg.norm_eps), cfg, policy)
    return x + ff, aux, cache


def _embed(model: Transformer, cfg: ArchConfig, tokens, patches=None):
    """Token embeddings [B, S, D] (audio: tokens [B, S, K], the codebooks'
    embeddings summed in order), after vlm's projected patch prefix when
    ``patches`` [B, P, patch_dim] is given.  On a model axis each lookup is
    vocabulary-sharded (a partial sum, :func:`_lookup`); the patch prefix,
    from the replicated ``patch_proj``, joins the text once it is reduced."""
    if cfg.family == "audio":
        x = _lookup(model.embed[0], tokens[..., 0])
        for k in range(1, cfg.num_codebooks):
            x = x + _lookup(model.embed[k], tokens[..., k])
    else:
        x = _lookup(model.embed, tokens)
    if cfg.family == "vlm" and patches is not None:
        proj = model.patch_proj
        if isinstance(x, DTensor):
            x = x.redistribute(placements=[Replicate()])
        x = torch.cat([replicated(patches.to(x.dtype), proj) @ proj, x], dim=1)
    return x


def _lookup(table, tokens):
    """``table[tokens]``.  A vocabulary-sharded table (a DTensor sharded on
    its rows): each rank looks up the tokens among its rows, zero for the
    rest, and the lookups are a partial sum over the model axis."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    if tuple(table.placements) != (Shard(0),):
        return F.embedding(replicated(tokens, table), table)
    local = table.to_local()
    idx = tokens - local_offset(table, 0)
    mine = (idx >= 0) & (idx < local.shape[0])
    out = F.embedding(torch.where(mine, idx, 0), local) * mine[..., None].to(local.dtype)
    return DTensor.from_local(out, table.device_mesh, [Partial()], run_check=False)


def _head(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, x, fp32: bool = True):
    """The logits [B, S, V] (audio: [B, S, K, V], a head a codebook),
    vocabulary-sharded on a model axis.  Where the table has pad rows the
    logits are cut to the vocabulary before the softmax; on a model axis
    they keep their padded shards, the pad columns at -inf in the rank
    that holds them (out of the softmax and the argmax alike), and only
    the logits a caller gets back are cut (:func:`_vocab_cut`)."""
    if cfg.family == "audio" and isinstance(model.heads, DTensor):
        # each rank its vocabulary columns of every codebook's head, from the
        # replicated x (whose gradient is then a partial sum over the ranks)
        local = torch.einsum("bsd,kdv->bskv", x.to_local(grad_placements=[Partial()]),
                             model.heads.to_local())
        shape = (*x.shape[:2], *model.heads.shape[::2])
        logits = DTensor.from_local(local, x.device_mesh, [Shard(3)], run_check=False,
                                    shape=shape, stride=torch.empty(shape, device="meta").stride())
        logits = constrain(logits, DP, None, None, policy.model_axis)
    elif cfg.family == "audio":
        logits = torch.einsum("bsd,kdv->bskv", x, model.heads)
    else:
        logits = x @ (model.embed.T if cfg.tie_embeddings else model.head)
        logits = constrain(logits, DP, None, policy.model_axis)
    if cfg.padded_vocab != cfg.vocab_size:
        if isinstance(logits, DTensor):
            local = logits.to_local()
            col = local_offset(logits, logits.ndim - 1) + torch.arange(local.shape[-1],
                                                                       device=local.device)
            logits = DTensor.from_local(local.masked_fill(col >= cfg.vocab_size, float("-inf")),
                                        logits.device_mesh, logits.placements, run_check=False,
                                        shape=logits.shape, stride=logits.stride())
        else:
            logits = logits[..., : cfg.vocab_size]  # drop pad rows pre-softmax
    return logits.float() if fp32 else logits


def _vocab_cut(logits, vocab: int):
    """``logits[..., :vocab]`` for a caller.  Vocabulary-sharded logits with
    pad columns (:func:`_head`): the cut's shards (DTensor's split of
    ``vocab`` over the ranks) start no later than the padded ones, so a
    column only moves to the same or a later rank.  Each rank keeps its
    first columns and sends the rest to the ranks the cut puts them on, one
    all-to-all of a few columns a rank (the neighbour shift), and no rank
    gathers the logits whole."""
    if not isinstance(logits, DTensor) or logits.shape[-1] == vocab:
        return logits
    from torch.distributed._functional_collectives import (all_to_all_single_autograd,
                                                           wait_tensor)

    mesh, padded = logits.device_mesh, logits.shape[-1]
    ranks, r = mesh.size(), mesh.get_local_rank()

    def span(n, i):  # rank i's columns [start, end) of n split over the ranks
        size = -(-n // ranks)
        return min(i * size, n), min((i + 1) * size, n)

    def overlap(a, b):
        return max(0, min(a[1], b[1], vocab) - max(a[0], b[0]))

    mine, cut = span(padded, r), span(vocab, r)
    send = [0 if i == r else overlap(mine, span(vocab, i)) for i in range(ranks)]
    recv = [0 if i == r else overlap(span(padded, i), cut) for i in range(ranks)]
    local, keep = logits.to_local(), overlap(mine, cut)
    cols = local[..., keep:keep + sum(send)].movedim(-1, 0).contiguous()
    moved = wait_tensor(all_to_all_single_autograd(cols, recv, send, mesh.get_group()))
    shape = (*logits.shape[:-1], vocab)
    return DTensor.from_local(torch.cat([moved.movedim(0, -1), local[..., :keep]], dim=-1), mesh,
                              logits.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _stack(caches: list):
    """Per-layer cache entries stacked over layers: (k, v) or a dict."""
    if isinstance(caches[0], dict):
        return {name: torch.stack([c[name] for c in caches]) for name in caches[0]}
    return tuple(torch.stack(parts) for parts in zip(*caches))


def forward(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, tokens, patches=None,
            collect_cache=False, last_only=False):
    """Full-sequence forward over ``tokens`` [B, S] (audio: [B, S, K]) after
    vlm's ``patches`` [B, P, patch_dim] if given.  Returns (logits [B, S', V]
    (audio: [B, S, K, V]), aux, caches_or_None): ``aux`` is the sum of the
    MoE layers' auxiliary losses (0 without experts); ``caches`` is (k, v),
    each [L, B, S', KVH, hd], MLA's {"c_kv" [L, B, S', r], "k_pe" [L, B,
    S', dr]}, or None for a family without attention.  ``last_only``: the
    last position's logits alone ([B, 1, V]; audio [B, 1, K, V]), the final
    hidden state cut before the head.

    When it builds a graph (grad mode on, parameters that require grad) and
    ``policy.remat == "block"``, each block runs under
    :func:`torch.utils.checkpoint.checkpoint` (recomputed in the backward
    pass), as the reference wraps it in ``jax.checkpoint``."""
    logits, aux, caches = model(cfg, policy, tokens, patches, collect_cache, last_only)
    return _vocab_cut(logits, cfg.vocab_size), aux, caches


def _last(x):
    """``x[:, -1:]``.  A sequence-sharded DTensor: the rank whose rows hold
    the last position gives its row, the others zeros, summed over the
    model axis (an all-reduce of [B, 1, D]; the sequence is never gathered)."""
    if not _sp(x):
        return x[:, -1:]
    local, start = x.to_local(), local_offset(x, 1)
    B, S, D = x.shape
    row = local[:, -1:] if start < S <= start + local.shape[1] else local.new_zeros(B, 1, D)
    row = DTensor.from_local(row, x.device_mesh, [Partial()], run_check=False,
                             shape=(B, 1, D), stride=(D, D, 1))
    return row.redistribute(placements=[Replicate()])


def _forward(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, tokens, patches,
             collect_cache, last_only=False):
    x = _embed(model, cfg, tokens, patches)
    B, S, _ = x.shape
    x = constrain(x, *_res_spec(policy, S))
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux = None
    caches = []
    remat = (policy.remat == "block" and torch.is_grad_enabled()
             and any(p.requires_grad for p in model.parameters()))
    mesh = current_mesh()
    for blk in model.blocks:
        if remat:
            x, a, cache = checkpoint(blk if mesh is None else _under(mesh, blk), x, cfg, policy,
                                     positions, collect_cache, use_reentrant=False)
        else:
            x, a, cache = blk(x, cfg, policy, positions, collect_cache)
        if a is not None:
            aux = a if aux is None else aux + a
        if collect_cache and cache is not None:
            caches.append(cache)
    # the head reads whole rows: a sequence-sharded stream is gathered (or,
    # for the last position alone, that row taken from its rank)
    x = _last(x) if last_only else constrain(x, DP, None, None)
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = _head(model, cfg, policy, x, fp32=policy.logits_fp32)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, (_stack(caches) if caches else None)


def _under(mesh, fn):
    """``fn`` run under ``mesh``: a checkpointed block is recomputed in the
    backward pass, which autograd runs on a thread of its own for a card,
    and the active mesh is a thread's."""
    def run(*args):
        with activate_mesh(mesh):
            return fn(*args)

    return run


def loss_fn(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, batch: dict):
    """batch: {tokens, labels, [patches], [mask]} -> (total, {"loss",
    "aux"}): the cross-entropy of the logits against ``labels`` (audio:
    [B, S, K] labels against [B, S, K, V] logits; vlm: the text tail
    ``logits[:, num_patches:]`` only, the patch prefix has no labels), plus
    the MoE aux loss in ``total``."""
    if cfg.family == "vlm" and batch.get("patches") is None:
        raise ValueError(f"{cfg.name} trains on patch embeddings and text; the batch has no "
                         "patches")
    # the logits as the head leaves them: on a model axis with pad columns at -inf
    logits, aux, _ = model(cfg, policy, batch["tokens"], batch.get("patches"))
    if cfg.family == "vlm":
        logits = logits[:, cfg.num_patches:]
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + aux, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _layer_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, kv_dtype: str, device):
    c: dict = {}
    if cfg.has_attention and cfg.mla is not None:
        c["mla"] = init_mla_cache(cfg, cfg.num_layers, batch, max_len, dtype, device)
    elif cfg.has_attention:
        w = _window(cfg)
        L = min(max_len, w) if w else max_len
        kvd = torch.int8 if kv_dtype == "int8" else dtype
        shape = (cfg.num_layers, batch, L, cfg.num_kv_heads, cfg.head_dim)
        c["k"] = torch.zeros(shape, dtype=kvd, device=device)
        c["v"] = torch.zeros(shape, dtype=kvd, device=device)
        if kv_dtype == "int8":
            # per-(token, kv-head) scales — absmax/127 linear quantization
            c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
            c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    if cfg.has_ssm:
        c["ssm"] = init_mamba_cache(cfg, cfg.num_layers, batch, dtype, device)
    return c


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               kv_dtype: str = "bf16", device=None, mesh=None):
    """Zeroed decode caches, stacked over layers, on ``device`` (``None``:
    the card, raising without one).  With attention: ``k``/``v``
    [L, B, S, KVH, hd] (S = min(max_len, window) for sliding-window
    attention), plus ``k_scale``/``v_scale`` [L, B, S, KVH] for int8; with
    MLA instead ``mla`` = {``c_kv`` [L, B, S, r], ``k_pe`` [L, B, S, dr]}.
    With an SSM: ``ssm`` = {``conv`` [L, B, d_conv - 1, conv_dim] in
    ``dtype``, ``state`` [L, B, H, P, N] float32}, as the reference's tree.

    ``mesh``: a model mesh (:func:`~repro_torch.models.layers.model_mesh`);
    every leaf is then a DTensor sharded over it as the reference's
    ``cache_specs`` puts it on 'model' (the KV and latent caches on their
    sequence dim, the conv window on its channels, the state on its heads
    or, where the axis does not divide them, on its head dim), each rank
    allocating its own shard only (on ``"meta"`` too: the dry run's)."""
    if mesh is None:
        return _layer_cache(cfg, batch, max_len, dtype, kv_dtype, resolve_device(device))
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.runtime.sharding import cache_specs

    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    specs = cache_specs(cfg, ShardingPolicy(kv_cache_dtype=kv_dtype), model_divisor=mesh.size())

    def sharded(t, spec):
        pl = placements(mesh, spec)
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return DTensor.from_local(torch.zeros(local, dtype=t.dtype, device=dev), mesh, pl,
                                  run_check=False, shape=t.shape, stride=t.stride())

    return _tree_map(sharded, cache_shapes(cfg, batch, max_len, dtype, kv_dtype), specs)


def _tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` on the leaves of ``tree`` (and the same leaves of ``rest``)."""
    return {k: (_tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict) else
                fn(v, *(r[k] for r in rest))) for k, v in tree.items()}


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                 kv_dtype: str = "bf16") -> dict:
    """:func:`init_cache`'s tree on the meta device (no allocation)."""
    return _layer_cache(cfg, batch, max_len, dtype, kv_dtype, torch.device("meta"))


def quantize_kv(x):
    """x [..., hd] -> (int8 values, f32 scale over the hd axis)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# serve: prefill + decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, tokens, patches=None,
            max_len=None):
    """Run the prompt, build the decode cache.  Returns (logits, cache,
    cache_len); for vlm the prompt is the ``patches`` prefix and the text
    tokens, so ``cache_len`` counts both.  Under the policy's
    ``prefill_last_logit_only`` the logits are the last position's alone
    ([B, 1, V]; audio [B, 1, K, V]; vlm's last text token), the reference's
    serving cell's ``logits[:, -1:]``, made without the others.  The Mamba state and conv window
    stay zero, as the reference's ``if cfg.has_ssm: pass`` leaves them
    (ROADMAP C.4)."""
    if cfg.family == "vlm" and patches is None:
        raise ValueError(f"{cfg.name} prefills a prompt of patch embeddings and text tokens; "
                         "pass patches")
    logits, _, kv = forward(model, cfg, policy, tokens, patches, collect_cache=True,
                            last_only=policy.prefill_last_logit_only)
    B = tokens.shape[0]
    S = tokens.shape[1] + (cfg.num_patches if cfg.family == "vlm" else 0)
    max_len = max_len or S
    cache = init_cache(cfg, B, max_len, dtype=params_dtype(model),
                       kv_dtype=policy.kv_cache_dtype, device=logits.device,
                       mesh=logits.device_mesh if isinstance(logits, DTensor) else None)
    if kv is None:
        return logits, cache, S
    if cfg.mla is not None:
        for name, t in kv.items():
            if isinstance(t, DTensor):
                write_prefix(cache["mla"][name], t)
            else:
                cache["mla"][name][:, :, :S] = t
        return logits, cache, S
    k, v = kv
    sharded = isinstance(cache["k"], DTensor)
    if sharded:  # whole on every rank; each writes the entries of its range
        k, v = (t.redistribute(placements=[Replicate()]).to_local() for t in (k, v))
    n = S
    w = _window(cfg)
    if w and S >= w:  # the ring of the last w entries, entry i at slot i mod w
        shift = (S - w) % w
        k = torch.roll(k[:, :, S - w:], shift, dims=2)
        v = torch.roll(v[:, :, S - w:], shift, dims=2)
        n = w
    if sharded and "k_scale" in cache:
        _write_int8_prefix(cache, "k", k)
        _write_int8_prefix(cache, "v", v)
    elif sharded:
        write_prefix(cache["k"], k)
        write_prefix(cache["v"], v)
    elif policy.kv_cache_dtype == "int8":
        (cache["k"][:, :, :n], cache["k_scale"][:, :, :n]) = quantize_kv(k)
        (cache["v"][:, :, :n], cache["v_scale"][:, :, :n]) = quantize_kv(v)
    else:
        cache["k"][:, :, :n] = k
        cache["v"][:, :, :n] = v
    return logits, cache, S


def _write_int8_prefix(cache: dict, name: str, t) -> None:
    """``t`` [L, B, n, KVH, hd] (whole on every rank) into the
    sequence-sharded int8 cache ``cache[name]`` and its scales: each rank
    quantizes the entries of its own range only (a scale is per token and
    kv head, over the head dim, which no rank splits)."""
    start = local_offset(cache[name], 2)
    values, scales = quantize_kv(t[:, :, start:start + cache[name].to_local().shape[2]])
    write_prefix(cache[name], values, start)
    write_prefix(cache[name + "_scale"], scales, start)


def _dequantized(values, scales, dtype):
    """A sequence-sharded int8 cache layer's values times its scales in
    ``dtype``: each rank its own shard, a DTensor placed as ``values``."""
    local = dequantize_kv(values.to_local(), scales.to_local(), dtype)
    return DTensor.from_local(local, values.device_mesh, values.placements, run_check=False,
                              shape=values.shape, stride=values.stride())


@torch.no_grad()
def extend_cache(cfg: ArchConfig, cache: dict, max_len: int) -> dict:
    """A cache of ``max_len`` entries holding ``cache``'s KV or latent
    entries in its first ones and its Mamba conv window and state as they
    are (a prefill cache given room for the decode steps), sharded as
    ``cache`` is.  int8 KV caches are not extended."""
    if set(cache) - {"k", "v", "mla", "ssm"}:
        raise ValueError(f"{cfg.name}: extend_cache takes a KV, latent or Mamba cache")
    first = cache["ssm"]["conv"] if "ssm" in cache else (
        cache["k"] if "k" in cache else cache["mla"]["c_kv"])
    out = init_cache(cfg, first.shape[1], max_len, dtype=first.dtype, device=first.device,
                     mesh=first.device_mesh if isinstance(first, DTensor) else None)

    def copy(dst, src):
        for name, old in src.items():
            if name == "ssm":  # no sequence: the window and state as they are
                for leaf, t in old.items():
                    dst[name][leaf].copy_(t)
            elif isinstance(old, dict):
                copy(dst[name], old)
            elif isinstance(old, DTensor):
                write_prefix(dst[name], old)
            else:
                dst[name][:, :, :old.shape[2]] = old

    copy(out, cache)
    return out


def _len_tensor(cache_len, device):
    """``cache_len`` as a one-element int32 tensor on ``device`` (no copy
    when it already is one)."""
    if isinstance(cache_len, torch.Tensor):
        return cache_len.to(device=device, dtype=torch.int32).reshape(1)
    return torch.tensor([int(cache_len)], dtype=torch.int32, device=device)


def _decode_attn(a, h, cache: dict, n, cfg: ArchConfig, policy: ShardingPolicy):
    """The attention branch for one token: writes k/v into the cache views
    in place and returns the branch's output [B, 1, d_model] (a partial
    sum over a model axis: the block reduces it)."""
    B = h.shape[0]
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _heads(h @ a.w_q, H, hd)
    k = _heads(h @ a.w_k, KVH, hd)
    v = _heads(h @ a.w_v, KVH, hd)
    cos, sin = _rope_tables(n.view(1, 1).expand(B, 1), q, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    w = _window(cfg)
    Lc = cache["k"].shape[1]
    # the reference's dynamic_update_slice clamps its start index into range
    slot = (torch.remainder(n, Lc) if w else torch.clamp(n, max=Lc - 1)).long()
    int8 = policy.kv_cache_dtype == "int8" and "k_scale" in cache
    if isinstance(cache["k"], DTensor) and int8:  # each rank quantizes the one new entry
        for name, t in (("k", k), ("v", v)):
            values, scales = quantize_kv(t.redistribute(placements=[Replicate()]).to_local())
            write_slot(cache[name], slot, values)
            write_slot(cache[name + "_scale"], slot, scales)
        kd = _dequantized(cache["k"], cache["k_scale"], h.dtype)
        vd = _dequantized(cache["v"], cache["v_scale"], h.dtype)
    elif isinstance(cache["k"], DTensor):
        write_slot(cache["k"], slot, k)
        write_slot(cache["v"], slot, v)
        kd, vd = cache["k"], cache["v"]
    elif int8:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache["k"].index_copy_(1, slot, kq)
        cache["v"].index_copy_(1, slot, vq)
        cache["k_scale"].index_copy_(1, slot, ks)
        cache["v_scale"].index_copy_(1, slot, vs)
        kd = dequantize_kv(cache["k"], cache["k_scale"], h.dtype)
        vd = dequantize_kv(cache["v"], cache["v_scale"], h.dtype)
    else:
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        kd, vd = cache["k"], cache["v"]
    # ring buffer: all written slots are attendable (min(len+1, W))
    count = torch.clamp(n + 1, max=Lc) if w else n + 1
    o = decode_attention(q, kd, vd, count, window=0, impl=policy.attention_impl,
                         model_axis=policy.model_axis, shard_seq=policy.shard_seq_attn)
    return _out_proj(o.reshape(B, 1, H * hd), a.w_o)


def _decode_block(p: Block, x, cache: dict, n, cfg: ArchConfig, policy: ShardingPolicy):
    """One block for one token; ``cache`` holds this layer's views, written
    in place; ``n`` is the one-element int32 tensor of cached tokens."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if cfg.family == "ssm":  # residual + mixer, no ln2 / MLP
        return x + constrain(mamba_decode_step(p.mamba, h, cache["ssm"], cfg), DP, None, None)
    if cfg.mla is not None:
        out = mla_decode_step(p.attn, h, cache["mla"], n, cfg, model_axis=policy.model_axis)
    else:
        out = _decode_attn(p.attn, h, cache, n, cfg, policy)
    if cfg.family == "hybrid":  # both branches partial sums on a model axis: one reduction
        out = 0.5 * (out + mamba_decode_step(p.mamba, h, cache["ssm"], cfg))
    x = x + constrain(out, DP, None, None)
    return x + _ffn(p, rms_norm(x, p.ln2, cfg.norm_eps), cfg, policy)[0]


def _layer(cache: dict, l: int) -> dict:
    """Layer ``l``'s views of the stacked cache (nested groups included)."""
    return {name: (_layer(t, l) if isinstance(t, dict) else t[l]) for name, t in cache.items()}


@torch.no_grad()
def decode_step(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, cache, tokens,
                cache_len):
    """One serve step: tokens [B, 1] (audio: [B, 1, K]) -> (logits, cache).

    ``cache_len`` is the number of tokens already in the cache: an int, or a
    one-element int32 tensor on the model's device, which keeps the loop
    free of host round trips.  The cache is updated **in place** and
    returned (the reference donates it to the step and returns a new one).
    """
    x = constrain(_embed(model, cfg, tokens), DP, None, None)
    n = _len_tensor(cache_len, x.device)
    for l, blk in enumerate(model.blocks):
        x = _decode_block(blk, x, _layer(cache, l), n, cfg, policy)
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = _head(model, cfg, policy, x, fp32=policy.logits_fp32)
    return _vocab_cut(logits, cfg.vocab_size), cache


@torch.no_grad()
def greedy_tokens(logits):
    """The argmax over the last dim of ``logits`` [..., V] as int32 (the
    first of equal maxima, as ``argmax``).  Vocabulary-sharded DTensor
    logits: each rank's best column and value, all-gathered over the model
    axis, the best of them; a plain tensor."""
    if not isinstance(logits, DTensor):
        return logits.argmax(dim=-1).to(torch.int32)
    if tuple(logits.placements) != (Shard(logits.ndim - 1),):
        return logits.full_tensor().argmax(dim=-1).to(torch.int32)
    local = logits.to_local()
    idx = local.argmax(dim=-1)
    best = torch.gather(local, -1, idx[..., None])[..., 0].float()
    pair = torch.stack([best, (idx + local_offset(logits, logits.ndim - 1)).float()])
    pairs = DTensor.from_local(pair[None], logits.device_mesh, [Shard(0)],
                               run_check=False).full_tensor()  # [ranks, 2, ...]
    win = pairs[:, 0].argmax(dim=0, keepdim=True)  # the first rank holding the max
    return torch.gather(pairs[:, 1], 0, win)[0].to(torch.int32)
