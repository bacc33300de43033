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
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig, ShardingPolicy
from repro_torch.convert import resolve_device
from .attention import attention, decode_attention
from .layers import Initializer, apply_rope, cross_entropy, glu_mlp, init_glu_mlp, rms_norm, rope
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
]


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
                collect_cache=False):
        """See the module function :func:`forward`."""
        return _forward(self, cfg, policy, tokens, patches, collect_cache)


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


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> Transformer:
    """A :class:`Transformer` drawn from ``seed`` on ``device`` (``None``: the
    card, raising without one; the draws are made there, never in host
    memory, and are not the reference's numbers)."""
    init = Initializer(seed, dtype=dtype, device=device)
    V, D = cfg.padded_vocab, cfg.d_model
    params: dict = {}
    if cfg.family == "audio":
        params["embed"] = init.normal((cfg.num_codebooks, V, D), scale=0.02)
        params["heads"] = init.normal((cfg.num_codebooks, D, V))
    else:
        params["embed"] = init.normal((V, D), scale=0.02)
        if not cfg.tie_embeddings:
            params["head"] = init.normal((D, V))
    if cfg.family == "vlm":
        params["patch_proj"] = init.normal((cfg.patch_dim, D))
    params["blocks"] = [_init_block(init, cfg) for _ in range(cfg.num_layers)]
    params["ln_f"] = init.ones((D,))
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


def _attn_op(p, x, cfg: ArchConfig, policy: ShardingPolicy, positions):
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p.w_q).reshape(B, S, H, hd)
    k = (x @ p.w_k).reshape(B, S, KVH, hd)
    v = (x @ p.w_v).reshape(B, S, KVH, hd)
    cos, sin = rope(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos[:, :, None], sin[:, :, None])
    k = apply_rope(k, cos[:, :, None], sin[:, :, None])
    out = attention(q, k, v, impl=policy.attention_impl, causal=True, window=_window(cfg),
                    q_chunk=policy.attn_chunk, kv_chunk=policy.attn_chunk,
                    block_skip=policy.attn_block_skip)
    return out.reshape(B, S, H * hd) @ p.w_o, (k, v)


def _ssm_impl(policy: ShardingPolicy) -> str:
    return {"naive": "reference", "chunked": "chunked", "cuda": "cuda"}[policy.attention_impl]


def _ffn(p: Block, h2, cfg: ArchConfig, policy: ShardingPolicy):
    """The block's second half: (output, MoE aux loss or None)."""
    if cfg.family == "moe":
        return moe_ffn(p.moe, h2, cfg, impl=policy.moe_impl)
    return glu_mlp(p.mlp, h2, act=cfg.act), None


def _block(p: Block, x, cfg: ArchConfig, policy: ShardingPolicy, positions):
    """One decoder block (prefill form).  Returns (x, aux or None, cache
    entries: (k, v), MLA's {"c_kv", "k_pe"}, or None)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if cfg.family == "ssm":
        return x + mamba_mixer(p.mamba, h, cfg, impl=_ssm_impl(policy)), None, None
    if cfg.mla is not None:
        attn_out, cache = mla_attention(p.attn, h, cfg, positions)
    else:
        attn_out, cache = _attn_op(p.attn, h, cfg, policy, positions)
    if cfg.family == "hybrid":
        ssm_out = mamba_mixer(p.mamba, h, cfg, impl=_ssm_impl(policy))
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    ff, aux = _ffn(p, rms_norm(x, p.ln2, cfg.norm_eps), cfg, policy)
    return x + ff, aux, cache


def _embed(model: Transformer, cfg: ArchConfig, tokens, patches=None):
    """Token embeddings [B, S, D] (audio: tokens [B, S, K], the codebooks'
    embeddings summed in order), after vlm's projected patch prefix when
    ``patches`` [B, P, patch_dim] is given."""
    if cfg.family == "audio":
        x = sum(F.embedding(tokens[..., k], model.embed[k]) for k in range(cfg.num_codebooks))
    else:
        x = F.embedding(tokens, model.embed)
    if cfg.family == "vlm" and patches is not None:
        x = torch.cat([patches.to(x.dtype) @ model.patch_proj, x], dim=1)
    return x


def _head(model: Transformer, cfg: ArchConfig, x, fp32: bool = True):
    if cfg.family == "audio":
        logits = torch.einsum("bsd,kdv->bskv", x, model.heads)
    else:
        logits = x @ (model.embed.T if cfg.tie_embeddings else model.head)
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]  # drop pad rows pre-softmax
    return logits.float() if fp32 else logits


def _stack(caches: list):
    """Per-layer cache entries stacked over layers: (k, v) or a dict."""
    if isinstance(caches[0], dict):
        return {name: torch.stack([c[name] for c in caches]) for name in caches[0]}
    return tuple(torch.stack(parts) for parts in zip(*caches))


def forward(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, tokens, patches=None,
            collect_cache=False):
    """Full-sequence forward over ``tokens`` [B, S] (audio: [B, S, K]) after
    vlm's ``patches`` [B, P, patch_dim] if given.  Returns (logits [B, S', V]
    (audio: [B, S, K, V]), aux, caches_or_None): ``aux`` is the sum of the
    MoE layers' auxiliary losses (0 without experts); ``caches`` is (k, v),
    each [L, B, S', KVH, hd], MLA's {"c_kv" [L, B, S', r], "k_pe" [L, B,
    S', dr]}, or None for a family without attention.

    When it builds a graph (grad mode on, parameters that require grad) and
    ``policy.remat == "block"``, each block runs under
    :func:`torch.utils.checkpoint.checkpoint` (recomputed in the backward
    pass), as the reference wraps it in ``jax.checkpoint``."""
    return model(cfg, policy, tokens, patches, collect_cache)


def _forward(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, tokens, patches,
             collect_cache):
    x = _embed(model, cfg, tokens, patches)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    remat = (policy.remat == "block" and torch.is_grad_enabled()
             and any(p.requires_grad for p in model.parameters()))
    for blk in model.blocks:
        if remat:
            x, a, cache = checkpoint(blk, x, cfg, policy, positions, collect_cache,
                                     use_reentrant=False)
        else:
            x, a, cache = blk(x, cfg, policy, positions, collect_cache)
        if a is not None:
            aux = aux + a
        if collect_cache and cache is not None:
            caches.append(cache)
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = _head(model, cfg, x, fp32=policy.logits_fp32)
    return logits, aux, (_stack(caches) if caches else None)


def loss_fn(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, batch: dict):
    """batch: {tokens, labels, [patches], [mask]} -> (total, {"loss",
    "aux"}): the cross-entropy of the logits against ``labels`` (audio:
    [B, S, K] labels against [B, S, K, V] logits; vlm: the text tail
    ``logits[:, num_patches:]`` only, the patch prefix has no labels), plus
    the MoE aux loss in ``total``."""
    if cfg.family == "vlm" and batch.get("patches") is None:
        raise ValueError(f"{cfg.name} trains on patch embeddings and text; the batch has no "
                         "patches")
    logits, aux, _ = forward(model, cfg, policy, batch["tokens"], batch.get("patches"))
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
               kv_dtype: str = "bf16", device=None):
    """Zeroed decode caches, stacked over layers, on ``device`` (``None``:
    the card, raising without one).  With attention: ``k``/``v``
    [L, B, S, KVH, hd] (S = min(max_len, window) for sliding-window
    attention), plus ``k_scale``/``v_scale`` [L, B, S, KVH] for int8; with
    MLA instead ``mla`` = {``c_kv`` [L, B, S, r], ``k_pe`` [L, B, S, dr]}.
    With an SSM: ``ssm`` = {``conv`` [L, B, d_conv - 1, conv_dim] in
    ``dtype``, ``state`` [L, B, H, P, N] float32}, as the reference's tree."""
    return _layer_cache(cfg, batch, max_len, dtype, kv_dtype, resolve_device(device))


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
    tokens, so ``cache_len`` counts both.  The Mamba state and conv window
    stay zero, as the reference's ``if cfg.has_ssm: pass`` leaves them
    (ROADMAP C.4)."""
    if cfg.family == "vlm" and patches is None:
        raise ValueError(f"{cfg.name} prefills a prompt of patch embeddings and text tokens; "
                         "pass patches")
    logits, _, kv = forward(model, cfg, policy, tokens, patches, collect_cache=True)
    B = tokens.shape[0]
    S = tokens.shape[1] + (cfg.num_patches if cfg.family == "vlm" else 0)
    max_len = max_len or S
    cache = init_cache(cfg, B, max_len, dtype=params_dtype(model),
                       kv_dtype=policy.kv_cache_dtype, device=logits.device)
    if kv is None:
        return logits, cache, S
    if cfg.mla is not None:
        for name, t in kv.items():
            cache["mla"][name][:, :, :S] = t
        return logits, cache, S
    k, v = kv
    n = S
    w = _window(cfg)
    if w and S >= w:
        shift = (S - w) % w
        k = torch.roll(k[:, :, S - w:], shift, dims=2)
        v = torch.roll(v[:, :, S - w:], shift, dims=2)
        n = w
    if policy.kv_cache_dtype == "int8":
        (cache["k"][:, :, :n], cache["k_scale"][:, :, :n]) = quantize_kv(k)
        (cache["v"][:, :, :n], cache["v_scale"][:, :, :n]) = quantize_kv(v)
    else:
        cache["k"][:, :, :n] = k
        cache["v"][:, :, :n] = v
    return logits, cache, S


def _len_tensor(cache_len, device):
    """``cache_len`` as a one-element int32 tensor on ``device`` (no copy
    when it already is one)."""
    if isinstance(cache_len, torch.Tensor):
        return cache_len.to(device=device, dtype=torch.int32).reshape(1)
    return torch.tensor([int(cache_len)], dtype=torch.int32, device=device)


def _decode_attn(a, h, cache: dict, n, cfg: ArchConfig, policy: ShardingPolicy):
    """The attention branch for one token: writes k/v into the cache views
    in place and returns the branch's output [B, 1, d_model]."""
    B = h.shape[0]
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (h @ a.w_q).reshape(B, 1, H, hd)
    k = (h @ a.w_k).reshape(B, 1, KVH, hd)
    v = (h @ a.w_v).reshape(B, 1, KVH, hd)
    cos, sin = rope(n.view(1, 1).expand(B, 1), hd, cfg.rope_theta)
    q = apply_rope(q, cos[:, :, None], sin[:, :, None])
    k = apply_rope(k, cos[:, :, None], sin[:, :, None])
    w = _window(cfg)
    Lc = cache["k"].shape[1]
    # the reference's dynamic_update_slice clamps its start index into range
    slot = (torch.remainder(n, Lc) if w else torch.clamp(n, max=Lc - 1)).long()
    if policy.kv_cache_dtype == "int8" and "k_scale" in cache:
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
    o = decode_attention(q, kd, vd, count, window=0, impl=policy.attention_impl)
    return o.reshape(B, 1, H * hd) @ a.w_o


def _decode_block(p: Block, x, cache: dict, n, cfg: ArchConfig, policy: ShardingPolicy):
    """One block for one token; ``cache`` holds this layer's views, written
    in place; ``n`` is the one-element int32 tensor of cached tokens."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if cfg.family == "ssm":  # residual + mixer, no ln2 / MLP
        return x + mamba_decode_step(p.mamba, h, cache["ssm"], cfg)
    if cfg.mla is not None:
        attn_out = mla_decode_step(p.attn, h, cache["mla"], n, cfg)
    else:
        attn_out = _decode_attn(p.attn, h, cache, n, cfg, policy)
    if cfg.family == "hybrid":
        ssm_out = mamba_decode_step(p.mamba, h, cache["ssm"], cfg)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
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
    x = _embed(model, cfg, tokens)
    n = _len_tensor(cache_len, x.device)
    for l, blk in enumerate(model.blocks):
        x = _decode_block(blk, x, _layer(cache, l), n, cfg, policy)
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    return _head(model, cfg, x, fp32=policy.logits_fp32), cache
