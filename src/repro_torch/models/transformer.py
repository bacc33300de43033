"""Decoder-only LM assembled from an ArchConfig: the serving path of the
dense (GQA attention + gated MLP, full or sliding-window attention), ssm
(Mamba-2) and hybrid (parallel attention + Mamba branches, Hymba) families.

The port of the reference's ``models/transformer.py`` for those three
families.  Weights live in a :class:`Transformer` module whose parameter
names follow the reference's parameter tree (``embed``, ``blocks.<l>.ln1``,
``blocks.<l>.attn.w_q``, ``blocks.<l>.mamba.w_xbc`` ...); the functions
mirror the reference's:

  init_params                     — a seeded :class:`Transformer`
  forward                         — logits for a full sequence (prefill)
  init_cache                      — stacked decode caches: KV [L, B, S, KVH, hd]
                                    and/or the Mamba conv window and state
  prefill                         — logits + populated cache
  decode_step                     — one-token serve step against the cache

As in the reference, ``prefill`` fills the KV cache but leaves the Mamba
state and conv window at zero (ROADMAP C.4).  The other families (moe/MLA,
vlm, audio) raise :class:`NotImplementedError` naming the roadmap item that
ports them.  Everything runs without autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig, ShardingPolicy
from repro_torch.convert import resolve_device
from .attention import attention, decode_attention
from .layers import Initializer, apply_rope, glu_mlp, init_glu_mlp, rms_norm, rope
from .ssm import init_mamba, init_mamba_cache, mamba_decode_step, mamba_mixer

__all__ = [
    "Transformer",
    "init_params",
    "forward",
    "init_cache",
    "quantize_kv",
    "dequantize_kv",
    "prefill",
    "decode_step",
    "params_dtype",
]

_PORTED = ("dense", "ssm", "hybrid")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in _PORTED or cfg.mla is not None:
        raise NotImplementedError(
            f"the port serves the dense, ssm and hybrid families; {cfg.name} ({cfg.family}) "
            "comes with ROADMAP A.13 (the moe/MLA, vlm and audio families)")


def _param(x):
    return nn.Parameter(x, requires_grad=False)


class _Params(nn.Module):
    """A named group of weights (``attn``, ``mlp`` or ``mamba``)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, _param(t))


class Block(nn.Module):
    """One decoder block: ``ln1``, then by family ``attn`` (``w_q``, ``w_k``,
    ``w_v``, ``w_o``), ``mamba`` (``w_z``, ``w_xbc``, ``w_dt``, ``conv_w``,
    ``A_log``, ``D``, ``dt_bias``, ``norm_w``, ``w_out``), ``ln2`` and
    ``mlp`` (``w_gate``, ``w_up``, ``w_down``)."""

    def __init__(self, p: dict):
        super().__init__()
        for name, val in p.items():
            setattr(self, name, _Params(val) if isinstance(val, dict) else _param(val))


class Transformer(nn.Module):
    """The weights of a decoder: ``embed`` ``[V, d_model]`` (also the
    head when embeddings are tied, else ``head`` ``[d_model, V]``), the
    blocks, and ``ln_f``.  Matrices are ``[d_in, d_out]`` (``x @ w``), as in
    the reference.  ``params`` is the reference's tree with the blocks as a
    list (one dict per layer) instead of stacked leaves."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        self.embed = _param(params["embed"])
        if not cfg.tie_embeddings:
            self.head = _param(params["head"])
        self.blocks = nn.ModuleList(Block(p) for p in params["blocks"])
        self.ln_f = _param(params["ln_f"])


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
    if cfg.family in ("dense", "hybrid"):
        p["attn"] = _init_attn(init, cfg)
    if cfg.family in ("ssm", "hybrid"):
        p["mamba"] = init_mamba(init, cfg)
    if cfg.family != "ssm":  # an ssm block is the residual mixer alone
        p["ln2"] = init.ones((cfg.d_model,))
        p["mlp"] = init_glu_mlp(init, cfg.d_model, cfg.d_ff)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> Transformer:
    """A :class:`Transformer` drawn from ``seed`` on ``device`` (``None``: the
    card, raising without one; the draws are made there and are not the
    reference's numbers)."""
    _require_ported(cfg)
    init = Initializer(seed, dtype=dtype, device=device)
    params: dict = {"embed": init.normal((cfg.padded_vocab, cfg.d_model), scale=0.02)}
    if not cfg.tie_embeddings:
        params["head"] = init.normal((cfg.d_model, cfg.padded_vocab))
    params["blocks"] = [_init_block(init, cfg) for _ in range(cfg.num_layers)]
    params["ln_f"] = init.ones((cfg.d_model,))
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


def _block(p: Block, x, cfg: ArchConfig, policy: ShardingPolicy, positions):
    """One decoder block (prefill form).  Returns (x, cache_kv or None)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if cfg.family == "ssm":
        return x + mamba_mixer(p.mamba, h, cfg, impl=_ssm_impl(policy)), None
    attn_out, kv = _attn_op(p.attn, h, cfg, policy, positions)
    if cfg.family == "hybrid":
        ssm_out = mamba_mixer(p.mamba, h, cfg, impl=_ssm_impl(policy))
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + glu_mlp(p.mlp, h2, act=cfg.act), kv


def _head(model: Transformer, cfg: ArchConfig, x, fp32: bool = True):
    logits = x @ (model.embed.T if cfg.tie_embeddings else model.head)
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]  # drop pad rows pre-softmax
    return logits.float() if fp32 else logits


@torch.no_grad()
def forward(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, tokens,
            collect_cache=False):
    """Full-sequence forward over ``tokens`` [B, S].  Returns (logits, aux,
    caches_or_None); ``caches`` is (k, v), each [L, B, S, KVH, hd], or None
    for a family without attention."""
    _require_ported(cfg)
    x = F.embedding(tokens, model.embed)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    ks, vs = [], []
    for blk in model.blocks:
        x, kv = _block(blk, x, cfg, policy, positions)
        if collect_cache and kv is not None:
            ks.append(kv[0])
            vs.append(kv[1])
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = _head(model, cfg, x, fp32=policy.logits_fp32)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, ((torch.stack(ks), torch.stack(vs)) if collect_cache and ks else None)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _layer_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, kv_dtype: str, device):
    c: dict = {}
    if cfg.has_attention:
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
    attention), plus ``k_scale``/``v_scale`` [L, B, S, KVH] for int8.  With
    an SSM: ``ssm`` = {``conv`` [L, B, d_conv - 1, conv_dim] in ``dtype``,
    ``state`` [L, B, H, P, N] float32}, as the reference's tree."""
    _require_ported(cfg)
    return _layer_cache(cfg, batch, max_len, dtype, kv_dtype, resolve_device(device))


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
def prefill(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, tokens, max_len=None):
    """Run the prompt, build the decode cache.  Returns (logits, cache,
    cache_len).  The Mamba state and conv window stay zero, as the
    reference's ``if cfg.has_ssm: pass`` leaves them (ROADMAP C.4)."""
    logits, _, kv = forward(model, cfg, policy, tokens, collect_cache=True)
    B, S = tokens.shape[:2]
    max_len = max_len or S
    cache = init_cache(cfg, B, max_len, dtype=params_dtype(model),
                       kv_dtype=policy.kv_cache_dtype, device=logits.device)
    if kv is None:
        return logits, cache, S
    k, v = kv
    int8 = policy.kv_cache_dtype == "int8"
    w = _window(cfg)
    if w and S >= w:
        shift = (S - w) % w
        k = torch.roll(k[:, :, S - w:], shift, dims=2)
        v = torch.roll(v[:, :, S - w:], shift, dims=2)
        S = w
    if int8:
        (cache["k"][:, :, :S], cache["k_scale"][:, :, :S]) = quantize_kv(k)
        (cache["v"][:, :, :S], cache["v_scale"][:, :, :S]) = quantize_kv(v)
    else:
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
    return logits, cache, tokens.shape[1]


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
    attn_out = _decode_attn(p.attn, h, cache, n, cfg, policy)
    if cfg.family == "hybrid":
        ssm_out = mamba_decode_step(p.mamba, h, cache["ssm"], cfg)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + glu_mlp(p.mlp, h2, act=cfg.act)


def _layer(cache: dict, l: int) -> dict:
    """Layer ``l``'s views of the stacked cache (nested groups included)."""
    return {name: (_layer(t, l) if isinstance(t, dict) else t[l]) for name, t in cache.items()}


@torch.no_grad()
def decode_step(model: Transformer, cfg: ArchConfig, policy: ShardingPolicy, cache, tokens,
                cache_len):
    """One serve step: tokens [B, 1] -> (logits, cache).

    ``cache_len`` is the number of tokens already in the cache: an int, or a
    one-element int32 tensor on the model's device, which keeps the loop
    free of host round trips.  The cache is updated **in place** and
    returned (the reference donates it to the step and returns a new one).
    """
    _require_ported(cfg)
    x = F.embedding(tokens, model.embed)
    n = _len_tensor(cache_len, x.device)
    for l, blk in enumerate(model.blocks):
        x = _decode_block(blk, x, _layer(cache, l), n, cfg, policy)
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    return _head(model, cfg, x, fp32=policy.logits_fp32), cache
