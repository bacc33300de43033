"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of the reference's ``models/mla.py``.  Prefill uses the expanded
form; the decode step uses the *absorbed* form against the compressed cache
(``c_kv`` [B, S, r] + ``k_pe`` [B, S, dr]): r = 512 numbers a token for
deepseek-v2-lite-16b against H (dn + dv) = 4096 for its expanded K and V.

Plain PyTorch, as the reference is plain ``jnp`` here: no kernel.  Scores
are taken in float32 (the reference's ``preferred_element_type``); the
decode step writes the new token into the cache in place.
"""

from __future__ import annotations

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels.flash_attention import NEG_INF
from .layers import apply_rope, rope

__all__ = ["init_mla", "mla_attention", "mla_decode_step", "init_mla_cache"]


def init_mla(init, cfg: ArchConfig):
    m = cfg.mla
    H = cfg.num_heads
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_q": init.normal((cfg.d_model, H * dq)),
        "w_dkv": init.normal((cfg.d_model, m.kv_lora_rank)),
        "w_kr": init.normal((cfg.d_model, m.qk_rope_head_dim)),
        "w_uk": init.normal((m.kv_lora_rank, H * m.qk_nope_head_dim)),
        "w_uv": init.normal((m.kv_lora_rank, H * m.v_head_dim)),
        "w_o": init.normal((H * m.v_head_dim, cfg.d_model)),
    }


def _project(p, x, cfg: ArchConfig, pos):
    """(q_nope [B,S,H,dn], q_pe [B,S,H,dr], c_kv [B,S,r], k_pe [B,S,dr]); the
    rotary part rotated at ``pos`` over its own dr dimensions."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = (x @ p.w_q).reshape(B, S, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    c_kv = x @ p.w_dkv  # [B, S, r]: the compressed latent (cached)
    k_pe = (x @ p.w_kr).reshape(B, S, 1, dr)
    cos, sin = rope(pos, dr, cfg.rope_theta)
    cos, sin = cos[:, :, None, : dr // 2], sin[:, :, None, : dr // 2]
    return q_nope, apply_rope(q_pe, cos, sin), c_kv, apply_rope(k_pe, cos, sin)[:, :, 0]


def mla_attention(p, x, cfg: ArchConfig, pos, causal=True):
    """Expanded-form MLA for prefill.  Returns (out [B,S,D], {"c_kv", "k_pe"})."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_pe, c_kv, k_pe = _project(p, x, cfg, pos)
    k_nope = (c_kv @ p.w_uk).reshape(B, S, H, dn)
    v = (c_kv @ p.w_uv).reshape(B, S, H, dv)
    s = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
         + torch.einsum("bqhd,bkd->bhqk", q_pe.float(), k_pe.float())) * (dn + dr) ** -0.5
    if causal:
        msk = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))
        s = torch.where(msk, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype), v).reshape(B, S, H * dv)
    return o @ p.w_o, {"c_kv": c_kv, "k_pe": k_pe}


def init_mla_cache(cfg: ArchConfig, layers: int, batch: int, max_len: int, dtype, device):
    """Zeroed latent caches stacked over ``layers``: ``c_kv`` [L, B, S, r] and
    ``k_pe`` [L, B, S, dr]."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros(layers, batch, max_len, m.kv_lora_rank, dtype=dtype, device=device),
        "k_pe": torch.zeros(layers, batch, max_len, m.qk_rope_head_dim, dtype=dtype,
                            device=device),
    }


def mla_decode_step(p, x, cache: dict, n, cfg: ArchConfig):
    """Absorbed-form one-token decode against the compressed cache::

        scores_h(s) = (W_uk_h^T q_nope_h) . c_s + q_pe_h . k_pe_s
        out_h       = W_uv_h^T (sum_s p_s c_s)

    x [B, 1, D]; ``cache`` this layer's ``c_kv`` [B, Smax, r] and ``k_pe``
    [B, Smax, dr], written in place at slot ``n`` (a one-element int32
    tensor: the tokens already cached); entries ``<= n`` are attended.
    Returns out [B, 1, D]."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    dn, dr, dv, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank
    q_nope, q_pe, c_new, k_pe_new = _project(p, x, cfg, n.view(1, 1).expand(B, 1))
    c_kv, k_pe = cache["c_kv"], cache["k_pe"]
    Smax = c_kv.shape[1]
    # the reference's dynamic_update_slice clamps its start index into range
    slot = torch.clamp(n, max=Smax - 1).long()
    c_kv.index_copy_(1, slot, c_new.to(c_kv.dtype))
    k_pe.index_copy_(1, slot, k_pe_new.to(k_pe.dtype))
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], p.w_uk.reshape(r, H, dn))  # [B, H, r]
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c_kv.float())
         + torch.einsum("bhd,bsd->bhs", q_pe[:, 0].float(), k_pe.float())) * (dn + dr) ** -0.5
    valid = torch.arange(Smax, device=x.device) <= n
    pr = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pr, c_kv.float())  # [B, H, r]
    o = torch.einsum("bhr,rhd->bhd", o_lat.to(x.dtype), p.w_uv.reshape(r, H, dv))
    return o.reshape(B, 1, H * dv) @ p.w_o
