"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of the reference's ``models/mla.py``.  Prefill uses the expanded
form; the decode step uses the *absorbed* form against the compressed cache
(``c_kv`` [B, S, r] + ``k_pe`` [B, S, dr]): r = 512 numbers a token for
deepseek-v2-lite-16b against H (dn + dv) = 4096 for its expanded K and V.

Plain PyTorch, as the reference is plain ``jnp`` here: no kernel.  Scores
are taken in float32 (the reference's ``preferred_element_type``); the
decode step writes the new token into the cache in place.

On a model axis wider than 1 (``x`` a DTensor replicated there, the
weights sharded by :mod:`repro_torch.runtime.sharding`) the heads go over
'model', as the reference's layout puts them: q from ``w_q`` and
``k_nope``, ``v`` from ``w_uk``, ``w_uv`` (each sharded on its output),
the latent ``c_kv`` and ``k_pe`` replicated.  Prefill scores each rank's
own heads; decode keeps the latent cache sequence-sharded (the rank whose
range holds slot n writes it), gathers the absorbed queries of all heads,
scores each rank's own entries and merges the ranks' partial softmaxes
(:func:`~repro_torch.models.attention.combine_splits`), then takes its own
heads through ``w_uv``.  ``o @ w_o`` is a partial sum over the ranks,
all-reduced at the output's constraint.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.config import ArchConfig
from repro_torch.kernels.flash_attention import NEG_INF
from .attention import combine_splits
from .layers import apply_rope, constrain, local_offset, replicated, rope, write_slot

DP = ("pod", "data")

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
    cos, sin = (replicated(t[:, :, None, : dr // 2], x) for t in (cos, sin))
    return q_nope, apply_rope(q_pe, cos, sin), c_kv, apply_rope(k_pe, cos, sin)[:, :, 0]


def _expanded(q_nope, q_pe, k_nope, k_pe, v, causal):
    """Softmax attention of the heads at hand: [B, S, h, dv]."""
    S = q_nope.shape[1]
    scale = (q_nope.shape[-1] + q_pe.shape[-1]) ** -0.5
    s = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
         + torch.einsum("bqhd,bkd->bhqk", q_pe.float(), k_pe.float())) * scale
    if causal:
        msk = torch.tril(torch.ones(S, S, dtype=torch.bool, device=s.device))
        s = torch.where(msk, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype), v)


def mla_attention(p, x, cfg: ArchConfig, pos, causal=True, model_axis="model", out_spec=None):
    """Expanded-form MLA for prefill.  Returns (out [B,S,D], {"c_kv", "k_pe"}).
    ``out_spec``: the residual stream's spec for the output (a
    sequence-sharded ``x``, ``sp_activations``, is gathered first, and the
    partial sums reach a sequence-sharded stream by a reduce-scatter)."""
    x = constrain(x, DP, None, None)
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dv = m.qk_nope_head_dim, m.v_head_dim
    q_nope, q_pe, c_kv, k_pe = _project(p, x, cfg, pos)
    k_nope = (c_kv @ p.w_uk).reshape(B, S, H, dn)
    v = (c_kv @ p.w_uv).reshape(B, S, H, dv)
    heads = [constrain(t, DP, None, model_axis, None) for t in (q_nope, q_pe, k_nope, v)]
    if isinstance(q_nope, DTensor):  # each rank its own heads; k_pe's gradient partial
        local = _expanded(*(t.to_local() for t in heads[:3]),
                          k_pe.to_local(grad_placements=[Partial()]), heads[3].to_local(),
                          causal).contiguous()
        o = DTensor.from_local(local, q_nope.device_mesh, [Shard(2)], run_check=False,
                               shape=(B, S, H, dv), stride=(S * H * dv, H * dv, dv, 1))
    else:
        o = _expanded(*heads[:3], k_pe, heads[3], causal)
    out = constrain(o.reshape(B, S, H * dv) @ p.w_o, *(out_spec or (DP, None, None)))
    return out, {"c_kv": c_kv, "k_pe": k_pe}


def init_mla_cache(cfg: ArchConfig, layers: int, batch: int, max_len: int, dtype, device):
    """Zeroed latent caches stacked over ``layers``: ``c_kv`` [L, B, S, r] and
    ``k_pe`` [L, B, S, dr]."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros(layers, batch, max_len, m.kv_lora_rank, dtype=dtype, device=device),
        "k_pe": torch.zeros(layers, batch, max_len, m.qk_rope_head_dim, dtype=dtype,
                            device=device),
    }


def mla_decode_step(p, x, cache: dict, n, cfg: ArchConfig, model_axis="model"):
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
    c_kv = constrain(cache["c_kv"], DP, model_axis, None)
    k_pe = constrain(cache["k_pe"], DP, model_axis, None)
    Smax = c_kv.shape[1]
    # the reference's dynamic_update_slice clamps its start index into range
    slot = torch.clamp(n, max=Smax - 1).long()
    if isinstance(c_kv, DTensor):
        write_slot(c_kv, slot, c_new)
        write_slot(k_pe, slot, k_pe_new)
        return constrain(_split_latent_decode(p, q_nope, q_pe, c_kv, k_pe, n, cfg), DP, None,
                         None)
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


def _split_latent_decode(p, q_nope, q_pe, c_kv, k_pe, n, cfg: ArchConfig):
    """The absorbed decode over a sequence-sharded latent cache: each
    rank's absorbed queries gathered over the model axis, every head scored
    on the rank's own entries, the ranks' partial softmaxes merged, then
    the rank's own heads through ``w_uv`` and ``w_o`` (a partial sum)."""
    m = cfg.mla
    B, H = q_nope.shape[0], cfg.num_heads
    dn, dr, dv, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank
    mesh = q_nope.device_mesh
    qn, w_uk = q_nope.to_local()[:, 0], p.w_uk.to_local()
    h = qn.shape[1]  # this rank's heads
    q_lat = torch.einsum("bhd,rhd->bhr", qn, w_uk.reshape(r, h, dn))
    q_lat, qp = (DTensor.from_local(t, mesh, [Shard(1)], run_check=False).full_tensor()
                 for t in (q_lat, q_pe.to_local()[:, 0]))  # [B, H, r], [B, H, dr]
    cl, kl = c_kv.to_local().float(), k_pe.to_local().float()
    start = local_offset(c_kv, 1)
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), cl)
         + torch.einsum("bhd,bsd->bhs", qp.float(), kl)) * (dn + dr) ** -0.5
    valid = torch.arange(start, start + cl.shape[1], device=cl.device) <= n
    s = torch.where(valid, s, NEG_INF)
    top = s.amax(dim=-1)  # [B, H]
    e = torch.exp(s - top[..., None])
    o_lat = combine_splits(top, e.sum(dim=-1), torch.einsum("bhs,bsr->bhr", e, cl), mesh)
    first = local_offset(q_nope, 2)
    o = torch.einsum("bhr,rhd->bhd", o_lat[:, first:first + h].to(qn.dtype),
                     p.w_uv.to_local().reshape(r, h, dv))
    o = DTensor.from_local(o.reshape(B, 1, h * dv), mesh, [Shard(2)], run_check=False,
                           shape=(B, 1, H * dv), stride=(H * dv, H * dv, 1))
    return o @ p.w_o
