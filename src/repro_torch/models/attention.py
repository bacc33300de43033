"""Attention implementations: naive oracle, chunked online softmax, and
decode against a KV cache.

The port of the reference's ``models/attention.py``.  Selectable via
``ShardingPolicy.attention_impl``:

  "naive"   — materializes [B, H, Sq, Sk] scores; the correctness oracle,
              :func:`repro_torch.kernels.flash_attention.masked_attention`,
              which the kernels' plain versions share.
  "chunked" — q-chunk × kv-chunk online softmax: O(S·chunk) score memory;
              ``block_skip`` skips fully masked kv chunks (causal upper
              triangle, out-of-window bands), otherwise every chunk is
              visited (the reference's ``lax.scan`` form).
  "cuda"    — the hand-written kernels (:mod:`repro_torch.kernels`), where
              the reference dispatches its Pallas kernels (``"pallas"``).

All functions take q [B,Sq,H,D], k/v [B,Skv,KVH,D] with GQA broadcasting done
group-wise (never materializing repeated K/V).  Products of bfloat16 inputs
are taken in float32, as the reference's ``preferred_element_type``.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention import decode_valid
from repro_torch.kernels.flash_attention import NEG_INF, attention_mask, masked_attention

__all__ = ["naive_attention", "chunked_attention", "attention", "decode_attention", "NEG_INF"]


def naive_attention(q, k, v, *, causal=True, window=0):
    m = attention_mask(q.shape[1], k.shape[1], 0, 0, causal, window, q.device)
    return masked_attention(q, k, v, m, probs_dtype=v.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, q_chunk=1024, kv_chunk=1024,
                      block_skip=True):
    """Online-softmax attention, O(q_chunk * kv_chunk) score memory.

    ``block_skip``: skip fully masked kv chunks (upper triangle for causal;
    out-of-window bands for SWA), ~2x fewer matmul FLOPs for causal.
    Without it every kv chunk is visited, as the reference's scan form.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    KVH = k.shape[2]
    G = H // KVH
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    if Sq % q_chunk or Sk % kv_chunk:
        raise ValueError(f"chunks must divide the lengths: Sq={Sq}, q_chunk={q_chunk}, "
                         f"Sk={Sk}, kv_chunk={kv_chunk}")
    scale = D ** -0.5
    kr = k.reshape(B, nk, kv_chunk, KVH, D)
    vr = v.reshape(B, nk, kv_chunk, KVH, D)
    f32 = dict(dtype=torch.float32, device=q.device)

    def update(carry, qc, q_off, kc, vc, k_off):
        m_run, l_run, acc = carry
        s = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kc.float()) * scale
        msk = attention_mask(q_chunk, kv_chunk, q_off, k_off, causal, window, q.device)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vc.float())
        return m_new, l_run, acc

    def init_carry():
        return (torch.full((B, KVH, G, q_chunk), NEG_INF, **f32),
                torch.zeros((B, KVH, G, q_chunk), **f32),
                torch.zeros((B, KVH, G, q_chunk, D), **f32))

    def finish(carry):
        _, l_run, acc = carry
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        return out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, D).to(q.dtype)

    outs = []
    for qi in range(nq):
        q_off = qi * q_chunk
        qc = q[:, q_off:q_off + q_chunk].reshape(B, q_chunk, KVH, G, D)
        lo, hi = 0, nk
        if block_skip:
            if causal:
                hi = min(nk, (q_off + q_chunk + kv_chunk - 1) // kv_chunk)
            if window > 0:
                lo = max(0, (q_off - window) // kv_chunk)
        carry = init_carry()
        for ki in range(lo, hi):
            carry = update(carry, qc, q_off, kr[:, ki], vr[:, ki], ki * kv_chunk)
        outs.append(finish(carry))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attention(q, k, v, *, impl="chunked", causal=True, window=0, q_chunk=1024, kv_chunk=1024,
              block_skip=True):
    """Dispatching wrapper over the three implementations."""
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk, block_skip=block_skip)
    if impl == "cuda":
        return kernels.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(impl)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0, impl="chunked"):
    """Single-token attention against a KV cache.

    q [B,1,H,D]; caches [B,Smax,KVH,D]; ``cache_len`` an int or a
    one-element int32 tensor — the number of valid entries (positions >=
    cache_len are masked).
    """
    if impl == "cuda":
        return kernels.decode_attention(q, k_cache, v_cache, cache_len, window=window)
    if impl not in ("naive", "chunked"):
        raise ValueError(impl)
    valid = decode_valid(k_cache.shape[1], cache_len, window, q.device)
    return masked_attention(q, k_cache, v_cache, valid, probs_dtype=v_cache.dtype)
