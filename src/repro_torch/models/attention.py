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

On a model axis wider than 1 (DTensor inputs on the model mesh, see
:func:`repro_torch.models.layers.constrain`) :func:`attention` takes the
reference's layouts: q sequence-sharded, K and V replicated, the output
sequence-sharded; each rank runs the policy's implementation (the plain
ones, or under ``"cuda"`` the flash kernel with ``q_offset``) over its own
q rows from their global offset (the causal mask's), on local tensors.  Without ``shard_seq``
(the reference's ``shard_seq_attn=False``) no constraint is set: q stays
as its projection left it, on each rank's heads (or replicated where the
axis does not divide them), and each rank attends its own heads to the
KV heads of their GQA groups (its own, or its cut of replicated ones).  :func:`decode_attention`
keeps the cache sequence-sharded and runs split-KV: each rank's partial
softmax over its own entries (max, sum, weighted values; under ``"cuda"``
the decode kernel on the rank's shard from its first entry's position,
``kv_start``, giving the normalised output and its log-sum-exp), all-gathered
and merged, where the reference leaves the split to XLA.  No kernel sees a
DTensor, and a local tensor the kernel cannot take as laid out raises (the
wrappers' layout checks): nothing falls back to a plain version on a card.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import kernels
from repro_torch.kernels.decode_attention import decode_valid
from repro_torch.kernels.flash_attention import NEG_INF, attention_mask, masked_attention

from .layers import constrain, local_offset

__all__ = ["naive_attention", "chunked_attention", "attention", "decode_attention",
           "combine_splits", "merge_splits", "NEG_INF"]


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    m = attention_mask(q.shape[1], k.shape[1], q_offset, 0, causal, window, q.device)
    return masked_attention(q, k, v, m, probs_dtype=v.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, q_chunk=1024, kv_chunk=1024,
                      block_skip=True, q_offset=0):
    """Online-softmax attention, O(q_chunk * kv_chunk) score memory.

    ``block_skip``: skip fully masked kv chunks (upper triangle for causal;
    out-of-window bands for SWA), ~2x fewer matmul FLOPs for causal.
    Without it every kv chunk is visited, as the reference's scan form.
    ``q_offset``: the position of q's first row among the keys' (a rank's
    piece of a sequence-sharded q).
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
        q_off = q_offset + qi * q_chunk
        qc = q[:, q_off - q_offset:q_off - q_offset + q_chunk].reshape(B, q_chunk, KVH, G, D)
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


def _attention(q, k, v, *, impl, causal, window, q_chunk, kv_chunk, block_skip, q_offset=0):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk, block_skip=block_skip, q_offset=q_offset)
    if impl == "cuda":
        return kernels.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    raise ValueError(impl)


def attention(q, k, v, *, impl="chunked", causal=True, window=0, q_chunk=1024, kv_chunk=1024,
              block_skip=True, model_axis="model", shard_seq=True):
    """Dispatching wrapper over the three implementations, with the
    reference's sequence-sharding constraints (``shard_seq``)."""
    kw = dict(impl=impl, causal=causal, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
              block_skip=block_skip)
    if shard_seq:
        q = constrain(q, ("pod", "data"), model_axis, None, None)
        k = constrain(k, ("pod", "data"), None, None, None)
        v = constrain(v, ("pod", "data"), None, None, None)
    if not isinstance(q, DTensor):
        return _attention(q, k, v, **kw)
    if not q.placements[0].is_shard(1):
        return _head_attention(q, k, v, **kw)
    # a sequence-sharded q (also without ``shard_seq``, under sequence
    # parallelism's q on each rank's rows): the keys whole
    k = constrain(k, ("pod", "data"), None, None, None)
    v = constrain(v, ("pod", "data"), None, None, None)
    # each rank attends its own q rows to the replicated keys, so its K and
    # V gradients are partial sums over the model axis
    kl, vl = (t.to_local(grad_placements=[Partial()]) for t in (k, v))
    out = _attention(q.to_local(), kl, vl, **kw, q_offset=local_offset(q, 1)).contiguous()
    out = DTensor.from_local(out, q.device_mesh, q.placements, run_check=False, shape=q.shape,
                             stride=torch.empty(q.shape, device="meta").stride())
    return constrain(out, ("pod", "data"), model_axis, None, None)


def _head_attention(q, k, v, **kw):
    """Attention on each rank's heads: q [B, S, H, D] sharded on its heads
    or replicated, k and v on theirs or replicated (gathered first where
    they are sequence-sharded).  A rank's q heads ``[lo, hi)`` read the KV
    heads of their GQA groups, ``h // G``: its own KV heads where both are
    sharded (the same groups), else its cut of the replicated ones, each
    repeated to its q heads where they do not fill whole groups.  The
    output has q's placements; a replicated K or V read by sharded q heads
    has a partial gradient."""
    k, v = (t.redistribute(placements=[Replicate()]) if t.placements[0].is_shard(1) else t
            for t in (k, v))
    H, KVH = q.shape[2], k.shape[2]
    G = H // KVH
    ql = q.to_local()
    if q.placements[0].is_shard(2) and not k.placements[0].is_shard(2):
        lo = local_offset(q, 2)
        idx = torch.arange(lo, lo + ql.shape[2], device=ql.device) // G
        first, last = lo // G, (lo + ql.shape[2] - 1) // G
        kl, vl = (t.to_local(grad_placements=[Partial()]) for t in (k, v))
        if lo % G == 0 and ql.shape[2] % G == 0:  # whole groups: their KV heads
            kl, vl = kl[:, :, first:last + 1], vl[:, :, first:last + 1]
        elif first == last:  # part of one group: its KV head
            kl, vl = kl[:, :, first:first + 1], vl[:, :, first:first + 1]
        else:  # parts of several groups: each q head's KV head
            kl, vl = kl[:, :, idx], vl[:, :, idx]
    else:  # both on their heads (the same groups a rank), or both replicated
        kl, vl = k.to_local(), v.to_local()
    out = _attention(ql, kl, vl, **kw).contiguous()
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False, shape=q.shape,
                              stride=torch.empty(q.shape, device="meta").stride())


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0, impl="chunked",
                     model_axis="model", shard_seq=True):
    """Single-token attention against a KV cache.

    q [B,1,H,D]; caches [B,Smax,KVH,D]; ``cache_len`` an int or a
    one-element int32 tensor — the number of valid entries (positions >=
    cache_len are masked).  With ``shard_seq`` on a model axis the caches
    stay sequence-sharded and the split-KV combine runs across the ranks.
    """
    if shard_seq:
        k_cache = constrain(k_cache, ("pod", "data"), model_axis, None, None)
        v_cache = constrain(v_cache, ("pod", "data"), model_axis, None, None)
    if isinstance(q, DTensor):
        return _split_kv_decode(q, k_cache, v_cache, cache_len, window, impl)
    if impl == "cuda":
        return kernels.decode_attention(q, k_cache, v_cache, cache_len, window=window)
    if impl not in ("naive", "chunked"):
        raise ValueError(impl)
    valid = decode_valid(k_cache.shape[1], cache_len, window, q.device)
    return masked_attention(q, k_cache, v_cache, valid, probs_dtype=v_cache.dtype)


def _split_kv_decode(q, k_cache, v_cache, cache_len, window, impl):
    """Decode attention over a sequence-sharded cache: each rank's (max,
    sum, weighted values) over its own valid entries, all-gathered over
    the model axis and merged (flash-decoding's combine); under ``"cuda"``
    the kernel's output over the rank's shard and its log-sum-exp, merged
    as (lse, 1, output).  Returns q's layout, replicated."""
    if impl not in ("naive", "chunked", "cuda"):
        raise ValueError(impl)
    mesh = q.device_mesh
    if tuple(k_cache.placements) != (Shard(1),) or tuple(v_cache.placements) != (Shard(1),):
        raise ValueError("split-KV decode reads a sequence-sharded cache")
    ql = q.redistribute(placements=[Replicate()]).to_local()
    kl, vl = k_cache.to_local(), v_cache.to_local()
    B, _, H, D = ql.shape
    KVH = kl.shape[2]
    G = H // KVH
    start = local_offset(k_cache, 1)
    if impl == "cuda":
        o, lse = kernels.decode_attention(ql, kl, vl, cache_len, window=window, kv_start=start,
                                          with_lse=True)
        out = combine_splits(lse, torch.ones_like(lse), o[:, 0].float(), mesh)
        out = out.reshape(B, 1, H, D).to(q.dtype)
        return DTensor.from_local(out, mesh, [Replicate()], run_check=False)
    valid = decode_valid(kl.shape[1], cache_len, window, ql.device, start)
    s = torch.einsum("bkgd,bskd->bkgs", ql.reshape(B, KVH, G, D).float(),
                     kl.float()) * D ** -0.5
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)  # [B, KVH, G]
    p = torch.exp(s - m[..., None])
    out = combine_splits(m, p.sum(dim=-1),
                         torch.einsum("bkgs,bskd->bkgd", p.to(vl.dtype).float(), vl.float()), mesh)
    out = out.reshape(B, 1, H, D).to(q.dtype)
    return DTensor.from_local(out, mesh, [Replicate()], run_check=False)


def combine_splits(m, den, acc, mesh):
    """Flash-decoding's combine over the model axis ``mesh``: each rank's
    softmax over its own entries as its max ``m`` [...], its sum of
    ``exp(s - m)`` ``den`` [...] and its ``exp(s - m)``-weighted values
    ``acc`` [..., D], all-gathered and merged by :func:`merge_splits` into
    the softmax-weighted values [..., D], the same on every rank."""
    part = torch.cat([m[..., None], den[..., None], acc], dim=-1)
    parts = DTensor.from_local(part[None], mesh, [Shard(0)], run_check=False).full_tensor()
    return merge_splits(parts[..., 0], parts[..., 1], parts[..., 2:])


def merge_splits(m, den, acc):
    """The splits' (max, sum, weighted values), stacked on a leading dim
    (``m``, ``den`` [R, ...], ``acc`` [R, ..., D]), merged into the
    softmax-weighted values [..., D]; a split with no valid entry (``m`` at
    ``NEG_INF``) weighs nothing.  A kernel's normalised output ``o`` and
    log-sum-exp ``lse`` over a split enter as ``(lse, 1, o)``."""
    top = m.amax(dim=0)
    w = torch.exp(m - top) * (m > NEG_INF / 2)
    den = (w * den).sum(dim=0)
    return (w[..., None] * acc).sum(dim=0) / torch.clamp(den[..., None], min=1e-30)
