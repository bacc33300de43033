"""Decode attention: one new query row per (batch, head) against a KV cache
whose first ``cache_len`` entries are valid, with an optional window and
grouped-query heads.

The port of the Pallas kernel ``decode_attention_kernel`` /
``decode_attention_call`` (``repro/kernels/decode_attention.py``) and of its
wrapper ``ops.decode_attention``.  :func:`decode_attention` launches a
hand-written CUDA kernel (``csrc/decode_attention.cu``) for tensors on the
card and runs :func:`decode_attention_plain` for tensors on the CPU; it
never falls back from one to the other.  Head dims are those of
:func:`kernel_width` (the flash kernel's rule), each at the width it gives,
its extra columns zeros: 1 to 128 run split-KV
blocks that stream the cache through shared memory, the last block of each
kv head combining the splits (:func:`decode_split` picks the split); 129 to
256 run a thread-block cluster per (batch, kv head, group of up to 8
query heads) whose blocks share out the valid entries and combine in
distributed shared memory (:func:`decode_cluster` picks the cluster,
:func:`decode_cluster_on` with the kernel's geometry and the card's SMs;
:func:`decode_shares` mirrors how the kernel shares out the entries).

``cache_len`` is a Python int or a one-element int32 tensor on q's device.
The kernel reads it from device memory, as the TPU kernel read its scalar
prefetch, so a decode loop that keeps the length on the card never waits
for the host.  Valid entries are ``idx < cache_len`` and, with a window,
``idx > cache_len - 1 - window``; ``cache_len >= 1`` in every model call.

A shard of a cache (a rank's entries of a sequence-sharded one, on a model
axis): ``kv_start`` is the position of its first entry, ``cache_len`` stays
the whole cache's, and entry ``idx`` is valid where ``kv_start + idx`` is.
With ``with_lse`` the call also returns each head's log-sum-exp over the
shard's valid scores (float32 ``[B, H]``), which is what the ranks' outputs
are merged with (:func:`repro_torch.models.attention.combine_splits` with
``m = lse``, ``den = 1``).  A shard with no valid entry (the first decode
steps leave the later ranks' shards empty) gives ``o = 0`` and ``lse =
NEG_INF`` (-1e30), finite, which the merge masks out.

Shapes: q ``[B, 1, H, D]``, caches ``[B, Smax, KVH, D]`` (``H % KVH == 0``);
float32 or bfloat16, float32 inside, the output ``[B, 1, H, D]`` in q's
dtype.  The kernels read the caches where they lie, never a copy: in
16-byte pieces where the rows, base addresses and strides are whole 16-byte
units, as every served model's are, else in the widest of 8, 4 or 2 bytes
that divides them (:func:`check_decode_layout` says what they take).
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from .build import STATE_LOCK, check, count_launch, library, refuse_grad
from .flash_attention import NEG_INF, kernel_width, masked_attention

__all__ = ["decode_attention", "decode_attention_plain", "decode_valid", "decode_split",
           "decode_cluster", "decode_cluster_on", "decode_shares", "check_decode_layout"]

_DTYPES = (torch.float32, torch.bfloat16)
_MIN_SHARE = 16  # fewest entries of a full cache a block of a cluster takes


def decode_valid(smax: int, cache_len, window: int, device, kv_start: int = 0):
    """Which of ``smax`` cache entries a decode query sees: bool ``[smax]``,
    ``idx < cache_len`` and, with a window, ``idx > cache_len - 1 - window``,
    for entries ``idx`` from ``kv_start`` on (a shard's)."""
    idx = kv_start + torch.arange(smax, device=device)
    n = torch.as_tensor(cache_len, device=device).reshape(())
    valid = idx < n
    if window > 0:
        valid &= idx > n - 1 - window
    return valid


def decode_attention_plain(q, k_cache, v_cache, cache_len, *, window=0, kv_start=0,
                           with_lse=False):
    """The plain PyTorch version, on any device: the masked softmax in
    float32 over the whole cache (the function of the reference's
    ``ref.decode_attention_ref``).  A shard (``kv_start``) or ``with_lse``:
    a shard without a valid entry gives 0, and ``with_lse`` returns (o,
    each head's log-sum-exp [B, H] float32, ``NEG_INF`` where none is
    valid)."""
    valid = decode_valid(k_cache.shape[1], cache_len, window, q.device, kv_start)
    o = masked_attention(q, k_cache, v_cache, valid)
    if not kv_start and not with_lse:
        return o
    seen = valid.any()
    o = torch.where(seen, o, torch.zeros((), dtype=o.dtype, device=o.device))
    if not with_lse:
        return o
    B, _, H, D = q.shape
    KVH = k_cache.shape[2]
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, KVH, H // KVH, D).float(),
                     k_cache.float()) * D ** -0.5
    lse = torch.logsumexp(torch.where(valid, s, NEG_INF), dim=-1).reshape(B, H)
    return o, torch.where(seen, lse, NEG_INF)


def _check_args(q, k_cache, v_cache, cache_len, window):
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError(f"q must be [B,1,H,D] and caches [B,Smax,KVH,D]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, _, H, D = q.shape
    Smax, KVH = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_cache.shape) != (B, Smax, KVH, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches must be [B={B}, Smax, KVH, D={D}] alike; got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if min(B, Smax, KVH) < 1 or H % KVH:
        raise ValueError(f"need B, Smax >= 1 and H % KVH == 0; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"q and the caches must share float32 or bfloat16; got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must lie on one device")
    if isinstance(cache_len, torch.Tensor):
        if cache_len.dtype != torch.int32 or cache_len.numel() != 1:
            raise TypeError(f"cache_len must be one int32; got {cache_len.dtype} "
                            f"{tuple(cache_len.shape)}")
        if cache_len.device != q.device:
            raise ValueError(f"cache_len lies on {cache_len.device}, q on {q.device}")
    elif not isinstance(cache_len, numbers.Integral):
        raise TypeError(f"cache_len must be an int or an int32 tensor; got {type(cache_len)}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")


def check_decode_layout(k_cache, v_cache, q=None):
    """Raise ``ValueError`` unless the kernels read the caches and, where
    given, q as laid out (checked before every launch; runs on tensors on
    any device): a contiguous last dimension, k and v with equal strides,
    and every other stride positive (a dimension of size 1 is never stepped
    over).  Any base address and any stride of whole elements is taken: the
    kernels copy in the widest pieces (16, 8, 4 or 2 bytes) they divide."""
    if k_cache.stride(-1) != 1 or k_cache.stride() != v_cache.stride():
        raise ValueError("the kernel needs a contiguous last dimension, and caches with "
                         "equal strides")
    if q is not None and q.stride(-1) != 1:
        raise ValueError("the kernel needs q with a contiguous last dimension")
    named = [("k_cache", k_cache), ("v_cache", v_cache)] + ([("q", q)] if q is not None else [])
    for name, t in named:
        if any(n != 1 and st <= 0 for n, st in zip(t.shape[:3], t.stride()[:3])):
            raise ValueError(f"the kernel steps over positive strides; {name} has strides "
                             f"{tuple(t.stride())}")


def decode_split(B: int, KVH: int, G: int, Smax: int, n_sms: int, *, tile: int = 16,
                 max_split: int = 64, heads: int = 8) -> int:
    """Cache entries a block of the kernel takes: the smallest multiple of
    ``tile`` (at most ``max_split``) with which the blocks, one per (b, kv
    head, group of up to ``heads`` query heads, split), come to at most four
    an SM, so the card holds them all at once with their copies in flight;
    ``max_split`` where none does."""
    blocks = B * KVH * -(-G // heads)
    for split in range(tile, max_split + 1, tile):
        if blocks * -(-Smax // split) <= 4 * n_sms:
            return split
    return max_split


def decode_cluster(B: int, KVH: int, G: int, Smax: int, n_sms: int, *, heads: int,
                   max_cluster: int) -> int:
    """Blocks a cluster of the head-dim-256 kernel: the largest power of two
    up to ``max_cluster`` with which the clusters, one per (b, kv head,
    group of up to ``heads`` query heads), come to no more blocks than the
    card has SMs, and a block takes at least 16 entries of a full cache of
    ``Smax``; 1 where none does."""
    pairs = B * KVH * -(-G // heads)
    cluster = max_cluster
    while cluster > 1 and (pairs * cluster > n_sms or cluster * _MIN_SHARE > Smax):
        cluster //= 2
    return cluster


def decode_shares(cache_len: int, smax: int, window: int, cluster: int,
                  kv_start: int = 0) -> list:
    """The entries ``[start, end)`` each block of a cluster takes, by rank:
    the valid range ``[lo, hi)`` of a shard of ``smax`` entries from
    ``kv_start`` (``cache_len - kv_start`` clamped to ``smax``; with a
    window, from ``cache_len - window - kv_start``) in shares that differ by
    at most one entry, as the head-dim-256 kernel computes them on the
    device; every share empty where the shard holds no valid entry."""
    hi = min(max(cache_len - kv_start, 0), smax)
    lo = max(0, cache_len - window - kv_start) if window > 0 else 0
    n = max(hi - lo, 0)
    return [(lo + r * n // cluster, lo + (r + 1) * n // cluster) for r in range(cluster)]


_GEOMETRY: tuple | None = None
_SMS: dict = {}
_WORKSPACE: dict = {}


def _geometry(lib) -> tuple:
    """(entries a commit group, the largest split, query heads a block;
    query heads a cluster of the head-dim-256 kernel, its largest cluster),
    asked of the library once."""
    global _GEOMETRY
    with STATE_LOCK:
        if _GEOMETRY is None:
            _GEOMETRY = tuple(lib.repro_decode_attention_geometry(i) for i in range(5))
        return _GEOMETRY


def _workspace(device, stream: int, B: int, H: int, KVH: int, n_split: int, D: int,
               heads: int):
    """The splits' partial (max, denominator, accumulator), float32
    ``[B, H, n_split]`` twice and ``[B, H, n_split, D]`` (``D`` the kernel's
    width, :func:`kernel_width`), and the combine's
    counters, int32 ``[B, KVH ceil(G / heads)]`` and zero: one workspace per
    device, stream and shape, reused by every call (calls on one stream run
    in order, and each leaves the counters zero)."""
    key = (device, stream, B, H, KVH, n_split, D)
    with STATE_LOCK:
        ws = _WORKSPACE.get(key)
        if ws is None:
            n = B * H * n_split
            buf = torch.empty(n * (D + 2), dtype=torch.float32, device=device)
            counters = torch.zeros(B * KVH * -(-(H // KVH) // heads), dtype=torch.int32,
                                   device=device)
            ws = (buf[:n].view(B, H, n_split), buf[n:2 * n].view(B, H, n_split),
                  buf[2 * n:].view(B, H, n_split, D), counters)
            _WORKSPACE[key] = ws
        return ws


def _n_sms(device) -> int:
    with STATE_LOCK:
        if device not in _SMS:
            _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
        return _SMS[device]


def decode_cluster_on(device, B: int, KVH: int, G: int, Smax: int) -> int:
    """The cluster :func:`decode_attention` launches at head dim 256 on the
    card ``device``: :func:`decode_cluster` with the kernel's geometry and
    the card's SMs."""
    _, _, _, heads, max_cluster = _geometry(library())
    return decode_cluster(B, KVH, G, Smax, _n_sms(device), heads=heads, max_cluster=max_cluster)


_CLUSTERS: dict = {}


def _check_cluster(lib, device, bf16: int, cluster: int) -> None:
    """Raise unless the card can hold a cluster of ``cluster`` blocks of the
    head-dim-256 kernel (asked once per device, type and size)."""
    key = (device, bf16, cluster)
    with STATE_LOCK:
        fits = _CLUSTERS.get(key)
    if fits is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            check(lib.repro_decode_attention_d256_max_clusters(bf16, cluster, ctypes.byref(out)),
                  "decode_attention cluster occupancy")
        fits = out.value
        with STATE_LOCK:
            _CLUSTERS[key] = fits
    if fits < 1:
        raise RuntimeError(f"decode_attention: the card cannot schedule a cluster of {cluster} "
                           f"blocks of the head-dim-256 kernel")


def _launch_d256(lib, q, k_cache, v_cache, cache_len, o, lse, window: int,
                 kv_start: int) -> None:
    """Head dims from 129 to 256: the cluster kernel."""
    B, _, H, D = q.shape
    Smax, KVH = k_cache.shape[1], k_cache.shape[2]
    bf16 = int(q.dtype == torch.bfloat16)
    cluster = decode_cluster_on(q.device, B, KVH, H // KVH, Smax)
    _check_cluster(lib, q.device, bf16, cluster)
    with torch.cuda.device(q.device):
        code = lib.repro_decode_attention_d256(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
            o.data_ptr(), None if lse is None else lse.data_ptr(), B, H, KVH, Smax, D, bf16,
            kv_start, q.stride(0), q.stride(2),
            *k_cache.stride()[:3], o.stride(0), o.stride(2), int(window),
            ctypes.c_float(D ** -0.5), cluster, torch.cuda.current_stream().cuda_stream)
    check(code, "decode_attention launch")


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0, kv_start=0, with_lse=False):
    """q ``[B,1,H,D]``, caches ``[B,Smax,KVH,D]`` -> ``[B,1,H,D]`` (with
    ``with_lse``: and each head's log-sum-exp ``[B, H]``; ``kv_start``: the
    caches are a shard from that entry on, see the module doc): the CUDA
    kernel for tensors on the card, :func:`decode_attention_plain` for
    tensors on the CPU.  ``decode_attention.launches`` counts calls that
    launched the kernel (one launch a call)."""
    kv_start = int(kv_start)
    _check_args(q, k_cache, v_cache, cache_len, window)
    if kv_start < 0:
        raise ValueError(f"kv_start must be >= 0; got {kv_start}")
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len, window=window,
                                      kv_start=kv_start, with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors; got {q.device}")
    B, _, H, D = q.shape
    Smax, KVH = k_cache.shape[1], k_cache.shape[2]
    width = kernel_width(D)
    check_decode_layout(k_cache, v_cache, q)
    if not isinstance(cache_len, torch.Tensor):
        cache_len = torch.tensor([cache_len], dtype=torch.int32, device=q.device)
    lib = library()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if with_lse else None
    out = (o, lse) if with_lse else o
    if width == 256:
        _launch_d256(lib, q, k_cache, v_cache, cache_len, o, lse, window, kv_start)
        count_launch(decode_attention)
        return out
    tile, max_split, heads, _, _ = _geometry(lib)
    split = decode_split(B, KVH, H // KVH, Smax, _n_sms(q.device), tile=tile,
                         max_split=max_split, heads=heads)
    n_split = -(-Smax // split)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part_m, part_l, part_acc, counters = _workspace(q.device, stream, B, H, KVH, n_split,
                                                        width, heads)
        code = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), counters.data_ptr(),
            o.data_ptr(), None if lse is None else lse.data_ptr(), B, H, KVH, Smax, D, split,
            int(q.dtype == torch.bfloat16), kv_start, q.stride(0), q.stride(2),
            *k_cache.stride()[:3], o.stride(0), o.stride(2), int(window),
            ctypes.c_float(D ** -0.5), stream)
    check(code, "decode_attention launch")
    count_launch(decode_attention)
    return out


decode_attention.launches = 0
