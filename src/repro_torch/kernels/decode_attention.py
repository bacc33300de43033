"""Decode attention: one new query row per (batch, head) against a KV cache
whose first ``cache_len`` entries are valid, with an optional window and
grouped-query heads.

The port of the Pallas kernel ``decode_attention_kernel`` /
``decode_attention_call`` (``repro/kernels/decode_attention.py``) and of its
wrapper ``ops.decode_attention``.  :func:`decode_attention` launches the
hand-written CUDA kernel (``csrc/decode_attention.cu``: a split-KV pass and
a combine pass) for tensors on the card and runs
:func:`decode_attention_plain` for tensors on the CPU; it never falls back
from one to the other.

``cache_len`` is a Python int or a one-element int32 tensor on q's device.
The kernel reads it from device memory, as the TPU kernel read its scalar
prefetch, so a decode loop that keeps the length on the card never waits
for the host.  Valid entries are ``idx < cache_len`` and, with a window,
``idx > cache_len - 1 - window``; ``cache_len >= 1`` in every model call.

Shapes: q ``[B, 1, H, D]``, caches ``[B, Smax, KVH, D]`` (``H % KVH == 0``);
float32 or bfloat16, float32 inside, the output ``[B, 1, H, D]`` in q's
dtype.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from .build import check, library
from .flash_attention import KERNEL_HEAD_DIMS, masked_attention

__all__ = ["decode_attention", "decode_attention_plain", "decode_valid"]

_DTYPES = (torch.float32, torch.bfloat16)


def decode_valid(smax: int, cache_len, window: int, device):
    """Which of ``smax`` cache entries a decode query sees: bool ``[smax]``,
    ``idx < cache_len`` and, with a window, ``idx > cache_len - 1 - window``."""
    idx = torch.arange(smax, device=device)
    n = torch.as_tensor(cache_len, device=device).reshape(())
    valid = idx < n
    if window > 0:
        valid &= idx > n - 1 - window
    return valid


def decode_attention_plain(q, k_cache, v_cache, cache_len, *, window=0):
    """The plain PyTorch version, on any device: the masked softmax in
    float32 over the whole cache (the function of the reference's
    ``ref.decode_attention_ref``)."""
    valid = decode_valid(k_cache.shape[1], cache_len, window, q.device)
    return masked_attention(q, k_cache, v_cache, valid)


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


_CHUNK: int | None = None
_PARTIALS: dict = {}


def _chunk(lib) -> int:
    """Cache entries per split of pass 1, asked of the library once."""
    global _CHUNK
    if _CHUNK is None:
        _CHUNK = lib.repro_decode_attention_chunk()
    return _CHUNK


def _partials(device, stream: int, B: int, H: int, n_split: int, D: int):
    """Pass 1's partial (max, denominator, accumulator) buffers, float32
    ``[B, H, n_split]`` twice and ``[B, H, n_split, D]``: one workspace per
    device, stream and shape, reused by every call (calls on one stream run
    in order, so a call's combine pass has read it before the next call's
    first pass writes it)."""
    key = (device, stream, B, H, n_split, D)
    ws = _PARTIALS.get(key)
    if ws is None:
        n = B * H * n_split
        buf = torch.empty(n * (D + 2), dtype=torch.float32, device=device)
        ws = (buf[:n].view(B, H, n_split), buf[n:2 * n].view(B, H, n_split),
              buf[2 * n:].view(B, H, n_split, D))
        _PARTIALS[key] = ws
    return ws


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0):
    """q ``[B,1,H,D]``, caches ``[B,Smax,KVH,D]`` -> ``[B,1,H,D]``: the CUDA
    kernel for tensors on the card, :func:`decode_attention_plain` for
    tensors on the CPU.  ``decode_attention.launches`` counts calls that
    launched the kernel (each is its two passes)."""
    _check_args(q, k_cache, v_cache, cache_len, window)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors; got {q.device}")
    B, _, H, D = q.shape
    Smax, KVH = k_cache.shape[1], k_cache.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {KERNEL_HEAD_DIMS}; got {D}")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 or k_cache.stride() != v_cache.stride():
        raise ValueError("the kernel needs a contiguous last dimension, and caches with "
                         "equal strides")
    if not isinstance(cache_len, torch.Tensor):
        cache_len = torch.tensor([cache_len], dtype=torch.int32, device=q.device)
    lib = library()
    n_split = -(-Smax // _chunk(lib))
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part_m, part_l, part_acc = _partials(q.device, stream, B, H, n_split, D)
        code = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), o.data_ptr(),
            B, H, KVH, Smax, D, int(q.dtype == torch.bfloat16), q.stride(0), q.stride(2),
            *k_cache.stride()[:3], o.stride(0), o.stride(2), int(window),
            ctypes.c_float(D ** -0.5), stream)
    check(code, "decode_attention launch")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
