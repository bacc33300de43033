"""Prefill attention: causal or sliding-window masked softmax attention with
grouped-query heads.

The port of the Pallas kernel ``flash_attention_kernel`` /
``flash_attention_call`` (``repro/kernels/flash_attention.py``) and of its
wrapper ``ops.flash_attention``.  :func:`flash_attention` launches the
hand-written CUDA kernel (``csrc/flash_attention.cu``: ``wgmma`` on the
tensor cores, K/V fed by TMA; head dim 256 a kernel of its own in the same
source, float32 after a small kernel that splits K and V into TF32 halves
once a call, into a workspace this wrapper allocates) for tensors on the
card and runs :func:`flash_attention_plain` for tensors on the CPU; it never
falls back from one to the other.  Unlike
the TPU kernel it reads the model's ``[B, S, H, D]`` layout through strides
(no transposes) and takes lengths that no tile size divides.  TMA needs
q, k and v 16-byte aligned with strides that are multiples of 16 bytes:
:func:`check_kernel_layout` says what the kernel takes, and the wrapper
raises on anything else.  Head dims: every multiple of 16 up to 128, and
256 (:func:`kernel_width`, the rule the decode kernel shares); one that is
not a power of two runs the next instantiated width with its extra
columns read as zeros.

Shapes: q ``[B, Sq, H, D]``, k/v ``[B, Sk, KVH, D]`` with ``H % KVH == 0``
(query head ``h`` reads kv head ``h // (H // KVH)``); float32 or bfloat16,
float32 inside, the output ``[B, Sq, H, D]`` in q's dtype.  Masks use the
absolute positions: causal ``k <= q``, window ``k > q - window``, with q's
row ``i`` at position ``q_offset + i`` (0 for a whole sequence; on a model
axis a rank's first row of a sequence-sharded q, K and V whole).
"""

from __future__ import annotations

import ctypes

import torch

from .build import check, count_launch, library, refuse_grad

__all__ = ["flash_attention", "flash_attention_plain", "masked_attention", "attention_mask",
           "check_kernel_layout", "workspace_bytes", "kernel_width", "NEG_INF"]

NEG_INF = -1e30
_WIDTHS = (16, 32, 64, 128)  # the instantiated widths of the kernels for head dims up to 128
_DTYPES = (torch.float32, torch.bfloat16)


def attention_mask(sq, sk, q_off, k_off, causal: bool, window: int, device):
    """Which of ``sq`` queries (from position ``q_off``) see which of ``sk``
    keys (from ``k_off``): bool ``[sq, sk]``, causal ``k <= q``, window
    ``k > q - window``."""
    qi = q_off + torch.arange(sq, device=device)[:, None]
    ki = k_off + torch.arange(sk, device=device)[None, :]
    m = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window > 0:
        m &= ki > qi - window
    return m


def masked_attention(q, k, v, valid, *, probs_dtype=torch.float32):
    """Masked softmax attention over materialised scores, the one plain
    oracle of the port: q ``[B,Sq,H,D]``, k/v ``[B,Sk,KVH,D]``, ``valid``
    bool broadcastable to ``[Sq, Sk]``.  Scores are float32 and masked with
    the finite ``NEG_INF``; grouped-query heads are taken group-wise (no
    repeated K/V).  The second product takes the probabilities and V in
    ``probs_dtype``: float32 for the kernels' plain versions (the
    reference's ``ref.py``), the value dtype for the model's naive path (the
    reference's ``_gqa_out``).  The output is in q's dtype."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    qg = q.reshape(B, Sq, KVH, H // KVH, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * (D ** -0.5)
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(probs_dtype), v.to(probs_dtype))
    return o.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0):
    """The plain PyTorch version, on any device: the masked softmax in
    float32 over materialised scores (the function of the reference's
    ``ref.flash_attention_ref``; with ``q_offset`` its rows from that
    position on)."""
    mask = attention_mask(q.shape[1], k.shape[1], q_offset, 0, causal, window, q.device)
    return masked_attention(q, k, v, mask)


def _check_args(q, k, v, window, q_offset=0):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be [B,Sq,H,D] and k/v [B,Sk,KVH,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, KVH, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [B={B}, Sk, KVH, D={D}] alike; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(B, Sq, Sk, KVH) < 1 or H % KVH:
        raise ValueError(f"need B, Sq, Sk >= 1 and H % KVH == 0; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0; got {q_offset}")


def _tma_strides(t):
    """The strides (elements) of dims 0-2 as the kernel's tensor maps take
    them: a dimension of size 1 is never stepped over, so its stride is
    replaced by the head dim's, which every accepted layout aligns."""
    return [st if n != 1 else t.shape[-1] for n, st in zip(t.shape[:3], t.stride()[:3])]


def kernel_width(D: int) -> int:
    """The width both attention kernels run head dim ``D`` at: a multiple of
    16 from 16 to 128 runs at the next instantiated width (16, 32, 64 or
    128; 48 at 64, 80, 96 and 112 at 128), whose columns past D the kernels
    read as zeros and never write; 256 at its own kernel's.  Raise
    ``ValueError``, naming the head dims the kernels take, for any other
    (checked before every launch; runs anywhere, so the CPU tests hold it)."""
    D = int(D)
    if D == 256:
        return 256
    if D % 16 == 0 and 16 <= D <= _WIDTHS[-1]:
        return next(w for w in _WIDTHS if w >= D)
    raise ValueError(f"the kernels take head dims that are multiples of 16 from 16 to 128, "
                     f"and 256; got {D}")


def check_kernel_layout(q, k, v):
    """Raise ``ValueError`` unless the kernel takes these tensors as laid
    out (checked before every launch; runs on tensors on any device): a
    head dim :func:`kernel_width` takes, a contiguous last dimension, k and
    v with equal strides, and what the kernel's TMA copies need: every base
    address 16-byte aligned and every other stride a positive multiple of 16
    bytes."""
    kernel_width(q.shape[-1])
    if q.stride(-1) != 1 or k.stride(-1) != 1 or k.stride() != v.stride():
        raise ValueError("the kernel needs a contiguous last dimension, and k and v "
                         "with equal strides")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"TMA needs 16-byte-aligned tensors; {name} starts at an address "
                             f"{t.data_ptr() % 16} bytes past a multiple of 16")
        bad = [st for st in _tma_strides(t) if st <= 0 or (st * t.element_size()) % 16]
        if bad:
            raise ValueError(f"TMA needs strides that are positive multiples of 16 bytes; {name} "
                             f"has strides {tuple(t.stride())} of {t.element_size()}-byte "
                             f"elements")


def workspace_bytes(B, KVH, Sk, D, dtype, tile) -> int:
    """Bytes of scratch a kernel call needs: float32 at head dim 256 splits K
    and V into TF32 hi and lo halves once a call, ``tile`` keys at a time
    (the kernel's kv tile, ``repro_flash_attention_split_tile()``), each key
    as 4 x D float32 (K_hi, K_lo, V^T_hi, V^T_lo) and the keys padded to
    whole tiles; every other call needs none."""
    if D != 256 or dtype != torch.float32:
        return 0
    return B * KVH * -(-Sk // tile) * tile * 4 * D * 4


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """q ``[B,Sq,H,D]``, k/v ``[B,Sk,KVH,D]`` -> ``[B,Sq,H,D]``: the CUDA
    kernel for tensors on the card, :func:`flash_attention_plain` for
    tensors on the CPU; q's rows from key position ``q_offset`` on.
    ``flash_attention.launches`` counts kernel launches."""
    q_offset = int(q_offset)
    _check_args(q, k, v, window, q_offset)
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors; got {q.device}")
    check_kernel_layout(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    lib = library()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    nbytes = workspace_bytes(B, KVH, Sk, D, q.dtype, lib.repro_flash_attention_split_tile())
    ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if ws is None else ws.data_ptr(), nbytes, B, H, KVH, Sq, Sk, D,
            int(q.dtype == torch.bfloat16), *_tma_strides(q), *_tma_strides(k),
            *o.stride()[:3], int(bool(causal)), int(window), q_offset, ctypes.c_float(D ** -0.5),
            stream)
    check(code, "flash_attention launch")
    count_launch(flash_attention)
    return o


flash_attention.launches = 0
