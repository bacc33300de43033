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
q, k and v 16-byte aligned with strides that are multiples of 16 bytes,
which no layout of rows of ``D * sizeof(T)`` bytes has where that is no
multiple of 16 (bfloat16 at head dim 100): the wrapper copies q, k and v
of such a head dim into rows padded to 16 bytes (:func:`kernel_operands`)
and reads every other layout in place, refusing one TMA cannot read
(:func:`check_kernel_layout`).  Head dims: every D from 1 to 256
(:func:`kernel_width`, the rule the decode kernel shares); one that is not
an instantiated width runs the next one with its extra columns read as
zeros.

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
           "check_kernel_layout", "kernel_operands", "workspace_bytes", "kernel_width",
           "MAX_HEAD_DIM", "NEG_INF"]

NEG_INF = -1e30
_WIDTHS = (16, 32, 64, 128, 256)  # the instantiated widths of the kernels
# the widest head dim: shared memory holds the head-dim-256 geometries' tiles
# and no wider ones (ROADMAP B)
MAX_HEAD_DIM = _WIDTHS[-1]
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


def _row16(t) -> int:
    """The head dim in elements, rounded up to whole 16-byte units."""
    return -(-t.shape[-1] * t.element_size() // 16) * 16 // t.element_size()


def _tma_strides(t):
    """The strides (elements) of dims 0-2 as the kernel's tensor maps take
    them: a dimension of size 1 is never stepped over, so its stride is
    replaced by the head dim rounded up to 16 bytes, which TMA takes."""
    return [st if n != 1 else _row16(t) for n, st in zip(t.shape[:3], t.stride()[:3])]


def kernel_width(D: int) -> int:
    """The width both attention kernels run head dim ``D`` at: D from 1 to
    128 at the next instantiated width (16, 32, 64 or 128; 8 at 16, 48 at
    64, 72, 100 and 112 at 128), D from 129 to 256 at the head-dim-256
    kernels' (192, 200), whose columns past D the kernels read as zeros and
    never write.  Raise ``ValueError``, naming the head dims the kernels
    take, above :data:`MAX_HEAD_DIM` (checked before every launch; runs
    anywhere, so the CPU tests hold it)."""
    D = int(D)
    if 1 <= D <= MAX_HEAD_DIM:
        return next(w for w in _WIDTHS if w >= D)
    raise ValueError(f"the kernels take head dims from 1 to {MAX_HEAD_DIM} (shared memory holds "
                     f"the head-dim-256 kernels' tiles and no wider); got {D}")


def _needs_padding(t) -> bool:
    """Whether a row of ``t``'s head dim is no whole number of 16-byte
    units, so that no stride of a layout of such rows is one TMA takes."""
    return (t.shape[-1] * t.element_size()) % 16 != 0


def check_kernel_layout(q, k, v):
    """Raise ``ValueError`` unless the kernel takes these tensors (checked
    before every launch; runs on tensors on any device): a head dim
    :func:`kernel_width` takes and, unless its rows are no whole number of
    16-byte units (:func:`kernel_operands` copies those), a layout the
    kernel's TMA copies read in place: a contiguous last dimension, k and v
    with equal strides, every base address 16-byte aligned and every other
    stride a positive multiple of 16 bytes."""
    kernel_width(q.shape[-1])
    if _needs_padding(q):
        return
    if q.stride(-1) != 1 or k.stride(-1) != 1 or k.stride() != v.stride():
        raise ValueError("the kernel needs a contiguous last dimension, and k and v "
                         "with equal strides")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"TMA needs 16-byte-aligned tensors; {name} starts at an address "
                             f"{t.data_ptr() % 16} bytes past a multiple of 16")
        if any(st <= 0 or (st * t.element_size()) % 16 for st in _tma_strides(t)):
            raise ValueError(f"TMA needs strides that are positive multiples of 16 bytes; {name} "
                             f"has strides {tuple(t.stride())} of {t.element_size()}-byte "
                             f"elements")


def _padded(t):
    """A copy of ``t`` [B, S, H, D] whose rows are padded to whole 16-byte
    units (the view of its first D columns: the kernel's maps keep the
    extent D, so the pad is never read)."""
    buf = torch.empty((*t.shape[:3], _row16(t)), dtype=t.dtype, device=t.device)
    view = buf[..., :t.shape[-1]]
    view.copy_(t)
    return view


def kernel_operands(q, k, v):
    """q, k and v as the kernel reads them: copies with rows padded to 16
    bytes where a row of the head dim is no whole number of 16-byte units,
    else the tensors themselves.  Runs on tensors on any device."""
    if _needs_padding(q):
        return _padded(q), _padded(k), _padded(v)
    return q, k, v


def workspace_bytes(B, KVH, Sk, D, dtype, tile) -> int:
    """Bytes of scratch a kernel call needs: float32 at head dims from 129 to
    256 splits K and V into TF32 hi and lo halves once a call, ``tile`` keys
    at a time (the kernel's kv tile, ``repro_flash_attention_split_tile()``),
    each key as 4 x 256 float32 (K_hi, K_lo, V^T_hi, V^T_lo, zeros past D)
    and the keys padded to whole tiles; every other call needs none."""
    if not _WIDTHS[-2] < D <= MAX_HEAD_DIM or dtype != torch.float32:
        return 0
    return B * KVH * -(-Sk // tile) * tile * 4 * MAX_HEAD_DIM * 4


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
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    q, k, v = kernel_operands(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    lib = library()
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
