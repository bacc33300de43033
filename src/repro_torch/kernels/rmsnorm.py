"""RMSNorm over the last dimension: ``x · rsqrt(mean(x²) + eps) · w``, with
float32 accumulation and the output in x's dtype.

The port of the Pallas kernel ``rmsnorm_kernel`` / ``rmsnorm_call``
(``repro/kernels/rmsnorm.py``) and of its wrapper ``ops.rms_norm``; the
reference's ``block_rows`` is TPU tiling and has no counterpart.
:func:`rms_norm` launches the hand-written CUDA kernel
(``csrc/rmsnorm.cu``, one block per row) for tensors on the card and runs
:func:`rms_norm_plain` for tensors on the CPU; it never falls back from one
to the other.

Shapes: x ``[..., D]`` in float32 or bfloat16, w ``[D]`` (taken in
float32).  No model of the port calls it yet: the models' norms are
``models.layers.rms_norm``, as the reference's models call theirs.
"""

from __future__ import annotations

import torch

from .build import check, library

__all__ = ["rms_norm", "rms_norm_plain"]

_DTYPES = (torch.float32, torch.bfloat16)


def rms_norm_plain(x, w, *, eps: float = 1e-5):
    """The plain PyTorch version, on any device: the reference oracle's
    formula (``ref.rms_norm_ref``) in float32, cast back to x's dtype."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def _check_args(x, w):
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must be [..., D] with D >= 1; got {tuple(x.shape)}")
    if tuple(w.shape) != (x.shape[-1],):
        raise ValueError(f"w must be [D={x.shape[-1]}]; got {tuple(w.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    if x.device != w.device:
        raise ValueError("x and w must lie on one device")


def rms_norm(x, w, *, eps: float = 1e-5):
    """x ``[..., D]``, w ``[D]`` -> the normalised x: the CUDA kernel for
    tensors on the card, :func:`rms_norm_plain` for tensors on the CPU.
    ``rms_norm.launches`` counts kernel launches."""
    _check_args(x, w)
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu tensors; got {x.device}")
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    if x2.shape[0] == 0:
        return torch.empty_like(x)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    wf = w.float().contiguous()
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_rms_norm(
            x2.data_ptr(), wf.data_ptr(), out.data_ptr(), x2.shape[0], D, x2.stride(0),
            out.stride(0), int(x.dtype == torch.bfloat16), float(eps), stream)
    check(code, "rms_norm launch")
    rms_norm.launches += 1
    return out.reshape(x.shape)


rms_norm.launches = 0
