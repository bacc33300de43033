"""Gradient compression for the gradient exchange across the slow (pod)
axis.

The port of the reference's ``optim/compress.py``.  Two schemes:
  * int8 linear quantization with a per-tensor scale (4x fewer bytes on
    the all-reduce);
  * top-k sparsification with error feedback (Stich et al.): the residual
    carries the unsent mass, so the descent direction is unbiased over time.

No train path calls these, in the port or in the reference: the
reference's chain trainer (``runtime/dlt_runner.py``) sums its gradients
with a plain ``psum``, and the port's with a plain ``all_reduce``.  Trees
are flat mappings of names to tensors, as in
:mod:`repro_torch.optim.adamw`.
"""

from __future__ import annotations

import dataclasses

import torch

from .adamw import named_leaves

__all__ = [
    "int8_compress",
    "int8_decompress",
    "CompressorState",
    "topk_compress_init",
    "topk_compress_update",
]


def int8_compress(x):
    """x float -> (int8 values, float32 scale)."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q, scale):
    return q.float() * scale


@dataclasses.dataclass
class CompressorState:
    residual: dict  # error-feedback accumulator: name -> float32 tensor like the gradient


def topk_compress_init(grads) -> CompressorState:
    return CompressorState(residual={n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                                     for n, g in named_leaves(grads).items()})


def topk_compress_update(grads, state: CompressorState, k_frac: float = 0.05):
    """Returns (the gradients to send, the new state).

    The sent tensor is dense-shaped but zero outside the k largest |acc|
    entries; the threshold is the k-th largest |acc| and the mask ``>=`` it,
    so ties at the threshold are all sent, as the reference's
    ``jax.lax.top_k`` selection keeps them."""
    sent, new_res = {}, {}
    for name, g in named_leaves(grads).items():
        acc = state.residual[name] + g.float()
        flat = acc.reshape(-1)
        k = max(1, int(flat.shape[0] * k_frac))
        thresh = torch.topk(flat.abs(), k).values[-1]
        mask = (flat.abs() >= thresh).float()
        sent[name] = (flat * mask).reshape(g.shape)
        new_res[name] = (flat * (1 - mask)).reshape(g.shape)
    return sent, CompressorState(residual=new_res)
