"""Shared model layers: norms, RoPE, gated MLPs and the seeded initializer.

The port of the reference's ``models/layers.py``.  Every function computes
in float32 inside and returns the input's dtype, as the reference does.
The reference's sharding helpers (``constrain``, the mesh context) are
no-ops on one card and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.convert import resolve_device

__all__ = ["Initializer", "rms_norm", "rope", "apply_rope", "init_glu_mlp", "glu_mlp",
           "cross_entropy"]


class Initializer:
    """Seeded parameter factory with the reference's fan-in scaling: a
    normal draw times ``fan_in ** -0.5`` (``fan_in`` is ``shape[-2]``) unless
    a scale is given.  Draws come from an explicit :class:`torch.Generator`
    on ``device`` (``None``: the card, raising without one), so they are not
    the reference's numbers; tests carry the reference's parameters across
    instead."""

    def __init__(self, seed: int, dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.dtype = dtype

    def normal(self, shape, scale=None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = (fan_in ** -0.5) if scale is None else scale
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return (x * scale).to(self.dtype)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, dtype=dtype or self.dtype, device=self.device)


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope(positions, head_dim: int, theta: float):
    """Rotary tables: positions [...] -> cos/sin [..., head_dim//2], fp32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin broadcastable [..., S, 1, D/2]."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_glu_mlp(init: Initializer, d_model: int, d_ff: int):
    return {
        "w_gate": init.normal((d_model, d_ff)),
        "w_up": init.normal((d_model, d_ff)),
        "w_down": init.normal((d_ff, d_model)),
    }


def glu_mlp(p, x, act: str = "swiglu"):
    """Gated MLP; ``p`` has ``w_gate``, ``w_up`` ``[d_model, d_ff]`` and
    ``w_down`` ``[d_ff, d_model]``."""
    g = x @ p.w_gate
    u = x @ p.w_up
    if act == "swiglu":
        h = F.silu(g) * u
    elif act == "geglu":
        h = F.gelu(g, approximate="tanh") * u  # jax.nn.gelu's default
    else:
        raise ValueError(act)
    return h @ p.w_down


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in float32; logits [..., V], labels int
    [...]: logsumexp minus the gold logit, averaged over the tokens, or over
    ``mask`` (a masked mean over ``max(mask.sum(), 1)``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
