"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060).

The port of the reference's ``models/ssm.py``.  Selective state space per
head h (state size N, head dim P):

    s_t = a_t * s_{t-1} + (dt_t * x_t) B_t^T        s in R^{P x N}
    y_t = s_t C_t + D_h x_t                         a_t = exp(dt_t * A_h)

Evaluators of the prefill, selected by ``mamba_mixer``'s ``impl``:
  * ``"reference"`` — :func:`ssd_reference`, step by step over time (the
    oracle);
  * ``"chunked"``   — :func:`ssd_chunked`, the SSD block decomposition in
    plain PyTorch;
  * ``"cuda"``      — the hand-written kernel
    (:func:`repro_torch.kernels.ssd_scan`), where the reference dispatches
    its Pallas kernel (``"pallas"``).

Plus :func:`ssd_decode_step` (the O(1) state update for serving) and the
full mixer with its causal depthwise conv and gating.  The decode step
writes the conv window and the state into the cache in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.config import ArchConfig
from repro_torch.convert import resolve_device
from .layers import Initializer, rms_norm

__all__ = [
    "init_mamba",
    "mamba_mixer",
    "mamba_decode_step",
    "ssd_reference",
    "ssd_chunked",
    "ssd_decode_step",
    "init_mamba_cache",
]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_reference(x, dt, A, B, C, D):
    """Oracle: sequential scan over time.

    x [b,s,h,p], dt [b,s,h], A [h], B/C [b,s,g,n] (g broadcast over heads),
    D [h].  Returns y [b,s,h,p].
    """
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    f32 = torch.float32
    Bh = B.repeat_interleave(rep, dim=2).to(f32)  # [b,s,h,n]
    Ch = C.repeat_interleave(rep, dim=2).to(f32)
    a = torch.exp(dt * A[None, None, :]).to(f32)  # [b,s,h]
    xbar = (x * dt[..., None]).to(f32)  # [b,s,h,p]
    state = torch.zeros((b, h, p, B.shape[-1]), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        state = state * a[:, t, :, None, None] + xbar[:, t, :, :, None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    return (y + x.to(f32) * D[None, None, :, None]).to(x.dtype)


def _segsum(logd):
    """[..., L] -> [..., L, L] lower-triangular cumulative log-decay:
    seg[i, j] = cum[i] - cum[j]  (the decay from emitting step j to step i)."""
    L = logd.shape[-1]
    cum = torch.cumsum(logd, dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool, device=logd.device).tril()
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(x, dt, A, B, C, D, chunk: int = 64):
    """SSD block decomposition (matmul form + inter-chunk state scan)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32

    Bh = B.repeat_interleave(rep, dim=2).to(f32).reshape(b, nc, chunk, h, n)
    Ch = C.repeat_interleave(rep, dim=2).to(f32).reshape(b, nc, chunk, h, n)
    xbar = (x * dt[..., None]).to(f32).reshape(b, nc, chunk, h, p)
    logd = (dt * A[None, None, :]).to(f32).reshape(b, nc, chunk, h)  # log decay per step

    # --- intra-chunk (quadratic, matmul-friendly) ---
    seg = _segsum(logd.transpose(-1, -2))  # [b,nc,h,L,L]
    Ldec = torch.exp(seg)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)  # [b,nc,h,L,S]
    y_intra = torch.einsum("bchls,bcshp->bclhp", scores * Ldec, xbar)

    # --- chunk states ---
    cum = torch.cumsum(logd.transpose(-1, -2), dim=-1)  # [b,nc,h,L]
    total = cum[..., -1]  # [b,nc,h]
    decay_to_end = torch.exp(total[..., None] - cum)  # [b,nc,h,L]
    states = torch.einsum("bchl,bclhn,bclhp->bchpn", decay_to_end, Bh, xbar)  # [b,nc,h,p,n]

    # --- inter-chunk recurrence over chunk states (the state *entering* each chunk) ---
    carry = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(total[:, c])[..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # [b,nc,h,p,n]

    # --- inter-chunk contribution ---
    in_decay = torch.exp(cum)  # decay from chunk start to position l (inclusive)
    y_inter = torch.einsum("bchl,bclhn,bchpn->bclhp", in_decay, Ch, prev_states)

    y = (y_intra + y_inter).reshape(b, s, h, p)
    return (y + x.to(f32) * D[None, None, :, None]).to(x.dtype)


def ssd_decode_step(state, x, dt, A, B, C, D):
    """One-token state update: state [b,h,p,n] fp32; x [b,h,p]; dt [b,h];
    B/C [b,g,n].  Returns (new_state, y [b,h,p])."""
    rep = x.shape[1] // B.shape[1]
    f32 = torch.float32
    Bh = B.repeat_interleave(rep, dim=1).to(f32)
    Ch = C.repeat_interleave(rep, dim=1).to(f32)
    a = torch.exp(dt * A[None, :]).to(f32)  # [b,h]
    xbar = (x * dt[..., None]).to(f32)
    state = state * a[..., None, None] + xbar[..., :, None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + x.to(f32) * D[None, :, None]
    return state, y.to(x.dtype)


# ---------------------------------------------------------------------------
# full mixer (in_proj -> conv -> SSD -> gate -> out_proj)
# ---------------------------------------------------------------------------


def init_mamba(init: Initializer, cfg: ArchConfig):
    ssm = cfg.ssm
    d = cfg.d_model
    d_in = ssm.d_inner(d)
    h = ssm.n_heads(d)
    n = ssm.d_state
    g = 1  # single B/C group (Mamba-2 default ngroups=1)
    conv_dim = d_in + 2 * g * n
    return {
        "w_z": init.normal((d, d_in)),
        "w_xbc": init.normal((d, conv_dim)),
        "w_dt": init.normal((d, h)),
        "conv_w": init.normal((ssm.d_conv, conv_dim), scale=0.2),
        # not drawn from the seed: A = -1 .. -16 over the heads
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=init.device)),
        "D": init.ones((h,), dtype=torch.float32),
        "dt_bias": init.zeros((h,), dtype=torch.float32),
        "norm_w": init.ones((d_in,)),
        "w_out": init.normal((d_in, d)),
    }


def _in_proj(p, x, cfg: ArchConfig):
    ssm = cfg.ssm
    d_in = ssm.d_inner(cfg.d_model)
    h = ssm.n_heads(cfg.d_model)
    return x @ p.w_z, x @ p.w_xbc, x @ p.w_dt, d_in, h, ssm.d_state, 1


def _causal_conv(xbc, conv_w, state=None):
    """Depthwise causal conv along seq: xbc [b,s,c], conv_w [k,c].  Returns
    (silu(out), the last k-1 inputs: the next call's ``state``)."""
    k = conv_w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    out = sum(xp[:, i: i + xbc.shape[1], :] * conv_w[i][None, None, :] for i in range(k))
    return F.silu(out), new_state


def _ssm_inputs(p, xbc, dt, d_in, h, n, g, head_dim):
    """Split the conv output into x, B, C (views, no copies) and take dt
    through the softplus: x [..., h, p], B/C [..., g, n], dt [..., h]."""
    lead = xbc.shape[:-1]
    xs, B, C = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)
    return (xs.reshape(*lead, h, head_dim), B.reshape(*lead, g, n), C.reshape(*lead, g, n),
            dt, -torch.exp(p.A_log))


def mamba_mixer(p, x, cfg: ArchConfig, impl: str = "chunked"):
    """x [b,s,d] -> [b,s,d]; ``impl`` is ``"reference"``, ``"chunked"`` or
    ``"cuda"``."""
    ssm = cfg.ssm
    z, xbc, dt, d_in, h, n, g = _in_proj(p, x, cfg)
    xbc, _ = _causal_conv(xbc, p.conv_w)
    xs, B, C, dt, A = _ssm_inputs(p, xbc, dt, d_in, h, n, g, ssm.head_dim)
    b, s, _ = x.shape
    if impl == "reference":
        y = ssd_reference(xs, dt, A, B, C, p.D)
    elif impl == "cuda":
        y = kernels.ssd_scan(xs, dt, A, B, C, p.D, chunk=ssm.chunk)
    elif impl == "chunked":
        y = ssd_chunked(xs, dt, A, B, C, p.D, chunk=min(ssm.chunk, s))
    else:
        raise ValueError(impl)
    y = y.reshape(b, s, d_in)
    y = rms_norm(y * F.silu(z), p.norm_w, cfg.norm_eps)
    return y @ p.w_out


def init_mamba_cache(cfg: ArchConfig, layers: int, batch: int, dtype=torch.bfloat16,
                     device=None):
    """Zeroed caches of ``layers`` layers: the conv window [layers, b,
    d_conv - 1, conv_dim] in ``dtype`` and the state [layers, b, h, p, n] in
    float32 (the reference's per-layer cache, stacked).  ``device=None``
    is the card, as everywhere in the port; ``torch.device("meta")`` gives
    the shapes alone (:func:`repro_torch.models.cache_shapes`)."""
    if not (isinstance(device, torch.device) and device.type == "meta"):
        device = resolve_device(device)
    ssm = cfg.ssm
    d_in = ssm.d_inner(cfg.d_model)
    h = ssm.n_heads(cfg.d_model)
    conv_dim = d_in + 2 * ssm.d_state
    return {
        "conv": torch.zeros((layers, batch, ssm.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((layers, batch, h, ssm.head_dim, ssm.d_state), dtype=torch.float32,
                             device=device),
    }


def mamba_decode_step(p, x, cache, cfg: ArchConfig):
    """x [b,1,d]; cache {conv, state} (this layer's) -> out [b,1,d].  The
    cache's conv window and state are written in place."""
    ssm = cfg.ssm
    z, xbc, dt, d_in, h, n, g = _in_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(xbc, p.conv_w, state=cache["conv"])
    xs, B, C, dtv, A = _ssm_inputs(p, xbc[:, 0], dt[:, 0], d_in, h, n, g, ssm.head_dim)
    state, y = ssd_decode_step(cache["state"], xs, dtv, A, B, C, p.D)
    cache["conv"].copy_(conv_state)
    cache["state"].copy_(state)
    y = y.reshape(x.shape[0], 1, d_in)
    y = rms_norm(y * F.silu(z), p.norm_w, cfg.norm_eps)
    return y @ p.w_out
