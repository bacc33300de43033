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

On a model axis wider than 1 (``x`` a DTensor replicated there, the
weights sharded by :mod:`repro_torch.runtime.sharding`) the mixer takes the
reference's layout: ``w_z`` and ``w_xbc`` column-sharded (z on d_inner, the
conv inputs on their channels), so the depthwise conv runs on each rank's
own channels; x, B and C are cut out of the conv output gathered whole
(its shard boundaries do not fall on d_inner, and B and C are every
head's); the scan runs on each rank's own heads (``xs`` heads over 'model',
the reference's constraint), with ``w_dt``, ``A_log``, ``D`` and ``dt_bias``
replicated and each rank taking its heads' entries; the gated norm's mean
square is summed over the ranks, and the row-sharded ``w_out`` makes the
output a partial sum, all-reduced at the block's constraint (the
reference's, ``ssm.py:222``; a hybrid block reduces its two branches' sum
once).  The scan is
the one the policy names (``"chunked"``, ``"reference"``, or under
``"cuda"`` the kernel on the rank's part: its heads, or its strided
head-dim columns of every head, which the kernel reads through their
strides as laid out).

A head count the axis does not divide (hymba-1.5b's 50 heads over 4 or
16 ranks) shards the head dim instead, in the scan and in the decode state
alike, as the reference's ``cache_specs`` does for the state: every rank
runs every head on its ``head_dim / ranks`` columns of it (the scan is
independent per column), where DTensor's uneven split of the heads (13,
13, 13, 11) would give the ranks unequal work and the decode state a
layout the reference does not use.  The decode step keeps each rank's
shard of the conv window [B, k-1, C] (channels over 'model') and of the
float32 state [B, H, P, N] (heads, or head-dim columns, over 'model') and
writes them in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


def _ssm_inputs(p, xbc, dt, d_in, h, n, g, head_dim, own=(slice(None), slice(None))):
    """Split the conv output into x, B, C (views, no copies) and take dt
    through the softplus: x [..., h, p], B/C [..., g, n], dt [..., h].
    ``own``: the heads and head-dim columns to keep (a rank's, on a model
    axis: :func:`_own`)."""
    lead = xbc.shape[:-1]
    heads, cols = own
    xs, B, C = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float()[..., heads] + _whole(p.dt_bias)[heads])
    return (xs.reshape(*lead, h, head_dim)[..., heads, cols], B.reshape(*lead, g, n),
            C.reshape(*lead, g, n), dt, -torch.exp(_whole(p.A_log)[heads]))


def _whole(t):
    """``t`` on this rank: a model-replicated DTensor's local copy, whose
    gradient is a partial sum over the ranks (each uses its own heads of
    it); else ``t``."""
    return t.to_local(grad_placements=[Partial()]) if isinstance(t, DTensor) else t


def _own(mesh, h: int, head_dim: int) -> tuple:
    """This rank's part of the scan on model mesh ``mesh``: ((heads,
    head-dim columns), the dim of [b, s, h, p] they shard).  Its ``h /
    ranks`` heads when the axis divides ``h``, else every head's ``head_dim
    / ranks`` columns (see the module doc)."""
    ranks, r = mesh.size(), mesh.get_local_rank()
    if h % ranks == 0:
        return (slice(r * h // ranks, (r + 1) * h // ranks), slice(None)), 2
    k = head_dim // ranks
    return (slice(None), slice(r * k, (r + 1) * k)), 3


def _scan_out(y, mesh, dim: int, b: int, s: int, h: int, head_dim: int):
    """A rank's scan output [b, s, h', p'] as the DTensor [b, s, d_inner]
    sharded on d_inner, as ``z`` is (a rank's heads are its d_inner
    columns; head-dim columns are gathered and cut again)."""
    d_in = h * head_dim
    if dim == 2:
        return DTensor.from_local(y.reshape(b, s, -1), mesh, [Shard(2)], run_check=False,
                                  shape=(b, s, d_in), stride=(s * d_in, d_in, 1))
    y = DTensor.from_local(y.contiguous(), mesh, [Shard(3)], run_check=False,
                           shape=(b, s, h, head_dim), stride=(s * d_in, d_in, head_dim, 1))
    y = y.redistribute(placements=[Replicate()]).reshape(b, s, d_in)
    return y.redistribute(placements=[Shard(2)])


def _scan(impl, xs, dt, A, B, C, D, chunk: int):
    if impl == "reference":
        return ssd_reference(xs, dt, A, B, C, D)
    if impl == "cuda":
        return kernels.ssd_scan(xs, dt, A, B, C, D, chunk=chunk)
    if impl == "chunked":
        return ssd_chunked(xs, dt, A, B, C, D, chunk=min(chunk, xs.shape[1]))
    raise ValueError(impl)


def _gate_out(p, y, z, cfg: ArchConfig):
    """The gated norm and the out-projection (on a model axis a partial
    sum over the ranks: the caller reduces it)."""
    return rms_norm(y * F.silu(z), p.norm_w, cfg.norm_eps) @ p.w_out


def mamba_mixer(p, x, cfg: ArchConfig, impl: str = "chunked"):
    """x [b,s,d] -> [b,s,d]; ``impl`` is ``"reference"``, ``"chunked"`` or
    ``"cuda"``.  On a model axis see the module doc: the output is a
    partial sum there; a sequence-sharded ``x`` (``sp_activations``) is
    gathered first: the conv and the scan run along the whole sequence."""
    ssm = cfg.ssm
    if isinstance(x, DTensor) and x.placements[0].is_shard(1):
        x = x.redistribute(placements=[Replicate()])
    z, xbc, dt, d_in, h, n, g = _in_proj(p, x, cfg)
    b, s, _ = x.shape
    if not isinstance(xbc, DTensor):
        xbc, _ = _causal_conv(xbc, p.conv_w)
        xs, B, C, dt, A = _ssm_inputs(p, xbc, dt, d_in, h, n, g, ssm.head_dim)
        y = _scan(impl, xs, dt, A, B, C, p.D, ssm.chunk).reshape(b, s, d_in)
        return _gate_out(p, y, z, cfg)
    mesh = xbc.device_mesh
    conv, _ = _causal_conv(xbc.to_local(), p.conv_w.to_local())  # each rank its channels
    conv = DTensor.from_local(conv, mesh, [Shard(2)], run_check=False, shape=xbc.shape,
                              stride=xbc.stride())
    own, dim = _own(mesh, h, ssm.head_dim)
    whole = conv.redistribute(placements=[Replicate()]).to_local(grad_placements=[Partial()])
    xs, B, C, dt, A = _ssm_inputs(p, whole, _whole(dt), d_in, h, n, g, ssm.head_dim, own)
    y = _scan(impl, xs, dt, A, B, C, _whole(p.D)[own[0]], ssm.chunk)
    return _gate_out(p, _scan_out(y, mesh, dim, b, s, h, ssm.head_dim), z, cfg)


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
    cache's conv window and state are written in place (on a model axis
    each rank's shards of them, and the output a partial sum: see the
    module doc)."""
    ssm = cfg.ssm
    z, xbc, dt, d_in, h, n, g = _in_proj(p, x, cfg)
    b = x.shape[0]
    if not isinstance(xbc, DTensor):
        xbc, conv_state = _causal_conv(xbc, p.conv_w, state=cache["conv"])
        xs, B, C, dtv, A = _ssm_inputs(p, xbc[:, 0], dt[:, 0], d_in, h, n, g, ssm.head_dim)
        state, y = ssd_decode_step(cache["state"], xs, dtv, A, B, C, p.D)
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(state)
        return _gate_out(p, y.reshape(b, 1, d_in), z, cfg)
    mesh = xbc.device_mesh
    window, state = cache["conv"].to_local(), cache["state"].to_local()
    conv, new_window = _causal_conv(xbc.to_local(), p.conv_w.to_local(), state=window)
    window.copy_(new_window)
    own, dim = _own(mesh, h, ssm.head_dim)
    whole = DTensor.from_local(conv[:, 0], mesh, [Shard(1)], run_check=False).full_tensor()
    xs, B, C, dtv, A = _ssm_inputs(p, whole, _whole(dt)[:, 0], d_in, h, n, g, ssm.head_dim, own)
    new_state, y = ssd_decode_step(state, xs, dtv, A, B, C, _whole(p.D)[own[0]])
    state.copy_(new_state)
    return _gate_out(p, _scan_out(y[:, None], mesh, dim, b, 1, h, ssm.head_dim), z, cfg)
