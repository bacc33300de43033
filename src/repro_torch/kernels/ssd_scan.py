"""Mamba-2 SSD chunked scan: per (batch, head), with a ``[P, N]`` state,
``s_t = exp(dt_t A) s_{t-1} + (dt_t x_t) B_tᵀ`` and ``y_t = s_t C_t + D x_t``.

The port of the Pallas kernel ``ssd_scan_kernel`` / ``ssd_scan_call``
(``repro/kernels/ssd_scan.py``) and of its wrapper ``ops.ssd_scan``.
:func:`ssd_scan` launches the hand-written CUDA kernels (``csrc/ssd_scan.cu``:
each chunk's state contribution and the group's scores C Bᵀ, the state passed
across chunks, the output; products as split TF32 on the tensor cores) for
tensors on the card and runs :func:`ssd_scan_plain` for tensors on the CPU;
it never falls back from one to the other.

Shapes: x ``[B, S, H, P]``, dt ``[B, S, H]`` (after the softplus), A and D
``[H]``, B and C ``[B, S, G, N]`` with ``H % G == 0`` (head ``h`` reads group
``h // (H // G)``).  x, B and C share float32 or bfloat16; dt, A and D are
taken in float32; y ``[B, S, H, P]`` in x's dtype.  The kernels read x, dt,
B and C through their strides, so slices of one tensor need no copies, and
take dt A <= 0 (dt after the softplus, A = -exp(A_log), as in the models):
they evaluate a decay factor off the diagonal tile as a product of two
factors that are then at most 1.

Both versions compute the chunked dual form at the chunk ``L`` (the largest
divisor of S that is at most ``chunk``, as ``ops._pick_block``): within a
chunk the quadratic form over the visible pairs, across chunks the carried
state.  The kernels take every shape the reference's kernel takes up to a
head dim and state size of 256 (:func:`kernel_size`), any chunk and any
count of chunks.  The cumulative log-decay is summed in float64 and each
decay factor is evaluated in float64 and rounded once to float32: at the
models' widths the decay within a chunk reaches ~-3,400, where a float32
cumsum is off by ~1e-4 and its value depends on the order of the sum (see
the CUDA source).
"""

from __future__ import annotations

import torch

from .build import check, count_launch, library, refuse_grad

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_scan_tolerance", "pick_chunk", "kernel_size",
           "KERNEL_SIZES"]

KERNEL_SIZES = (16, 32, 64, 128, 256)  # the instantiated head dims P and state sizes N
_DTYPES = (torch.float32, torch.bfloat16)


def kernel_size(n: int, what: str = "head dims and state sizes") -> int:
    """The instantiated size a head dim P or state size N runs at: the next
    of :data:`KERNEL_SIZES` (48 at 64, 80 at 128, 200 at 256), whose columns
    past ``n`` the kernels read as zeros and never write.  Raise
    ``ValueError`` above 256 (checked before every launch; runs anywhere,
    so the CPU tests hold it)."""
    n = int(n)
    if 1 <= n <= KERNEL_SIZES[-1]:
        return next(w for w in KERNEL_SIZES if w >= n)
    raise ValueError(f"the kernels take {what} from 1 to {KERNEL_SIZES[-1]}; got {n}")


def pick_chunk(seq_len: int, chunk: int) -> int:
    """Largest divisor of ``seq_len`` that is at most ``chunk`` (the
    reference's ``ops._pick_block``)."""
    b = min(chunk, seq_len)
    while seq_len % b:
        b -= 1
    return b


def ssd_scan_plain(x, dt, A, B, C, D, *, chunk: int):
    """The plain PyTorch version, on any device: the chunked dual form in
    float32 at chunk ``chunk`` (which must divide S), B and C taken
    group-wise (never repeated across heads).  The carried term of the first
    chunk (a zero state) and the state update after the last chunk (read by
    nothing) are not computed."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg, L = h // g, chunk
    if s % L:
        raise ValueError(f"chunk {L} does not divide the sequence length {s}")
    nc = s // L
    f32 = torch.float32
    xg = x.to(f32).reshape(b, nc, L, g, hpg, p)
    dtg = dt.to(f32).reshape(b, nc, L, g, hpg)
    Bg = B.to(f32).reshape(b, nc, L, g, n)
    Cg = C.to(f32).reshape(b, nc, L, g, n)
    xbar = xg * dtg[..., None]                                    # [b,c,L,g,e,p]
    logd = dtg * A.to(f32).reshape(g, hpg)                        # float32 products
    cum = torch.cumsum(logd.double().permute(0, 1, 3, 4, 2), dim=-1)  # [b,c,g,e,L] f64

    # within a chunk: y_l = sum_{s<=l} (C_l . B_s) exp(cum_l - cum_s) xbar_s
    seg = cum[..., :, None] - cum[..., None, :]                   # [b,c,g,e,L,L] f64
    visible = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    dec = torch.where(visible, torch.exp(seg).to(f32), 0.0)
    scores = torch.einsum("bclgn,bcsgn->bcgls", Cg, Bg)          # shared by a group's heads
    y = torch.einsum("bcgels,bcsgep->bclgep", scores[:, :, :, None] * dec, xbar)

    # across chunks: the state entering chunk c, emitted through C
    total = cum[..., -1]                                          # [b,c,g,e]
    in_decay = torch.exp(cum).to(f32)                             # [b,c,g,e,L]
    to_end = torch.exp(total[..., None] - cum).to(f32)            # [b,c,g,e,L]
    state = None
    inter = []
    for c in range(nc):
        if state is None:
            inter.append(torch.zeros_like(y[:, c]))
        else:
            dot = torch.einsum("blgn,bgepn->bgelp", Cg[:, c], state)
            inter.append((in_decay[:, c, ..., None] * dot).permute(0, 3, 1, 2, 4))
        if c < nc - 1:
            xw = xbar[:, c] * to_end[:, c].permute(0, 3, 1, 2)[..., None]  # [b,L,g,e,p]
            upd = torch.einsum("blgep,blgn->bgepn", xw, Bg[:, c])
            et = torch.exp(total[:, c]).to(f32)[..., None, None]
            state = upd if state is None else state * et + upd
    y = y + torch.stack(inter, dim=1)
    out = y.reshape(b, s, h, p) + x.to(f32) * D.to(f32)[None, None, :, None]
    return out.to(x.dtype)


def ssd_scan_tolerance(x, dt, A, B, C, D, *, chunk: int):
    """The per-element bound, on any device, that the kernel's output is
    held to against :func:`ssd_scan_plain` on the same inputs (chunk as
    :func:`ssd_scan` takes it; dt >= 0, as after the softplus).

    Both evaluate the same sums of products, in different orders, with
    decay factors equal to within one rounding.  A float32 evaluation whose
    longest chain of roundings has length m is off by at most
    gamma_m = m u / (1 - m u) (u = 2^-24) times the sum of the terms' moduli,
    so two such evaluations differ by at most 2 gamma_m of it.  That sum is
    the plain version on |x|, |B|, |C|, |D| (itself within gamma_m).  m = N +
    L + nc (L + 10) + 8 counts the dot over N, the sum over a chunk's L
    columns, the state's chain across the nc chunks (per chunk a sum over L,
    three products, an add and two decay factors) and the final product and
    add, each decay factor as three roundings.

    The kernel takes its four products (C Bᵀ and C s over N; the decayed
    scores times xbar and xbar Bᵀ over L) on the tensor cores as split
    TF32, which adds its own term.  A float32 a is split as hi = tf32(a),
    lo = tf32(a - hi) (tf32: round to 10 mantissa bits), so
    |a - hi - lo| <= 2^-22 |a| and |hi| <= (1 + 2^-11) |a|; a product a b
    becomes lo_a hi_b + hi_a lo_b + hi_a hi_b, each exact in float32,
    dropping lo_a lo_b and the two halves' residues: at most
    3 2^-22 (1 + 2^-11) |a b| < 13 u |a b|.  An mma adds its 8 products and
    the accumulator in float32 and may truncate where a float32 add rounds:
    at most 2 u of the moduli for each of the 9 terms, and three mmas (one
    per partial product) per 8 of depth, 6.75 u per unit of depth.  So a
    dot of depth K is off by at most (13 + 6.75 K) u of its terms' moduli
    (bounding all of it anew, not only its excess over the K u the float32
    chain counts).  Every term of y passes through one product over N and
    one over L (the carried state's other products and the chain across
    chunks are float32, counted in m), so the kernel adds at most
    e = (26 + 6.75 (N + L)) u of the moduli' sum, and the bound is
    (2 gamma_m + e) (1 + gamma_m) of it.  A bfloat16 output is rounded once
    more on each side: 2^-8 of the sum."""
    L = pick_chunk(x.shape[1], chunk)
    nc, n = x.shape[1] // L, B.shape[-1]
    u = 2.0 ** -24
    m = n + L + nc * (L + 10) + 8
    gamma = m * u / (1 - m * u)
    split = (26 + 6.75 * (n + L)) * u
    mag = ssd_scan_plain(x.abs(), dt.float(), A.float(), B.abs(), C.abs(), D.float().abs(),
                         chunk=L).float()
    tol = (2 * gamma + split) * (1 + gamma) * mag
    return tol + 2.0 ** -8 * mag if x.dtype == torch.bfloat16 else tol


def _check_args(x, dt, A, B, C, D):
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x must be [B,S,H,P] and B/C [B,S,G,N]; got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    b, s, h, _ = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(B.shape) != (b, s, g, n) or C.shape != B.shape:
        raise ValueError(f"B and C must be [B={b}, S={s}, G, N] alike; got {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or tuple(D.shape) != (h,):
        raise ValueError(f"dt must be [{b}, {s}, {h}] and A, D [{h}]; got {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(D.shape)}")
    if min(b, s, h, g) < 1 or h % g:
        raise ValueError(f"need B, S, H, G >= 1 and H % G == 0; got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must share float32 or bfloat16; got {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if len({t.device for t in (x, dt, A, B, C, D)}) != 1:
        raise ValueError("x, dt, A, B, C and D must lie on one device")


def ssd_scan(x, dt, A, B, C, D, *, chunk=64):
    """x ``[B,S,H,P]``, dt ``[B,S,H]``, A/D ``[H]``, B/C ``[B,S,G,N]`` ->
    y ``[B,S,H,P]``: the CUDA kernels for tensors on the card,
    :func:`ssd_scan_plain` for tensors on the CPU, at the chunk
    :func:`pick_chunk` gives.  ``ssd_scan.launches`` counts the calls that
    launched the kernels (one a call, however many kernels it enqueues)."""
    _check_args(x, dt, A, B, C, D)
    refuse_grad("ssd_scan", x, dt, A, B, C, D)
    L = pick_chunk(x.shape[1], chunk)
    dt, A, D = dt.float(), A.float().contiguous(), D.float().contiguous()
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=L)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors; got {x.device}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    kernel_size(p, "head dims P")
    kernel_size(n, "state sizes N")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("the kernel needs x, B and C with a contiguous last dimension")
    lib = library()
    n_ws = lib.repro_ssd_scan_workspace(b, s, h, g, p, n, L)
    if n_ws < 0:
        raise ValueError(f"the kernel does not take x {tuple(x.shape)}, B {tuple(B.shape)} at "
                         f"chunk {L}")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    # the scores, each chunk's decay and the states between chunks
    ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), y.data_ptr(), ws.data_ptr(), b, s, h, g, p, n, L,
            int(x.dtype == torch.bfloat16),
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3], *y.stride()[:3],
            stream)
    check(code, "ssd_scan launch")
    count_launch(ssd_scan)
    return y


ssd_scan.launches = 0
