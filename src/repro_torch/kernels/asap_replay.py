"""ASAP replay of a packed bucket: the chain or star recurrence of the serial
simulator for a whole batch of instances.

The port of the Pallas kernel ``make_asap_replay_kernel`` /
``asap_replay_call`` (``repro/kernels/asap_replay.py``).
:func:`asap_replay` launches the hand-written CUDA kernel
(``csrc/asap_replay.cu``) for tensors on the card and runs
:func:`asap_replay_plain` for tensors on the CPU; it never falls back from
one to the other.  Unlike the TPU kernel it also takes ``m == 1``.

The recurrence per cell ``t`` (identical to the serial simulator):

  chain forward:
    cs[i,t] = max(rel_t if i==0, ce[i-1,t], ce[i,t-1], ce[i+1,t-1], 0)
  star forward (one-port master; the carry crosses cell boundaries):
    cs[i,t] = max(rel_t, previous send end, 0)
  both:
    ce[i,t] = cs[i,t] + dcomm[i,t]
    ps[i,t] = max(tau_i | pe[i,t-1],  rel_t if i==0 else ce[i-1,t])
    pe[i,t] = ps[i,t] + dcomp[i,t]
  chain return (backward store-and-forward + per-link serialization):
    rs[i,t] = max(pe[i+1,t], re[i+1,t], re[i,t-1], 0)
  star return (serialized master receive port, carry crosses cells):
    rs[i,t] = max(pe[i+1,t], previous return end, 0)
  both: re[i,t] = rs[i,t] + dret[i,t]

Padded cells carry zero durations, their latency masked by ``valid``.
Inputs: w, gamma ``[B, m, T]``; z, latency ``[B, m-1]``; tau ``[B, m]``;
vcomm, vcomp, rel (and ret) ``[B, T]``; valid ``[T]``; all float64.
Returns the fixed 7-slot tuple ``(cs, ce, ps, pe, rs, re, mk)``, with
``rs``/``re`` None unless ``ret`` is given.  On the card the outputs are
views of one buffer, laid end to end in slot order, so
:func:`outputs_to_numpy` brings them back in one copy.
"""

from __future__ import annotations

import math

import torch

from .build import check, count_launch, library

__all__ = ["asap_replay", "asap_replay_plain", "outputs_to_numpy"]


def _volumes(gamma, star: bool):
    """Link volumes [B, m-1, T]: the worker's own fraction (star) or the
    suffix still to forward (chain), summed from the last processor up."""
    if star:
        return gamma[:, 1:, :]
    return torch.cumsum(gamma.flip(1), dim=1).flip(1)[:, 1:, :]


def asap_replay_plain(w, z, latency, tau, vcomm, vcomp, rel, valid, gamma,
                      ret=None, *, topology: str = "chain"):
    """The plain PyTorch version of the kernel, on any device: vectorized
    over the batch, Python loops over cells and links."""
    B, m, T = gamma.shape
    L = m - 1
    star = topology == "star"
    vol = _volumes(gamma, star)
    dcomm = (z[:, :, None] * vcomm[:, None, :] * vol + latency[:, :, None]) * valid
    dcomp = w * vcomp[:, None, :] * gamma
    new = dict(dtype=gamma.dtype, device=gamma.device)
    cs, ce = torch.zeros(B, L, T, **new), torch.zeros(B, L, T, **new)
    ps, pe = torch.zeros(B, m, T, **new), torch.zeros(B, m, T, **new)
    rs = re = None
    if ret is not None:
        dret = (z[:, :, None] * (ret * vcomm)[:, None, :] * vol
                + latency[:, :, None]) * valid
        rs, re = torch.zeros(B, L, T, **new), torch.zeros(B, L, T, **new)
    zero = torch.zeros(B, **new)
    last_send, last_ret = zero, zero
    for t in range(T):
        rel_t = rel[:, t]
        up_ce = zero
        for i in range(L):
            if star:
                lo = torch.maximum(torch.maximum(last_send, rel_t), zero)
            else:
                ready = ce[:, i, t - 1] if t > 0 else zero
                if t > 0 and i + 1 < L:
                    ready = torch.maximum(ready, ce[:, i + 1, t - 1])
                if i == 0:
                    ready = torch.maximum(ready, rel_t)
                lo = torch.maximum(torch.maximum(ready, zero if i == 0 else up_ce), zero)
            end = lo + dcomm[:, i, t]
            cs[:, i, t], ce[:, i, t] = lo, end
            last_send = up_ce = end
        for i in range(m):
            prev = pe[:, i, t - 1] if t > 0 else tau[:, i]
            recv = rel_t if i == 0 else ce[:, i - 1, t]
            s = torch.maximum(prev, recv)
            ps[:, i, t], pe[:, i, t] = s, s + dcomp[:, i, t]
        if ret is None:
            continue
        down_re = torch.full((B,), -torch.inf, **new)
        for j in range(L):
            i = j if star else L - 1 - j
            if star:
                lo = torch.maximum(torch.maximum(last_ret, pe[:, i + 1, t]), zero)
            else:
                prev_re = re[:, i, t - 1] if t > 0 else zero
                lo = torch.maximum(torch.maximum(pe[:, i + 1, t], prev_re), down_re)
                lo = torch.maximum(lo, zero)
            end = lo + dret[:, i, t]
            rs[:, i, t], re[:, i, t] = lo, end
            last_ret = down_re = end
    mk = pe[:, :, -1].amax(dim=1)
    if ret is not None:
        mk = torch.maximum(mk, torch.maximum(re.amax(dim=(1, 2)), zero))
    return cs, ce, ps, pe, rs, re, mk


def _check_args(w, z, latency, tau, vcomm, vcomp, rel, valid, gamma, ret, topology):
    if topology not in ("chain", "star"):
        raise ValueError(f"topology must be 'chain' or 'star'; got {topology!r}")
    if gamma.dim() != 3:
        raise ValueError(f"gamma must be [B, m, T]; got {tuple(gamma.shape)}")
    B, m, T = gamma.shape
    if m < 1 or T < 1:
        raise ValueError(f"a replay needs m >= 1 and T >= 1; got m={m}, T={T}")
    if ret is not None and m < 2:
        raise ValueError("the return phase needs at least one link (m >= 2)")
    shapes = {"w": (w, (B, m, T)), "z": (z, (B, m - 1)), "latency": (latency, (B, m - 1)),
              "tau": (tau, (B, m)), "vcomm": (vcomm, (B, T)), "vcomp": (vcomp, (B, T)),
              "rel": (rel, (B, T)), "valid": (valid, (T,)), "gamma": (gamma, (B, m, T))}
    if ret is not None:
        shapes["ret"] = (ret, (B, T))
    for name, (x, shape) in shapes.items():
        if x.dtype != torch.float64 or tuple(x.shape) != shape:
            raise TypeError(f"{name} must be float64 {shape}; got {x.dtype} {tuple(x.shape)}")
        if x.device != gamma.device:
            raise ValueError("all arguments must lie on one device")
        if not x.is_contiguous():
            raise ValueError(f"asap_replay needs contiguous tensors ({name} is not)")


def asap_replay(w, z, latency, tau, vcomm, vcomp, rel, valid, gamma, ret=None,
                *, topology: str = "chain"):
    """Replay a packed bucket: the CUDA kernel for tensors on the card,
    :func:`asap_replay_plain` for tensors on the CPU.
    ``asap_replay.launches`` counts kernel launches."""
    _check_args(w, z, latency, tau, vcomm, vcomp, rel, valid, gamma, ret, topology)
    args = (w, z, latency, tau, vcomm, vcomp, rel, valid, gamma, ret)
    if gamma.device.type == "cpu":
        return asap_replay_plain(*args, topology=topology)
    if gamma.device.type != "cuda":
        raise ValueError(f"asap_replay runs on cuda or cpu tensors; got {gamma.device}")
    B, m, T = gamma.shape
    shapes = [(B, m - 1, T), (B, m - 1, T), (B, m, T), (B, m, T)]
    shapes += [(B, m - 1, T)] * (2 if ret is not None else 0)
    shapes.append((B,))
    sizes = [math.prod(s) for s in shapes]
    flat = torch.empty(sum(sizes), dtype=gamma.dtype, device=gamma.device)
    cs, ce, ps, pe, *rest = (x.view(s) for x, s in zip(flat.split(sizes), shapes))
    rs, re, mk = rest if ret is not None else (None, None, *rest)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(gamma.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_asap_replay(
            ptr(w), ptr(z), ptr(latency), ptr(tau), ptr(vcomm), ptr(vcomp),
            ptr(rel), ptr(ret), ptr(valid), ptr(gamma), ptr(cs), ptr(ce),
            ptr(ps), ptr(pe), ptr(rs), ptr(re), ptr(mk), B, m, T,
            int(topology == "star"), stream)
    check(code, "asap_replay launch")
    count_launch(asap_replay)
    return cs, ce, ps, pe, rs, re, mk


asap_replay.launches = 0


def outputs_to_numpy(out):
    """:func:`asap_replay`'s 7-slot output as NumPy arrays (None stays None).
    Outputs on the card come back in one device-to-host copy, as the wrapper
    lays them end to end in one buffer; CPU outputs are shared, not copied."""
    full = [o for o in out if o is not None and o.numel()]  # m = 1 has no links
    if not full or full[0].device.type == "cpu":
        return tuple(None if o is None else o.cpu().numpy() for o in out)
    sizes = [o.numel() for o in full]
    first, last = full[0], full[-1]
    if last.data_ptr() != first.data_ptr() + first.element_size() * (sum(sizes) - sizes[-1]):
        raise ValueError("outputs_to_numpy takes the outputs of one asap_replay call")
    host = iter(first.as_strided((sum(sizes),), (1,)).cpu().split(sizes))
    return tuple(None if o is None else (next(host).view(o.shape) if o.numel() else o.cpu()).numpy()
                 for o in out)
