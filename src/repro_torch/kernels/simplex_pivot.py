"""Fused masked simplex pivots over a ``[B, R, C]`` float64 tableau stack.

The port of the Pallas kernel ``simplex_pivot_kernel`` /
``simplex_pivot_call`` (``repro/kernels/simplex_pivot.py``, body
``_one_pivot``).  :func:`simplex_pivot` launches the hand-written CUDA
kernel (``csrc/simplex_pivot.cu``) for tensors on the card and runs
:func:`simplex_pivot_plain` for tensors on the CPU; it never falls back
from one to the other.

Each of up to ``k_pivots`` rounds, for every lane still running and under
``max_iter``:

  1. Dantzig pricing over the first ``ncols_price`` columns of the objective
     row (first index of the minimum), Bland's first negative column once
     ``it >= bland_after``;
  2. the ratio test over the entering column, ``rhs / col`` where
     ``col > 1e-9`` and ``inf`` elsewhere, ties within 1e-12 going to the
     smallest basis id (then the first row);
  3. the one-pass rank-1 update ``T -= outer(pcol', prow)`` with
     ``prow = T[row] / piv`` and ``pcol'[row] = piv - 1``, rounded once per
     element as a fused multiply-add.

Statuses: -1 running, 0 optimal (no negative reduced cost), 2 unbounded.
Lanes that are done ride through unchanged, so K fused rounds equal K
single launches bit for bit.

Both versions update ``T``, ``basis``, ``it`` and ``status`` **in place**
and return them: the stack is the largest object the engine holds (4 GB
for 256 chain LPs at the §6 scale), and a second copy would double both
its memory and the bytes each launch moves.  ``lanes`` (int32 lane ids)
restricts a launch to those lanes — the epoch driver's compaction.
"""

from __future__ import annotations

import torch

from .build import check, library

__all__ = ["simplex_pivot", "simplex_pivot_plain", "SHARED_BYTES_MAX"]

_EPS = 1e-9
_RUNNING, _OPTIMAL, _UNBOUNDED = -1, 0, 2
_INT32_MAX = 2**31 - 1
SHARED_BYTES_MAX = 232_448 - 256  # a block's shared memory on Hopper, less the reductions' scratch


def _one_round(T, basis, it, status, ncols_price, bland_after, max_iter):
    B, R, C = T.shape
    m_rows = R - 1
    active = (status == _RUNNING) & (it < max_iter)

    obj = T[:, -1, :ncols_price]
    neg = obj < -_EPS
    any_neg = neg.any(dim=1)
    dantzig = torch.argmin(obj, dim=1)
    cidx = torch.arange(ncols_price, device=T.device)
    bland = torch.argmin(torch.where(neg, cidx, ncols_price), dim=1)
    col = torch.where(it < bland_after, dantzig, bland)

    pcol_full = T.gather(2, col[:, None, None].expand(B, R, 1))[:, :, 0]
    colvals = pcol_full[:, :m_rows]
    pos = colvals > _EPS
    ratios = torch.where(
        pos, T[:, :m_rows, -1] / torch.where(pos, colvals, 1.0), torch.inf)
    best = ratios.amin(dim=1)
    unbounded = ~torch.isfinite(best)
    ties = (ratios - best[:, None]).abs() <= 1e-12
    row = torch.argmin(torch.where(ties, basis.long(), _INT32_MAX), dim=1)

    do_pivot = active & any_neg & ~unbounded
    piv = torch.where(do_pivot, colvals.gather(1, row[:, None])[:, 0], 1.0)
    prow = T.gather(1, row[:, None, None].expand(B, 1, C))[:, 0, :] / piv[:, None]
    pcol = pcol_full.scatter(1, row[:, None], (piv - 1.0)[:, None])
    pcol = torch.where(do_pivot[:, None], pcol, 0.0)
    T.addcmul_(pcol[:, :, None], prow[:, None, :], value=-1.0)  # one fma

    new_basis = basis.scatter(1, row[:, None], col[:, None].to(basis.dtype))
    basis.copy_(torch.where(do_pivot[:, None], new_basis, basis))
    new_status = torch.where(
        ~any_neg, _OPTIMAL, torch.where(unbounded, _UNBOUNDED, _RUNNING))
    status.copy_(torch.where(active, new_status.to(status.dtype), status))
    it.add_(do_pivot.to(it.dtype))


def simplex_pivot_plain(T, basis, it, status, *, ncols_price: int,
                        bland_after: int, max_iter: int, k_pivots: int = 1,
                        lanes=None):
    """The plain PyTorch version of the kernel, on any device: the same
    rounds, vectorized over the lanes (one gather per column/row where the
    TPU kernel used one-hot contractions; a gather is exact)."""
    if lanes is None:
        for _ in range(k_pivots):
            _one_round(T, basis, it, status, ncols_price, bland_after, max_iter)
        return T, basis, it, status
    idx = lanes.long()
    sub = [x.index_select(0, idx) for x in (T, basis, it, status)]
    for _ in range(k_pivots):
        _one_round(*sub, ncols_price, bland_after, max_iter)
    for x, s in zip((T, basis, it, status), sub):
        x.index_copy_(0, idx, s)
    return T, basis, it, status


def _check_args(T, basis, it, status, lanes, ncols_price, k_pivots):
    if T.dtype != torch.float64 or T.dim() != 3:
        raise TypeError(f"T must be a float64 [B, R, C] tensor; got {T.dtype} {tuple(T.shape)}")
    B, R, C = T.shape
    if R < 2 or C < 2:
        raise ValueError(f"a tableau needs at least 2 rows and 2 columns; got {R}x{C}")
    if not 0 < ncols_price <= C:
        raise ValueError(f"ncols_price must be in (0, {C}]; got {ncols_price}")
    if k_pivots < 1:
        raise ValueError(f"k_pivots must be >= 1; got {k_pivots}")
    for name, x, shape in (("basis", basis, (B, R - 1)), ("it", it, (B,)),
                           ("status", status, (B,))):
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise TypeError(f"{name} must be int32 {shape}; got {x.dtype} {tuple(x.shape)}")
    tensors = [T, basis, it, status] + ([lanes] if lanes is not None else [])
    if any(x.device != T.device for x in tensors):
        raise ValueError("all arguments must lie on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("simplex_pivot needs contiguous tensors")
    if lanes is not None:
        if lanes.dtype != torch.int32 or lanes.dim() != 1:
            raise TypeError(f"lanes must be a 1-D int32 tensor; got {lanes.dtype}")
        if lanes.numel():
            lo, hi = torch.aminmax(lanes)
            if int(lo) < 0 or int(hi) >= B:
                raise ValueError(f"lane ids must lie in [0, {B})")


def simplex_pivot(T, basis, it, status, *, ncols_price: int, bland_after: int,
                  max_iter: int, k_pivots: int = 1, lanes=None):
    """Up to ``k_pivots`` masked pivots per lane, in place: the CUDA kernel
    for tensors on the card, :func:`simplex_pivot_plain` for tensors on the
    CPU.  ``simplex_pivot.launches`` counts kernel launches."""
    _check_args(T, basis, it, status, lanes, ncols_price, k_pivots)
    kw = dict(ncols_price=ncols_price, bland_after=bland_after,
              max_iter=max_iter, k_pivots=k_pivots)
    if T.device.type == "cpu":
        return simplex_pivot_plain(T, basis, it, status, lanes=lanes, **kw)
    if T.device.type != "cuda":
        raise ValueError(f"simplex_pivot runs on cuda or cpu tensors; got {T.device}")
    B, R, C = T.shape
    if (2 * R + C) * 8 > SHARED_BYTES_MAX:
        raise ValueError(f"tableau {R}x{C} needs more shared memory than a block has")
    if R * C >= 2**31:
        raise ValueError(f"tableau {R}x{C} is too large for 32-bit element indices")
    n_lanes = B if lanes is None else lanes.numel()
    if n_lanes == 0:
        return T, basis, it, status
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_simplex_pivot(
            T.data_ptr(), basis.data_ptr(), it.data_ptr(), status.data_ptr(),
            None if lanes is None else lanes.data_ptr(), n_lanes, R, C,
            ncols_price, bland_after, max_iter, k_pivots, stream)
    check(code, "simplex_pivot launch")
    simplex_pivot.launches += 1
    return T, basis, it, status


simplex_pivot.launches = 0
