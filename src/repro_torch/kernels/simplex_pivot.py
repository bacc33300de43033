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

On the card a lane runs on a thread-block cluster of :func:`cluster_size`
blocks, chosen from the number of lanes of the launch, and the kernel
updates only the rows whose entering-column entry is nonzero (all rows of a
column slice whose scaled pivot row holds an inf or NaN), which gives the
same bits as the dense update (``csrc/simplex_pivot.cu`` says why).  A lane
that does not pivot in a round (it is done, or the round finds it optimal
or unbounded) is left as it is; the plain version multiplies that lane's
candidate pivot row by pcol = 0, which changes nothing (but a zero's sign)
while the row is finite and writes NaN (0 x inf) where it is not.  So the
two agree bit for bit on every tableau whose lanes, once they stop
pivoting, hold finite values, as the engine's do; the compaction driver,
which launches only running lanes, relies on the same.
PyTorch's ``addcmul`` on the card rounds the product before the sum, so
the plain version's one-fma update is exact on the CPU, not on the card:
the kernel is held to it there.
:func:`simplex_pivot` checks that every lane id lies in the stack, which on
the card costs two reads back to the host; :func:`simplex_pivot_lanes` is
the epoch driver's entry, for lane lists it built from ``arange`` and
subsets of it, and skips that check (the kernel still ignores an id outside
the stack).  ``simplex_pivot.clusters`` counts launches by cluster size,
and :func:`updated_elements` reads the card's count of tableau elements the
kernel updated.
"""

from __future__ import annotations

import ctypes

import torch

from .build import STATE_LOCK, check, library

__all__ = ["simplex_pivot", "simplex_pivot_plain", "simplex_pivot_lanes", "cluster_size",
           "updated_elements", "reset_updated", "SHARED_BYTES_MAX"]

_EPS = 1e-9
_RUNNING, _OPTIMAL, _UNBOUNDED = -1, 0, 2
_INT32_MAX = 2**31 - 1
SHARED_BYTES_MAX = 232_448 - 2048  # a block's shared memory on Hopper, less the reductions' scratch
_MAX_CLUSTER = 16  # the largest cluster Hopper launches (beyond 8, not portable)


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


def _check_args(T, basis, it, status, lanes, ncols_price, k_pivots, check_lane_ids=True):
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
        if check_lane_ids and lanes.numel():
            lo, hi = torch.aminmax(lanes)
            if int(lo) < 0 or int(hi) >= B:
                raise ValueError(f"lane ids must lie in [0, {B})")


_SMS: dict[int, int] = {}


def cluster_size(n_lanes: int, sms: int = 132, resident=None) -> int:
    """Blocks a lane runs on (the kernel runs one block an SM): the largest
    power of two up to 16 with which the lanes' blocks fit on the ``sms``
    SMs and, where ``resident`` (cluster size -> clusters the card holds at
    once) is given, every lane's cluster is resident together; 1 once the
    lanes alone fill the card."""
    s = 1
    while (s < _MAX_CLUSTER and n_lanes * 2 * s <= sms
           and (resident is None or n_lanes <= resident(2 * s))):
        s *= 2
    return s


_RESIDENT: dict[tuple, int] = {}


def _resident_clusters(index: int, R: int, C: int, cluster: int) -> int:
    key = (index, R, C, cluster)
    with STATE_LOCK:
        if key not in _RESIDENT:
            out = ctypes.c_int(0)
            check(library().repro_simplex_pivot_max_clusters(R, C, cluster,
                                                             ctypes.addressof(out)),
                  "simplex_pivot occupancy")
            _RESIDENT[key] = out.value
        return _RESIDENT[key]


_UPDATED: dict[int, torch.Tensor] = {}  # card index -> int64 count of updated elements


def _card_index(device) -> int:
    dev = torch.device("cuda" if device is None else device)
    return dev.index if dev.index is not None else torch.cuda.current_device()


def updated_elements(device=None) -> int:
    """Tableau elements the kernel updated on ``device`` (None: the current
    card) since the last :func:`reset_updated`; reading the card's counter
    synchronises with it."""
    with STATE_LOCK:
        counter = _UPDATED.get(_card_index(device)) if _UPDATED else None
    return 0 if counter is None else int(counter.item())


def reset_updated() -> None:
    """Set the cards' counts of updated elements to 0."""
    with STATE_LOCK:
        for counter in _UPDATED.values():
            counter.zero_()


def _card_state(index: int, device) -> tuple:
    """The card's counter of updated elements and its SM count, each made
    once (under the lock, whichever thread launches first)."""
    with STATE_LOCK:
        if index not in _UPDATED:
            _UPDATED[index] = torch.zeros(1, dtype=torch.int64, device=device)
            _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
        return _UPDATED[index], _SMS[index]


def _launch(T, basis, it, status, lanes, kw, cluster):
    B, R, C = T.shape
    n_lanes = B if lanes is None else lanes.numel()
    if n_lanes == 0:
        return
    if R * C >= 2**31:
        raise ValueError(f"tableau {R}x{C} is too large for 32-bit element indices")
    with torch.cuda.device(T.device):
        index = _card_index(T.device)
        updated, sms = _card_state(index, T.device)
        if cluster is None:
            cluster = cluster_size(n_lanes, sms, lambda s: _resident_clusters(index, R, C, s))
        slice_ = ((C + cluster - 1) // cluster + 1) & ~1
        if (2 * R + slice_) * 8 + 4 * R > SHARED_BYTES_MAX:
            raise ValueError(f"tableau {R}x{C} needs more shared memory than a block has")
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_simplex_pivot(
            T.data_ptr(), basis.data_ptr(), it.data_ptr(), status.data_ptr(),
            None if lanes is None else lanes.data_ptr(), n_lanes, B, R, C,
            kw["ncols_price"], kw["bland_after"], kw["max_iter"], kw["k_pivots"], cluster,
            updated.data_ptr(), stream)
    check(code, "simplex_pivot launch")
    with STATE_LOCK:
        simplex_pivot.launches += 1
        simplex_pivot.clusters[cluster] = simplex_pivot.clusters.get(cluster, 0) + 1


def _run(T, basis, it, status, lanes, kw, cluster, check_lane_ids):
    _check_args(T, basis, it, status, lanes, kw["ncols_price"], kw["k_pivots"], check_lane_ids)
    if cluster is not None and cluster not in (1, 2, 4, 8, 16):
        raise ValueError(f"cluster must be 1, 2, 4, 8 or 16 blocks; got {cluster}")
    if T.device.type == "cpu":
        return simplex_pivot_plain(T, basis, it, status, lanes=lanes, **kw)
    if T.device.type != "cuda":
        raise ValueError(f"simplex_pivot runs on cuda or cpu tensors; got {T.device}")
    _launch(T, basis, it, status, lanes, kw, cluster)
    return T, basis, it, status


def simplex_pivot(T, basis, it, status, *, ncols_price: int, bland_after: int,
                  max_iter: int, k_pivots: int = 1, lanes=None, cluster: int | None = None):
    """Up to ``k_pivots`` masked pivots per lane, in place: the CUDA kernel
    for tensors on the card, :func:`simplex_pivot_plain` for tensors on the
    CPU.  ``cluster`` (1, 2, 4, 8 or 16 blocks a lane; None: from the number
    of lanes) changes no bits.  ``simplex_pivot.launches`` counts kernel
    launches."""
    kw = dict(ncols_price=ncols_price, bland_after=bland_after, max_iter=max_iter,
              k_pivots=k_pivots)
    return _run(T, basis, it, status, lanes, kw, cluster, check_lane_ids=True)


def simplex_pivot_lanes(T, basis, it, status, lanes, *, ncols_price: int, bland_after: int,
                        max_iter: int, k_pivots: int = 1):
    """:func:`simplex_pivot` over ``lanes``, for a caller that built the lane
    ids from ``arange(B)`` and subsets of it: the ids are not read back to
    the host to be checked (on the card that check costs two
    synchronisations a launch)."""
    kw = dict(ncols_price=ncols_price, bland_after=bland_after, max_iter=max_iter,
              k_pivots=k_pivots)
    return _run(T, basis, it, status, lanes, kw, None, check_lane_ids=False)


simplex_pivot.launches = 0
simplex_pivot.clusters = {}
