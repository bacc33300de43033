"""Batched dense two-phase simplex on a device — many small LPs at once.

The port of ``repro/engine/batched_simplex.py``.  Solves, for each batch
element:   min c.x   s.t.  A_ub x <= b_ub,  A_eq x = b_eq,  x >= 0 — the
same problem class as :mod:`repro_torch.core.simplex`.

The formulation is the reference's:

  * Ruiz equilibration (3 rounds), then rows with negative rhs are flipped
    (their slack coefficient becomes -1);
  * artificial variables are **implicit**: they start basic on eq/flipped
    rows and never re-enter once driven out, so the tableau holds only
    ``[structural | slack | dummy | rhs]`` columns.  Basis ids ``> dummy``
    denote a still-basic artificial; after phase 1 the survivors retire
    onto the inert zero *dummy* column;
  * every pivot is one fused rank-1 update ``T -= outer(pcol', prow)``,
    run by :func:`repro_torch.kernels.simplex_pivot` — the CUDA kernel on
    the card, its plain version on the CPU;
  * pricing is Dantzig with a Bland fallback after ``max(200, 4 rows)``
    iterations, and the ratio test tie-breaks on the smallest basis id;
  * an optimal exit's values are re-solved from its exit basis
    (:func:`_refine`): hundreds of rank-1 updates leave the tableau's rhs
    column off by up to ~1e-9 relative on ill-conditioned instances, which
    the ASAP replay of gamma then carries into the makespan.  The reference
    reads the values off the tableau; the basis and status are the same.

Set-up, the inter-phase step and extraction run batched in PyTorch on the
device; the warm-basis verification (:func:`_warm_verify`) and the
false-optimal guard (:func:`_demote_false_optimal`) stay NumPy on the host,
as in the reference.

The phase driver is the compaction-epoch driver (:func:`_phase_compact`):
bursts of ``n_launches`` fused K-pivot launches, after each of which the
host drops the finished lanes from the list of lane ids the next launches
take.  The kernel updates the stack in place and reads its lanes through
that list, so compaction moves no tableau bytes at all — the reference
gathered and scattered the whole stack through the host between epochs.
Lane arithmetic does not depend on the lane's position, so the results are
bit-identical to the masked driver (:func:`_phase_masked`, every lane,
one pivot per launch), which stays as the parity reference.

Statuses are the reference's small ints (see STATUS).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.convert import resolve_device, to_tensor
from repro_torch.kernels import simplex_pivot

__all__ = ["BatchedSimplexResult", "solve_simplex_batched", "STATUS"]

_EPS = 1e-9
STATUS = {
    0: "optimal",
    1: "infeasible",
    2: "unbounded",
    3: "iteration_limit",
    4: "degenerate",  # zero-level artificial left basic after phase 1; the
    # batched path skips the serial solver's drive-out pivots (they cost ~m
    # full-tableau passes for a case that essentially never occurs on
    # schedule LPs), so such elements are flagged for the serial fallback
    # instead of being silently mis-solved
    5: "false_optimal",  # an "optimal" exit whose iterate violates a primal
    # constraint beyond the feasibility tolerance — the silently-lost-pivot
    # escape core.backends._primal_violation guards on the serial path.
    # Demoted so the service's certification routes the element to the
    # serial rescue instead of shipping an infeasible plan whose objective
    # reads better than the true optimum.
}

_RUNNING, _OPTIMAL, _UNBOUNDED, _ITER_LIMIT = -1, 0, 2, 3


@dataclasses.dataclass
class BatchedSimplexResult:
    x: np.ndarray  # [B, n]
    objective: np.ndarray  # [B]
    status: np.ndarray  # [B] int — see STATUS
    iterations: np.ndarray  # [B] int (phase 1 + phase 2 pivots)
    iterations_phase1: np.ndarray | None = None  # [B] int — solver telemetry
    iterations_phase2: np.ndarray | None = None  # [B] int
    # the exit basis [B, m_rows]: the column id basic in each row at the
    # final tableau (structural < n, slack in [n, dummy), dummy for retired
    # artificials/redundant rows).  A later solve of a *perturbed* instance
    # with the same shape can seed ``warm_basis`` with it and skip phase 1
    # entirely while it stays primal-feasible.
    basis: np.ndarray | None = None
    # [B] bool — True where the warm (basis-seeded, phase-2-only) entry
    # actually served the element; False on cold two-phase solves
    warm_started: np.ndarray | None = None

    @property
    def ok(self) -> np.ndarray:
        return self.status == 0

    def status_str(self, b: int) -> str:
        return STATUS[int(self.status[b])]


def _equilibrate(A, b, c, iters=3):
    """Ruiz scaling toward unit max-magnitudes, batched: A [B, R, n],
    b [B, R], c [B, n] -> (A, b, c_scaled, col_scale)."""
    B, R, n = A.shape
    col = torch.ones(B, n, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        rmax = A.abs().amax(dim=2) if n else torch.zeros(B, R, dtype=A.dtype, device=A.device)
        r = 1.0 / torch.sqrt(torch.where(rmax > 0, rmax, 1.0))
        A = A * r[:, :, None]
        b = b * r
        cmax = A.abs().amax(dim=1) if R else torch.zeros(B, n, dtype=A.dtype, device=A.device)
        s = 1.0 / torch.sqrt(torch.where(cmax > 0, cmax, 1.0))
        A = A * s[:, None, :]
        col = col * s
    return A, b, c * col, col


def _standard_rows(c, A_ub, b_ub, A_eq, b_eq):
    """Equilibrate + sign-flip a batch of LPs into their standard-form row
    blocks.

    Returns (M, can_slack, c_scaled, col_scale): M is [B, m_rows, dummy+2]
    with columns [structural | slack | dummy | rhs]; ``can_slack`` marks the
    rows whose +1 slack can start basic.  Shared by the cold set-up and the
    warm (basis-seeded) entry so both see bit-identical coefficients.
    """
    B, n = c.shape
    m_ub, m_eq = A_ub.shape[1], A_eq.shape[1]
    m_rows = m_ub + m_eq
    dev, f64 = c.device, c.dtype
    A = torch.cat([A_ub, A_eq], dim=1)
    b = torch.cat([b_ub, b_eq], dim=1)
    A, b, c, col_scale = _equilibrate(A, b, c)
    neg = b < 0
    A = torch.where(neg[:, :, None], -A, A)
    b = b.abs()
    dummy = n + m_ub
    M = torch.zeros(B, m_rows, dummy + 2, dtype=f64, device=dev)
    M[:, :, :n] = A
    M[:, :, -1] = b
    rows = torch.arange(m_ub, device=dev)
    M[:, rows, n + rows] = torch.where(neg[:, :m_ub], -1.0, 1.0).to(f64)
    can_slack = torch.cat(
        [~neg[:, :m_ub], torch.zeros(B, m_eq, dtype=torch.bool, device=dev)], dim=1)
    return M, can_slack, c, col_scale


def _setup(c, A_ub, b_ub, A_eq, b_eq):
    """The phase-1 tableau stack and basis; returns (T, basis, c_scaled,
    col_scale).  T's objective row holds the phase-1 objective (the sum of
    the implicit artificials, priced out)."""
    B, n = c.shape
    m_ub = A_ub.shape[1]
    M, can_slack, c_s, col_scale = _standard_rows(c, A_ub, b_ub, A_eq, b_eq)
    m_rows = M.shape[1]
    dummy = n + m_ub
    T = torch.zeros(B, m_rows + 1, dummy + 2, dtype=c.dtype, device=c.device)
    T[:, :m_rows] = M
    del M
    rows = torch.arange(m_rows, device=c.device, dtype=torch.int32)
    # the +1 slack where the row kept one, else an implicit artificial with
    # id dummy + 1 + r, ordered like the rows so the ratio test's basis-id
    # tie-break matches the serial solver
    basis = torch.where(can_slack, n + rows, dummy + 1 + rows).to(torch.int32).contiguous()
    art = (~can_slack).to(c.dtype)
    T[:, -1] = -(T[:, :m_rows] * art[:, :, None]).sum(dim=1)
    return T, basis, c_s, col_scale


def _running(it, status, max_iter):
    return (status == _RUNNING) & (it < max_iter)


def _phase_masked(T, basis, ncols_price, max_iter, bland_after):
    """Every lane, one pivot per launch, until no lane runs."""
    B = T.shape[0]
    it = torch.zeros(B, dtype=torch.int32, device=T.device)
    status = torch.full((B,), _RUNNING, dtype=torch.int32, device=T.device)
    while bool(_running(it, status, max_iter).any()):
        simplex_pivot(T, basis, it, status, ncols_price=ncols_price,
                      bland_after=bland_after, max_iter=max_iter)
    return it, torch.where(status == _RUNNING, _ITER_LIMIT, status)


def _phase_compact(T, basis, ncols_price, max_iter, bland_after, k_pivots,
                   n_launches):
    """Compaction epochs: up to ``n_launches`` K-pivot launches over the
    active lanes (stopping early once none runs), then the finished lanes
    leave the list.  Same contract and bits as :func:`_phase_masked`."""
    B = T.shape[0]
    dev = T.device
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    status = torch.full((B,), _RUNNING, dtype=torch.int32, device=dev)
    lanes = torch.arange(B, dtype=torch.int32, device=dev)
    while lanes.numel():
        idx = lanes.long()
        for _ in range(n_launches):
            simplex_pivot(T, basis, it, status, ncols_price=ncols_price,
                          bland_after=bland_after, max_iter=max_iter,
                          k_pivots=k_pivots, lanes=lanes)
            live = _running(it[idx], status[idx], max_iter)
            if not bool(live.any()):
                break
        lanes = lanes[live].contiguous()
    return it, torch.where(status == _RUNNING, _ITER_LIMIT, status)


def _between_phases(T, basis, st1, c_s, n, dummy):
    """Phase-1 epilogue + phase-2 objective install, batched and in place.

    Rows whose artificial is still basic at zero level and whose structural
    and slack entries are all zero are redundant — they retire onto the
    dummy column.  A *drivable* leftover (nonzero entries) is flagged
    (status 4 after extraction) for the serial fallback.
    """
    m_rows = T.shape[1] - 1
    infeasible = (st1 == _OPTIMAL) & (T[:, -1, -1] < -1e-7)
    is_art = basis > dummy
    zero_level = T[:, :m_rows, -1].abs() <= 1e-9
    has_entries = (T[:, :m_rows, :dummy].abs() > 1e-9).any(dim=2)
    drivable = (is_art & zero_level & has_entries).any(dim=1)
    basis.masked_fill_(is_art, dummy)

    T[:, -1] = 0.0
    T[:, -1, :n] = c_s
    # price out basic variables: obj -= sum_r obj[basis[r]] * T[r]
    coeff = T[:, -1].gather(1, basis.long())  # [B, m_rows], 0 on dummy rows
    T[:, -1] += -torch.bmm(coeff[:, None, :], T[:, :m_rows])[:, 0]
    return infeasible, drivable


def _extract(T, basis, col_scale, c, infeasible, drivable, st1, st2, it1, it2, n, dummy):
    B, R, _ = T.shape
    xfull = torch.zeros(B, dummy + 1, dtype=T.dtype, device=T.device)
    xfull.scatter_(1, basis.long(), T[:, : R - 1, -1])
    x = col_scale * xfull[:, :n]  # undo column scaling
    obj = (c * x).sum(dim=1)
    status = torch.where(infeasible, 1, torch.where(st1 != _OPTIMAL, st1, st2))
    status = torch.where((status == _OPTIMAL) & drivable, 4, status)
    bad = (status == 1) | (status == 4)
    x = torch.where(bad[:, None], torch.nan, x)
    obj = torch.where(bad, torch.nan, obj)
    return x, obj, status, it1 + it2, it1, it2, basis


def _solve_cold(c, A_ub, b_ub, A_eq, b_eq, max_iter, compact):
    """Set-up, both phases and extraction for a batch of LPs with rows."""
    from repro_torch.engine.autotune import pivot_schedule

    n = c.shape[1]
    m_ub, m_eq = A_ub.shape[1], A_eq.shape[1]
    m_rows = m_ub + m_eq
    dummy = n + m_ub
    bland_after = max(200, 4 * (m_rows + 1))

    T, basis, c_s, col_scale = _setup(c, A_ub, b_ub, A_eq, b_eq)
    if compact:
        tune = pivot_schedule(m_rows + 1, dummy + 2, c.device)
        run = lambda: _phase_compact(  # noqa: E731
            T, basis, dummy, max_iter, bland_after, tune["k_pivots"], tune["n_launches"])
    else:
        run = lambda: _phase_masked(T, basis, dummy, max_iter, bland_after)  # noqa: E731
    it1, st1 = run()
    infeasible, drivable = _between_phases(T, basis, st1, c_s, n, dummy)
    it2, st2 = run()
    x, obj, status, it, it1, it2, basis = _extract(
        T, basis, col_scale, c, infeasible, drivable, st1, st2, it1, it2, n, dummy)
    del T
    x, obj = _refine(x, obj, status, basis, c, A_ub, b_ub, A_eq, b_eq, col_scale, dummy)
    return x, obj, status, it, it1, it2, basis


def _refine(x, obj, status, basis, c, A_ub, b_ub, A_eq, b_eq, col_scale, dummy):
    """Re-solve the values of each optimal lane from its exit basis.

    The basis matrix of the same equilibrated standard-form rows the
    tableau started from is factored once per lane (``solve_ex``: a
    singular lane reports itself instead of failing the batch), and the
    lane takes the re-solved values when they are finite, a vertex
    (``x_B >= -1e-9``) and reproduce the rows (residual within
    ``1e-8 * max(1, max |M|)``, the warm entry's gates); otherwise, and for
    lanes whose basis holds a retired artificial (the dummy column), it keeps
    the tableau's values.  The basis, the status and the pivot counts are
    untouched.  Returns ``(x, obj)``.
    """
    n = c.shape[1]
    sel = ((status == _OPTIMAL) & (basis < dummy).all(dim=1)).nonzero()[:, 0]
    if sel.numel() == 0:
        return x, obj
    M, _, _, _ = _standard_rows(c[sel], A_ub[sel], b_ub[sel], A_eq[sel], b_eq[sel])
    bas = basis[sel].long()
    Bm = M.gather(2, bas[:, None, :].expand(-1, M.shape[1], -1))  # [S, R, R]
    rhs = M[:, :, -1]
    xB, info = torch.linalg.solve_ex(Bm, rhs)
    resid = (torch.bmm(Bm, xB[:, :, None])[:, :, 0] - rhs).abs().amax(dim=1)
    scale = M.abs().flatten(1).amax(dim=1).clamp_min(1.0)
    ok = ((info == 0) & torch.isfinite(xB).all(dim=1) & (xB.amin(dim=1) >= -1e-9)
          & (resid <= 1e-8 * scale))
    xfull = torch.zeros(sel.numel(), dummy + 1, dtype=x.dtype, device=x.device)
    xfull.scatter_(1, bas, xB)
    xr = col_scale[sel] * xfull[:, :n]
    x, obj = x.clone(), obj.clone()
    keep = sel[ok]
    x[keep] = xr[ok]
    obj[keep] = (c[keep] * x[keep]).sum(dim=1)
    return x, obj


def _warm_verify(c, A_ub, b_ub, A_eq, b_eq, basis, device):
    """Basis-seeded verify-first warm entry: accept each carried basis at
    zero pivots when it is still *optimal* under the (perturbed)
    coefficients.

    The standard-form rows are rebuilt for the new coefficients by the same
    :func:`_standard_rows` the cold path runs (so both entries see
    bit-identical scaled coefficients), then each lane's basis matrix is
    factored once on the host (NumPy's stacked LAPACK ``solve``) and the
    simplex exit certificate is checked directly: primal feasibility
    (``B^-1 b >= 0``) and dual feasibility (reduced costs ``c - y A >= 0``
    with ``B^T y = c_B``).

    Returns ``(x, obj, accept, basis)`` — lanes with ``accept`` False must
    be cold-solved by the caller — or None when some lane's basis matrix
    was *exactly* singular, which LAPACK reports batch-wide.  Rejection
    never changes an answer, only its speed.
    """
    B, n = c.shape
    m_ub = A_ub.shape[1]
    dummy = n + m_ub

    f64 = torch.float64
    M, _, c_s, col_scale = _standard_rows(*(to_tensor(a, device, f64) for a in (
        c, A_ub, b_ub, A_eq, b_eq)))
    M, c_s, col_scale = M.cpu().numpy(), c_s.cpu().numpy(), col_scale.cpu().numpy()
    safe = np.clip(basis, 0, dummy - 1)
    Bm = np.take_along_axis(M, safe[:, None, :], axis=2)  # [B, R, R]
    rhs = M[:, :, -1]
    c_cols = np.zeros((B, dummy))
    c_cols[:, :n] = c_s  # slack/dummy columns price at 0
    cB = np.take_along_axis(c_cols, safe, axis=1)
    try:
        with np.errstate(all="ignore"):
            xB = np.linalg.solve(Bm, rhs[..., None])[..., 0]  # basic values
            y = np.linalg.solve(np.swapaxes(Bm, 1, 2), cB[..., None])[..., 0]
    except np.linalg.LinAlgError:
        return None  # an exactly singular basis matrix somewhere: all cold
    with np.errstate(invalid="ignore"):
        red = c_cols - np.einsum("br,brj->bj", y, M[:, :, :dummy])
        primal_resid = np.abs(np.einsum("brk,bk->br", Bm, xB) - rhs).max(axis=1)
        dual_resid = np.abs(np.einsum("brk,br->bk", Bm, y) - cB).max(axis=1)
        scale = np.maximum(1.0, np.abs(M).reshape(B, -1).max(axis=1))
        cscale = np.maximum(1.0, np.abs(c_s).max(axis=1))
        accept = (
            np.isfinite(xB).all(axis=1)
            & np.isfinite(y).all(axis=1)
            & (primal_resid <= 1e-8 * scale)
            & (dual_resid <= 1e-8 * cscale)
            & (xB.min(axis=1, initial=0.0) >= -1e-9)  # still a vertex
            & (red.min(axis=1, initial=0.0) >= -_EPS)  # no column prices in
        )

    xfull = np.zeros((B, dummy))
    np.put_along_axis(xfull, safe, np.where(accept[:, None], xB, 0.0), axis=1)
    x = col_scale * xfull[:, :n]  # undo column scaling
    obj = np.einsum("bn,bn->b", c, x)
    return x, obj, accept, safe


def _demote_false_optimal(x, status, A_ub, b_ub, A_eq, b_eq):
    """Batched twin of ``core.backends._primal_violation``: demote "optimal"
    elements whose iterate violates a primal constraint beyond the
    feasibility tolerance (``1e-7 * max(1, max|x|)``) to status 5
    (``false_optimal``), so the service routes them to the serial rescue."""
    opt = status == 0
    if not opt.any():
        return status
    B = x.shape[0]
    viol = np.zeros(B)
    with np.errstate(invalid="ignore"):
        if A_ub.shape[1]:
            viol = np.maximum(
                viol, (np.einsum("brn,bn->br", A_ub, x) - b_ub).max(axis=1))
        if A_eq.shape[1]:
            viol = np.maximum(
                viol, np.abs(np.einsum("brn,bn->br", A_eq, x) - b_eq).max(axis=1))
        if x.shape[1]:
            viol = np.maximum(viol, (-x).max(axis=1))
            scale = np.maximum(1.0, np.abs(x).max(axis=1))
        else:
            scale = np.ones(B)
        bad = opt & (viol > 1e-7 * scale)
    return np.where(bad, np.int32(5), status).astype(status.dtype)


def solve_simplex_batched(
    c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, max_iter: int = 20_000,
    compact: bool | None = None, warm_basis=None, device=None,
) -> BatchedSimplexResult:
    """Solve a batch of LPs of identical shape on ``device`` (None: the card).

    Arguments are NumPy arrays batched along axis 0: c [B, n], A_ub
    [B, mu, n], b_ub [B, mu], A_eq [B, me, n], b_eq [B, me]; pass None for
    absent families.  Results come back as NumPy.

    ``compact`` selects the compaction-epoch driver (default: on for
    batches of >= 2); ``compact=False`` runs the masked driver, kept as the
    parity reference.  Both give the same bits.

    ``warm_basis`` ([B, m_rows] int, ``-1``-filled rows meaning "no seed")
    enables the basis-seeded entry: elements whose carried basis is entirely
    structural/slack ids are verified against the new coefficients and
    served at zero pivots when the simplex exit certificate holds; every
    other element solves cold.  ``result.warm_started`` records which
    elements the warm entry served; ``result.basis`` carries every
    element's exit basis for the *next* replan.
    """
    dev = resolve_device(device)
    c = np.asarray(c, dtype=np.float64)
    B, n = c.shape
    A_ub = np.zeros((B, 0, n)) if A_ub is None else np.asarray(A_ub, dtype=np.float64)
    b_ub = np.zeros((B, 0)) if b_ub is None else np.asarray(b_ub, dtype=np.float64)
    A_eq = np.zeros((B, 0, n)) if A_eq is None else np.asarray(A_eq, dtype=np.float64)
    b_eq = np.zeros((B, 0)) if b_eq is None else np.asarray(b_eq, dtype=np.float64)
    if A_ub.shape[0] != B or A_eq.shape[0] != B:
        raise ValueError("batch dims disagree")
    m_rows = A_ub.shape[1] + A_eq.shape[1]
    if m_rows == 0:
        raise ValueError("the batched simplex needs at least one constraint row")

    x = np.empty((B, n))
    obj = np.empty(B)
    status = np.empty(B, np.int32)
    iters = np.empty(B, np.int32)
    it1 = np.empty(B, np.int32)
    it2 = np.empty(B, np.int32)
    basis_out = np.empty((B, m_rows), np.int64)
    warm_started = np.zeros(B, dtype=bool)

    cold_idx = np.arange(B)
    if warm_basis is not None and B > 0:
        wb = np.asarray(warm_basis)
        if wb.shape != (B, m_rows):
            raise ValueError(
                f"warm_basis must be [B={B}, m_rows={m_rows}]; got {wb.shape}")
        wb = wb.astype(np.int64)
        dummy = n + A_ub.shape[1]
        cand_idx = np.flatnonzero(np.all((wb >= 0) & (wb < dummy), axis=1))
        verified = _warm_verify(
            c[cand_idx], A_ub[cand_idx], b_ub[cand_idx],
            A_eq[cand_idx], b_eq[cand_idx], wb[cand_idx], dev,
        ) if cand_idx.size else None
        if verified is not None:
            wx, wobj, ok, wbasis = verified
            # accept only certified warm exits: a rejected seed re-solves
            # cold below, so the warm entry never worsens an outcome
            good = cand_idx[ok]
            if good.size:
                x[good] = wx[ok]
                obj[good] = wobj[ok]
                status[good] = _OPTIMAL
                iters[good] = 0
                it1[good] = 0
                it2[good] = 0
                basis_out[good] = wbasis[ok]
                warm_started[good] = True
                cold_mask = np.ones(B, dtype=bool)
                cold_mask[good] = False
                cold_idx = np.flatnonzero(cold_mask)

    if cold_idx.size:
        cc = len(cold_idx) >= 2 if compact is None else compact  # epochs need lanes to retire
        out = _solve_cold(*(to_tensor(a[cold_idx], dev, torch.float64) for a in (
            c, A_ub, b_ub, A_eq, b_eq)), int(max_iter), cc)
        cx, cobj, cst, cit, cit1, cit2, cbasis = (o.cpu().numpy() for o in out)
        x[cold_idx] = cx
        obj[cold_idx] = cobj
        status[cold_idx] = cst
        iters[cold_idx] = cit
        it1[cold_idx] = cit1
        it2[cold_idx] = cit2
        basis_out[cold_idx] = cbasis

    status = _demote_false_optimal(x, status, A_ub, b_ub, A_eq, b_eq)
    return BatchedSimplexResult(
        x=x,
        objective=obj,
        status=status,
        iterations=iters,
        iterations_phase1=it1,
        iterations_phase2=it2,
        basis=basis_out,
        warm_started=warm_started,
    )
