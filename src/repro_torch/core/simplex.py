"""A self-contained dense two-phase simplex LP solver (pure numpy).

Solves   min c.x   s.t.  A_ub x <= b_ub,  A_eq x = b_eq,  x >= 0.

This is the in-tree substrate solver: no external LP package is *required*
anywhere in the framework.  ``repro_torch.core.solver`` cross-checks it against
scipy's HiGHS backend (when present) and dispatches large instances there —
the same engineering decision as the paper's use of GLPK.

Implementation notes:
  * Ruiz equilibration first: rows and columns of the constraint matrix are
    iteratively scaled toward unit max-magnitude.  Schedule LPs mix
    coefficients from ~1e-8 (per-FLOP times) to ~1e10 (volumes); without
    scaling the fixed pivot tolerances misread rounding noise as negative
    reduced costs on columns with no positive entries (a false "unbounded");
  * dense tableau, vectorized rank-1 pivot updates;
  * phase 1 minimizes the sum of artificial variables (b is made nonnegative
    row-wise first), phase 2 the user objective;
  * Dantzig pricing with a Bland's-rule fallback (anti-cycling) after a
    stall-detection threshold;
  * tolerances tuned for well-scaled data (which equilibration guarantees).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SimplexResult", "solve_simplex"]

_EPS = 1e-9


@dataclasses.dataclass
class SimplexResult:
    x: np.ndarray
    objective: float
    status: str  # "optimal" | "infeasible" | "unbounded" | "iteration_limit"
    iterations: int

    @property
    def ok(self) -> bool:
        return self.status == "optimal"


def _equilibrate(A: np.ndarray, b: np.ndarray, c: np.ndarray, iters: int = 3):
    """Ruiz scaling: A' = R A C with max-magnitudes driven toward 1.

    Returns (A', b', c', col_scale); the scaled LP has the same status, and
    ``x = col_scale * x'`` maps its solutions back (row scaling r_i > 0
    preserves inequality directions; column scaling preserves x >= 0).
    """
    A = A.copy()
    b = b.copy()
    col = np.ones(A.shape[1])
    absA = np.abs(A)
    for _ in range(iters):
        rmax = absA.max(axis=1, initial=0.0)
        r = 1.0 / np.sqrt(np.where(rmax > 0, rmax, 1.0))
        A *= r[:, None]
        b *= r
        np.abs(A, out=absA)
        cmax = absA.max(axis=0, initial=0.0)
        s = 1.0 / np.sqrt(np.where(cmax > 0, cmax, 1.0))
        A *= s[None, :]
        col *= s
        np.abs(A, out=absA)
    return A, b, c * col, col


def _pivot(T: np.ndarray, basis: np.ndarray, row: int, col: int) -> None:
    """In-place pivot of tableau T on (row, col)."""
    T[row] /= T[row, col]
    colv = T[:, col].copy()
    colv[row] = 0.0
    # rank-1 update: every other row r -= colv[r] * T[row]
    T -= np.outer(colv, T[row])
    basis[row] = col


def _run(T: np.ndarray, basis: np.ndarray, ncols: int, max_iter: int) -> tuple[str, int]:
    """Run simplex iterations on tableau T (last row = objective, last col = rhs)."""
    it = 0
    bland_after = max(200, 4 * T.shape[0])
    while it < max_iter:
        obj = T[-1, :ncols]
        if it < bland_after:
            col = int(np.argmin(obj))
            if obj[col] >= -_EPS:
                return "optimal", it
        else:  # Bland's rule: smallest index with negative reduced cost
            neg = np.flatnonzero(obj < -_EPS)
            if neg.size == 0:
                return "optimal", it
            col = int(neg[0])
        ratios = np.full(T.shape[0] - 1, np.inf)
        colvals = T[:-1, col]
        pos = colvals > _EPS
        ratios[pos] = T[:-1, -1][pos] / colvals[pos]
        row = int(np.argmin(ratios))
        if not np.isfinite(ratios[row]):
            return "unbounded", it
        # tie-break by smallest basis index (helps anti-cycling)
        best = ratios[row]
        ties = np.flatnonzero(np.isclose(ratios, best, rtol=0, atol=1e-12))
        if ties.size > 1:
            row = int(ties[np.argmin(basis[ties])])
        _pivot(T, basis, row, col)
        it += 1
    return "iteration_limit", it


def solve_simplex(
    c,
    A_ub=None,
    b_ub=None,
    A_eq=None,
    b_eq=None,
    max_iter: int = 200_000,
) -> SimplexResult:
    c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    A_ub = np.zeros((0, n)) if A_ub is None else np.asarray(A_ub, dtype=np.float64)
    b_ub = np.zeros(0) if b_ub is None else np.asarray(b_ub, dtype=np.float64)
    A_eq = np.zeros((0, n)) if A_eq is None else np.asarray(A_eq, dtype=np.float64)
    b_eq = np.zeros(0) if b_eq is None else np.asarray(b_eq, dtype=np.float64)

    m_ub, m_eq = A_ub.shape[0], A_eq.shape[0]
    m_rows = m_ub + m_eq

    # Build [A | slacks | artificials | rhs]; make rhs >= 0 row-wise.
    A = np.vstack([A_ub, A_eq]) if m_rows else np.zeros((0, n))
    b = np.concatenate([b_ub, b_eq])
    c_orig = c
    A, b, c, col_scale = _equilibrate(A, b, c)
    slack_sign = np.concatenate([np.ones(m_ub), np.zeros(m_eq)])  # +1 slack for <= rows
    neg = b < 0
    A[neg] *= -1.0
    b = np.abs(b)
    slack_sign[neg[: m_ub].nonzero()[0]] = -1.0  # flipped <= becomes >= : surplus

    n_slack = m_ub
    # artificials: for eq rows and for flipped-ub rows (surplus rows need one)
    need_art = np.concatenate([neg[:m_ub], np.ones(m_eq, dtype=bool)])
    n_art = int(need_art.sum())
    ncols = n + n_slack + n_art

    T = np.zeros((m_rows + 1, ncols + 1))
    T[:m_rows, :n] = A
    T[:m_rows, -1] = b
    basis = np.empty(m_rows, dtype=np.int64)
    art_cols = []
    k = 0
    for r in range(m_rows):
        if r < m_ub:
            T[r, n + r] = slack_sign[r]
        if need_art[r]:
            col = n + n_slack + k
            T[r, col] = 1.0
            basis[r] = col
            art_cols.append(col)
            k += 1
        else:
            basis[r] = n + r  # the (+1) slack is basic
    art_cols = np.array(art_cols, dtype=np.int64)

    # ---- phase 1 ----
    if n_art:
        T[-1, art_cols] = 1.0
        for r in range(m_rows):  # price out basic artificials
            if basis[r] in art_cols:
                T[-1] -= T[r]
        status, it1 = _run(T, basis, ncols, max_iter)
        if status != "optimal":
            return SimplexResult(np.full(n, np.nan), np.nan, status, it1)
        if T[-1, -1] < -1e-7:
            return SimplexResult(np.full(n, np.nan), np.nan, "infeasible", it1)
        # drive remaining artificials out of the basis if possible
        for r in range(m_rows):
            if basis[r] in art_cols and abs(T[r, -1]) <= 1e-9:
                nonart = np.flatnonzero(np.abs(T[r, : n + n_slack]) > 1e-9)
                if nonart.size:
                    _pivot(T, basis, r, int(nonart[0]))
        T[:, art_cols] = 0.0  # freeze artificials at 0
    else:
        it1 = 0

    # ---- phase 2 ----
    T[-1, :] = 0.0
    T[-1, :n] = c
    for r in range(m_rows):  # price out basic variables
        if T[-1, basis[r]] != 0.0:
            T[-1] -= T[-1, basis[r]] * T[r]
    status, it2 = _run(T, basis, n + n_slack, max_iter)
    x = np.zeros(ncols)
    x[basis] = T[:m_rows, -1]
    xv = col_scale * x[:n]  # undo column scaling
    obj = float(c_orig @ xv)
    if status != "optimal":
        return SimplexResult(xv, obj, status, it1 + it2)
    return SimplexResult(xv, obj, "optimal", it1 + it2)
