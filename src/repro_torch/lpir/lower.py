"""Lowerers: turn the IR row stream into solver-specific matrix formats.

Three consumers, three lowerings — all reading the SAME row stream, so a
constraint-family change in :mod:`repro_torch.lpir.ir` propagates everywhere:

* :func:`lower_sparse`       -> COO triplets for the serial simplex / HiGHS
                                path (``core.lp.ScheduleLP``);
* :func:`lower_dense`        -> one dense ``(c, A_ub, b_ub, A_eq, b_eq)``
                                tuple for the in-tree NumPy simplex (the
                                heuristics' tiny equal-finish sub-LPs);
* :func:`lower_dense_batch`  -> stacked ``[B, R, n_vars]`` batches for the
                                batched engine simplex.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ir import ScheduleIR

__all__ = ["SparseRows", "lower_sparse", "lower_dense", "lower_dense_batch", "DenseBatch"]


@dataclasses.dataclass
class SparseRows:
    """COO triplets + rhs lists, the historical ``ScheduleLP`` storage."""

    ub_rows: list
    ub_cols: list
    ub_vals: list
    b_ub: list
    eq_rows: list
    eq_cols: list
    eq_vals: list
    b_eq: list


def lower_sparse(ir: ScheduleIR) -> SparseRows:
    """Serial lowering: scalar-coefficient IR -> COO triplets."""
    if ir.batch is not None:
        raise ValueError("lower_sparse expects a scalar (non-batched) IR")
    out = SparseRows([], [], [], [], [], [], [], [])
    for r, row in enumerate(ir.ub_rows):
        for col, v in row.terms:
            out.ub_rows.append(r)
            out.ub_cols.append(col)
            out.ub_vals.append(float(v))
        out.b_ub.append(float(row.rhs))
    for r, row in enumerate(ir.eq_rows):
        for col, v in row.terms:
            out.eq_rows.append(r)
            out.eq_cols.append(col)
            out.eq_vals.append(float(v))
        out.b_eq.append(float(row.rhs))
    return out


def lower_dense(ir: ScheduleIR):
    """Serial dense lowering: ``(c, A_ub, b_ub, A_eq, b_eq)`` for solve_simplex.

    Duplicate ``(row, col)`` terms accumulate, matching the sparse semantics.
    """
    if ir.batch is not None:
        raise ValueError("lower_dense expects a scalar (non-batched) IR")
    n = ir.n_vars
    A_ub = np.zeros((len(ir.ub_rows), n))
    b_ub = np.zeros(len(ir.ub_rows))
    for r, row in enumerate(ir.ub_rows):
        for col, v in row.terms:
            A_ub[r, col] += v
        b_ub[r] = row.rhs
    A_eq = np.zeros((len(ir.eq_rows), n))
    b_eq = np.zeros(len(ir.eq_rows))
    for r, row in enumerate(ir.eq_rows):
        for col, v in row.terms:
            A_eq[r, col] += v
        b_eq[r] = row.rhs
    return ir.c, A_ub, b_ub, A_eq, b_eq


@dataclasses.dataclass
class DenseBatch:
    """Batched dense lowering output — what the batched simplex consumes."""

    c: np.ndarray  # [n_vars] (batch-constant objective pattern)
    A_ub: np.ndarray  # [B, R, n_vars]
    b_ub: np.ndarray  # [B, R]
    A_eq: np.ndarray  # [B, E, n_vars]
    b_eq: np.ndarray  # [B, E]
    ub_kinds: list  # [R] family tag per ub row (elision regression tests)


def lower_dense_batch(ir: ScheduleIR) -> DenseBatch:
    """Batched lowering: ``[B]``-coefficient IR -> stacked dense matrices.

    Each term writes its (scalar-or-[B]) coefficient for the whole batch in
    one vectorized assignment — the same access pattern as the historical
    ``engine.batched_lp`` builder, so the batched path keeps its throughput.
    """
    B = ir.batch
    if B is None:
        raise ValueError("lower_dense_batch expects a batched IR")
    n = ir.n_vars
    R, E = len(ir.ub_rows), len(ir.eq_rows)
    A_ub = np.zeros((B, R, n))
    b_ub = np.zeros((B, R))
    for r, row in enumerate(ir.ub_rows):
        for col, v in row.terms:
            A_ub[:, r, col] += v
        b_ub[:, r] = row.rhs
    A_eq = np.zeros((B, E, n))
    b_eq = np.zeros((B, E))
    for r, row in enumerate(ir.eq_rows):
        for col, v in row.terms:
            A_eq[:, r, col] += v
        b_eq[:, r] = row.rhs
    return DenseBatch(
        c=ir.c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
        ub_kinds=[row.kind for row in ir.ub_rows],
    )
