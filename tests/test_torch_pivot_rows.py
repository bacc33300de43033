"""The premise of the pivot kernel's row skipping, on the CPU.

The kernel (``csrc/simplex_pivot.cu``) updates only the rows whose
entering-column entry pcol' is nonzero, and every row when the scaled pivot
row holds an inf or NaN.  Here a round written out in this file does the
same — it runs the dense update and then puts back every row it may skip —
and is held, round by round, to ``simplex_pivot_plain`` (the function, whose
update is dense): basis, iteration counts and statuses equal, the tableau
equal (a zero may change its sign, which equality ignores).  The stacks are
real set-up tableaux of small chain, star and returns + release buckets,
solved through both phases to the end, plus a pivot element of exactly 1
and a pivot row that holds an inf.

Also here: the lane-cluster rule, the epoch driver's entry and the
autotuner's probe stack.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.convert import to_tensor
from repro_torch.core.instance import Instance, Loads, random_instance
from repro_torch.engine import autotune
from repro_torch.engine import batched_simplex as bs
from repro_torch.engine.arena import InstanceArena
from repro_torch.engine.batched_lp import build_lp_bucket
from repro_torch.kernels import simplex_pivot, simplex_pivot_lanes, simplex_pivot_plain
from repro_torch.kernels.simplex_pivot import cluster_size


def choices(T, basis, it, status, kw):
    """One round's choices as the plain version makes them: the lanes that
    pivot, their entering column, pivot row and entering column's values."""
    B, R, _ = T.shape
    obj = T[:, -1, :kw["ncols_price"]]
    neg = obj < -1e-9
    cidx = torch.arange(obj.shape[1])
    bland = torch.where(neg, cidx, obj.shape[1]).argmin(dim=1)
    col = torch.where(it < kw["bland_after"], obj.argmin(dim=1), bland)
    pcol = T.gather(2, col[:, None, None].expand(B, R, 1))[:, :, 0]
    pos = pcol[:, :-1] > 1e-9
    ratios = torch.where(pos, T[:, :-1, -1] / torch.where(pos, pcol[:, :-1], 1.0), torch.inf)
    best = ratios.amin(dim=1)
    ties = (ratios - best[:, None]).abs() <= 1e-12
    row = torch.argmin(torch.where(ties, basis.long(), 2**31 - 1), dim=1)
    go = (status == -1) & (it < kw["max_iter"]) & neg.any(dim=1) & torch.isfinite(best)
    return go, col, row, pcol


def row_skipping_round(T, basis, it, status, kw):
    """One pivot round, in place, whose update writes only the rows with
    pcol' != 0 (every row where the scaled pivot row is not finite): it runs
    the dense update and puts the other rows back.  Returns (rows written,
    rows skipped) over the lanes that pivoted."""
    go, col, row, pcol = choices(T, basis, it, status, kw)
    active = (status == -1) & (it < kw["max_iter"])
    any_neg = (T[:, -1, :kw["ncols_price"]] < -1e-9).any(dim=1)
    written = skipped = 0
    for b in go.nonzero()[:, 0].tolist():
        r = int(row[b])
        piv = pcol[b, r]
        prow = T[b, r] / piv
        p = pcol[b].clone()
        p[r] = piv - 1.0
        dense = T[b].addcmul(p[:, None], prow[None, :], value=-1.0)
        keep = torch.zeros_like(p, dtype=torch.bool)
        if bool(torch.isfinite(prow).all()):
            keep = p == 0  # NaN != 0: a NaN entry is written
        T[b] = torch.where(keep[:, None], T[b], dense)
        basis[b, r] = col[b].to(basis.dtype)
        written += int((~keep).sum())
        skipped += int(keep.sum())
    it += go.to(it.dtype)
    # optimal without a negative reduced cost, unbounded without a finite ratio
    status.copy_(torch.where(active & ~any_neg, 0,
                             torch.where(active & any_neg & ~go, 2, status)))
    return written, skipped


def assert_states_equal(a, b):
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0, equal_nan=True)


def both_rounds(state_skip, state_plain, kw):
    """One round on each side, then the two states must be equal."""
    counts = row_skipping_round(*state_skip, kw)
    simplex_pivot_plain(*state_plain, k_pivots=1, **kw)
    assert_states_equal(state_skip, state_plain)
    return counts


def real_bucket(family, m=4, n_loads=2, q=2, B=4, seed=23):
    rng = np.random.default_rng(seed)
    ret = family.endswith("ret_rel")
    insts = []
    for _ in range(B):
        inst = random_instance(rng, m=m, n_loads=n_loads, q=q, topology=family.split("_")[0],
                               return_ratio=0.5 if ret else 0.0, with_latency=True)
        if ret:  # release dates, as the campaign draws them
            scale = float(np.mean(inst.platform.w) * inst.loads.v_comp.sum()) / inst.m
            ld = inst.loads
            inst = Instance(inst.platform, Loads(
                v_comm=ld.v_comm, v_comp=ld.v_comp, release=rng.uniform(0, 0.3 * scale, inst.N),
                return_ratio=ld.return_ratio), q=inst.q)
        insts.append(inst)
    (bucket,) = InstanceArena(insts).buckets
    return bucket


def setup(bucket):
    lp = build_lp_bucket(bucket)
    c = np.tile(lp.c, (bucket.B, 1))
    args = [to_tensor(a, "cpu", torch.float64) for a in (c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)]
    n, m_ub = c.shape[1], lp.A_ub.shape[1]
    m_rows, dummy = m_ub + lp.A_eq.shape[1], n + m_ub
    T, basis, c_s, _ = bs._setup(*args)
    kw = dict(ncols_price=dummy, bland_after=max(200, 4 * (m_rows + 1)), max_iter=20_000)
    return T, basis, c_s, n, dummy, kw


@pytest.mark.parametrize("family", ["chain", "star", "chain_ret_rel", "star_ret_rel"])
def test_row_skipping_equals_the_dense_update_on_real_tableaux(family):
    """Both phases of a real bucket to the end: at every round the
    row-skipping update gives the plain version's state, and it skips many
    rows."""
    T, basis, c_s, n, dummy, kw = setup(real_bucket(family))
    skip_side, plain_side = [T.clone(), basis.clone()], [T, basis]
    written = skipped = rounds = 0
    for phase in (1, 2):
        B = T.shape[0]
        states = [side + [torch.zeros(B, dtype=torch.int32), torch.full((B,), -1, dtype=torch.int32)]
                  for side in (skip_side, plain_side)]
        while bool(((states[1][3] == -1) & (states[1][2] < kw["max_iter"])).any()):
            w, s = both_rounds(states[0], states[1], kw)
            written, skipped, rounds = written + w, skipped + s, rounds + 1
        if phase == 1:
            for side, st in zip((skip_side, plain_side), states):
                bs._between_phases(side[0], side[1], st[3], c_s, n, dummy)
    # at m = 4 about half the rows change a round (at the §6 scale ~1%)
    assert rounds > 10 and skipped > 0.3 * (written + skipped)


def test_row_skipping_with_a_unit_pivot_leaves_the_pivot_row():
    """piv == 1.0 gives the pivot row pcol' == 0: left alone, it is still
    the dense update's T[row] / 1."""
    B, R, C = 2, 9, 17
    rng = np.random.default_rng(4)
    T = rng.uniform(0.1, 1.0, size=(B, R, C)) * (rng.random((B, R, C)) < 0.4)
    T[:, -1, :] = 0.3
    T[:, -1, 0] = -1.0
    T[:, :-1, 0] = 0.0
    T[:, 2, 0] = 1.0
    T[:, 5, 0] = -0.5
    basis = np.tile(np.arange(1, R, dtype=np.int32)[None, :], (B, 1))
    state = [torch.from_numpy(T), torch.from_numpy(basis), torch.zeros(B, dtype=torch.int32),
             torch.full((B,), -1, dtype=torch.int32)]
    kw = dict(ncols_price=C - 1, bland_after=100, max_iter=100)
    go, _, row, pcol = choices(*state, kw)
    assert bool(go.all()) and (row == 2).all() and (pcol[:, 2] == 1.0).all()
    plain = [x.clone() for x in state]
    written, skipped = both_rounds(state, plain, kw)
    assert written == 2 * B  # the -0.5 row and the objective row, not the pivot row
    assert skipped == (R - 2) * B


def test_row_skipping_with_an_inf_in_the_pivot_row_updates_every_row():
    """A non-finite scaled pivot row: the dense update writes NaN into the
    rows whose pcol' is 0, so a row-skipping update must write them all."""
    B, R, C = 2, 9, 17
    rng = np.random.default_rng(5)
    T = rng.uniform(0.1, 1.0, size=(B, R, C)) * (rng.random((B, R, C)) < 0.4)
    T[:, -1, :] = 0.3
    T[:, -1, 0] = -1.0
    T[:, :-1, 0] = 0.0
    T[:, 2, 0] = 2.0
    T[:, 2, 7] = np.inf
    basis = np.tile(np.arange(1, R, dtype=np.int32)[None, :], (B, 1))
    state = [torch.from_numpy(T), torch.from_numpy(basis), torch.zeros(B, dtype=torch.int32),
             torch.full((B,), -1, dtype=torch.int32)]
    kw = dict(ncols_price=C - 1, bland_after=100, max_iter=100)
    plain = [x.clone() for x in state]
    written, skipped = both_rounds(state, plain, kw)
    assert written == R * B and skipped == 0
    assert bool(torch.isnan(plain[0][:, :, 7]).any())


@pytest.mark.parametrize("n_lanes,sms,resident,want", [
    (1, 132, None, 16), (6, 132, None, 16), (8, 132, None, 16), (9, 132, None, 8),
    (16, 132, None, 8), (17, 132, None, 4), (33, 132, None, 4), (34, 132, None, 2),
    (64, 132, None, 2), (66, 132, None, 2), (67, 132, None, 1), (132, 132, None, 1),
    (256, 132, None, 1), (64, 114, None, 1), (8, 132, {2: 66, 4: 33, 8: 16, 16: 7}, 8),
    (6, 132, {2: 66, 4: 33, 8: 16, 16: 7}, 16), (3, 132, {2: 66, 4: 33, 8: 2, 16: 1}, 4),
])
def test_cluster_size_fills_the_card(n_lanes, sms, resident, want):
    """One block an SM: the lanes' clusters grow while they fit on the SMs
    and, where the card's count of resident clusters is given, all fit at
    once."""
    assert cluster_size(n_lanes, sms, resident and resident.get) == want


def test_lanes_entry_and_cluster_argument_on_cpu():
    """The epoch driver's entry gives the checked entry's bits on the CPU;
    a cluster size the kernel does not take is refused."""
    T, basis, _, _, _, kw = setup(real_bucket("chain", B=5))
    lanes = torch.tensor([3, 0, 4], dtype=torch.int32)
    state = [T.clone(), basis.clone(), torch.zeros(5, dtype=torch.int32),
             torch.full((5,), -1, dtype=torch.int32)]
    other = [x.clone() for x in state]
    simplex_pivot(*state, lanes=lanes, k_pivots=4, **kw)
    simplex_pivot_lanes(*other, lanes, k_pivots=4, **kw)
    assert_states_equal(state, other)
    assert (state[2][[1, 2]] == 0).all() and (state[2][[0, 3, 4]] > 0).all()
    with pytest.raises(ValueError):
        simplex_pivot(*state, cluster=3, **kw)


@pytest.mark.parametrize("family", ["chain", "star_ret_rel"])
def test_autotune_probe_stack_is_the_sparse_setup(family):
    """The probe times the bucket's own set-up lanes — as sparse as the
    tableaux the solve pivots — not a dense synthetic stack."""
    T, basis, _, _, _, kw = setup(real_bucket(family, B=6))
    probe = autotune.probe_stack(T, basis)
    n = autotune._PROBE_B
    assert torch.equal(probe[0], T[:n]) and torch.equal(probe[1], basis[:n])
    assert probe[0].data_ptr() != T.data_ptr()
    assert (probe[2] == 0).all() and (probe[3] == -1).all()
    assert (probe[0] != 0).double().mean().item() < 0.15
    autotune._CACHE.pop((T.shape[1], T.shape[2], "cpu"), None)
    before = T.clone()
    entry = autotune.pivot_schedule(T, basis, kw["ncols_price"], kw["bland_after"], kw["max_iter"])
    assert torch.equal(T, before), "the probe works on copies"
    assert entry["k_pivots"] in autotune._SWEEP
    assert entry["n_launches"] == max(1, autotune._EPOCH_PIVOTS // entry["k_pivots"])
    assert autotune.pivot_schedule(T, basis, kw["ncols_price"], kw["bland_after"],
                                   kw["max_iter"]) is entry
