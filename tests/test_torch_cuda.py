"""The port's CUDA kernels on the card, held against their plain versions
on the same card, and the engine and the serving paths on the card against
the same on the CPU.

These need an NVIDIA card and ``nvcc``; elsewhere they skip (the fixture
decides at run time, so every xdist worker collects the same tests).  On the
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from repro_torch.core.instance import random_instance
from repro_torch.kernels import (asap_replay, asap_replay_plain, decode_attention,
                                 decode_attention_plain, flash_attention, flash_attention_plain,
                                 launch_counts, reset_launch_counts, rms_norm, rms_norm_plain,
                                 simplex_pivot, simplex_pivot_lanes, simplex_pivot_plain,
                                 ssd_scan, ssd_scan_plain, ssd_scan_tolerance, updated_elements)
from repro_torch.kernels.decode_attention import decode_cluster_on, decode_split
from repro_torch.kernels.ssd_scan import pick_chunk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available() or shutil.which("nvcc") is None:
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernels are built from source)")
    return torch.device("cuda")


def _stack(rng, B, R, C):
    T = rng.uniform(0.1, 1.0, size=(B, R, C))
    T[:, -1, :] = rng.uniform(-1.0, 0.5, size=(B, C))
    T[:, :, -1] = rng.uniform(0.5, 1.5, size=(B, R))
    basis = np.stack([rng.permutation(C - 1)[: R - 1] for _ in range(B)]).astype(np.int32)
    it = np.zeros(B, np.int32)
    status = np.full(B, -1, np.int32)
    status[1] = 0
    it[2] = 5
    return [torch.from_numpy(a) for a in (T, basis, it, status)]


# The pivot kernel is held to the plain version run on the CPU: there its
# update is one fused multiply-add per element, the function's definition
# (bit for bit the reference's, tests/test_torch_kernels.py), while on the
# card PyTorch's addcmul rounds the product before the sum, an ulp away.
def plain_on_cpu(base, **kw):
    return simplex_pivot_plain(*[x.detach().cpu().clone() for x in base], **kw)


def assert_pivots_equal(kern, plain):
    """The kernel's basis, it and status equal the plain version's, and its
    tableau differs by exactly 0 (NaN where the plain version has NaN)."""
    kern, plain = [x.cpu() for x in kern], [x.cpu() for x in plain]
    for a, b in zip(kern[1:], plain[1:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(kern[0], plain[0], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("k_pivots", [1, 4, 64])
@pytest.mark.parametrize("shape", [(4, 7, 13), (3, 300, 700), (5, 301, 701)])
def test_simplex_pivot_kernel_matches_plain_on_card(card, shape, k_pivots):
    base = _stack(np.random.default_rng(sum(shape)), *shape)
    kw = dict(ncols_price=shape[2] - 1, bland_after=3, max_iter=50, k_pivots=k_pivots)
    plain = plain_on_cpu(base, **kw)
    reset_launch_counts()
    kern = simplex_pivot(*[x.to(card) for x in base], **kw)
    torch.cuda.synchronize()
    assert launch_counts()["simplex_pivot"] == 1
    assert_pivots_equal(kern, plain)


def _sparse_stack(rng, B, R, C, density):
    """A stack whose columns are mostly exact zeros, a share of them -0.0,
    with a dense objective row and rhs column, so that the entering columns
    hold both zeros."""
    T = rng.uniform(0.1, 1.0, size=(B, R, C)) * (rng.random((B, R, C)) < density)
    T = np.where((T == 0) & (rng.random((B, R, C)) < 0.5), -0.0, T)
    T[:, -1, :] = rng.uniform(-1.0, 0.5, size=(B, C))
    T[:, :, -1] = rng.uniform(0.5, 1.5, size=(B, R))
    basis = np.stack([rng.permutation(C - 1)[: R - 1] for _ in range(B)]).astype(np.int32)
    return [torch.from_numpy(a) for a in (T, basis, np.zeros(B, np.int32),
                                          np.full(B, -1, np.int32))]


def _rows_changed(T, basis, it, status, kw):
    """Elements a row-skipping update of one round must write: for every
    lane that pivots, C for each row whose pcol' is nonzero, all R rows'
    worth when the scaled pivot row is not finite (the plain version's
    choices, written out)."""
    B, R, C = T.shape
    obj = T[:, -1, :kw["ncols_price"]]
    neg = obj < -1e-9
    cidx = torch.arange(obj.shape[1], device=T.device)
    bland = torch.where(neg, cidx, obj.shape[1]).argmin(dim=1)
    col = torch.where(it < kw["bland_after"], obj.argmin(dim=1), bland)
    pcol = T.gather(2, col[:, None, None].expand(B, R, 1))[:, :, 0]
    pos = pcol[:, :-1] > 1e-9
    ratios = torch.where(pos, T[:, :-1, -1] / torch.where(pos, pcol[:, :-1], 1.0), torch.inf)
    best = ratios.amin(dim=1)
    ties = (ratios - best[:, None]).abs() <= 1e-12
    row = torch.argmin(torch.where(ties, basis.long(), 2**31 - 1), dim=1)
    go = ((status == -1) & (it < kw["max_iter"]) & neg.any(dim=1) & torch.isfinite(best))
    total = 0
    for b in go.nonzero()[:, 0].tolist():
        piv = pcol[b, row[b]]
        p = pcol[b].clone()
        p[row[b]] = piv - 1.0
        dense = not bool(torch.isfinite(T[b, row[b]] / piv).all())
        total += C * (R if dense else int((p != 0).sum()))
    return total


@pytest.mark.parametrize("k_pivots", [1, 4, 64])
@pytest.mark.parametrize("density", [0.02, 0.2])
@pytest.mark.parametrize("shape", [(6, 40, 81), (4, 301, 701)])
def test_simplex_pivot_kernel_sparse_stacks_on_card(card, shape, density, k_pivots):
    """Entering columns of exact zeros and -0.0: the kernel skips those rows
    and still gives the plain version's bits; one round writes exactly the
    rows a nonzero pcol' names."""
    base = _sparse_stack(np.random.default_rng(sum(shape) + int(100 * density)), *shape,
                         density)
    kw = dict(ncols_price=shape[2] - 1, bland_after=3, max_iter=200)
    want = _rows_changed(*[x.to(card) for x in base], kw)
    reset_launch_counts()
    one = simplex_pivot(*[x.to(card) for x in base], k_pivots=1, **kw)
    assert updated_elements() == want > 0
    assert_pivots_equal(one, plain_on_cpu(base, k_pivots=1, **kw))
    plain = plain_on_cpu(base, k_pivots=k_pivots, **kw)
    kern = simplex_pivot(*[x.to(card) for x in base], k_pivots=k_pivots, **kw)
    torch.cuda.synchronize()
    assert_pivots_equal(kern, plain)


def _unit_pivot_stack(B, R, C):
    """Every lane's entering column is column 0 (the objective row's only
    negative entry) and its pivot element is exactly 1.0."""
    rng = np.random.default_rng(R + C)
    T = rng.uniform(0.1, 1.0, size=(B, R, C)) * (rng.random((B, R, C)) < 0.3)
    T[:, -1, :] = rng.uniform(0.1, 0.5, size=(B, C))
    T[:, -1, 0] = -1.0
    T[:, :, -1] = rng.uniform(0.5, 1.5, size=(B, R))
    T[:, :-1, 0] = 0.0
    for b in range(B):
        T[b, b % (R - 1), 0] = 1.0
        T[b, (b + 1) % (R - 1), 0] = -0.5
    basis = np.tile(np.arange(1, R, dtype=np.int32)[None, :], (B, 1))
    return [torch.from_numpy(a) for a in (T, basis, np.zeros(B, np.int32),
                                          np.full(B, -1, np.int32))]


@pytest.mark.parametrize("cluster", [1, 4])
def test_simplex_pivot_kernel_unit_pivot_on_card(card, cluster):
    """piv == 1.0 makes the pivot row's pcol' 0: the kernel leaves that row
    alone (T[row] / 1 == T[row]) and updates only the other nonzero rows."""
    B, R, C = 3, 50, 91
    base = _unit_pivot_stack(B, R, C)
    kw = dict(ncols_price=C - 1, bland_after=100, max_iter=100, k_pivots=1)
    reset_launch_counts()
    plain = plain_on_cpu(base, **kw)
    kern = simplex_pivot(*[x.to(card) for x in base], cluster=cluster, **kw)
    torch.cuda.synchronize()
    assert_pivots_equal(kern, plain)
    assert torch.equal(kern[2].cpu(), torch.ones(B, dtype=torch.int32))
    assert updated_elements() == B * 2 * C  # the -0.5 row and the objective row


def _diagonal_stack(B, R, C):
    """Lanes that pivot four times, on columns 0-3 in turn (Bland's rule:
    the first negative reduced cost), each pivot element 2.0 on the
    diagonal; lane b's first pivot row holds an inf at column 7 + 30 b."""
    rng = np.random.default_rng(R * C)
    T = rng.uniform(0.1, 1.0, size=(B, R, C)) * (rng.random((B, R, C)) < 0.3)
    T[:, :, :4] = 0.0
    for k in range(4):
        T[:, k, k] = 2.0
        T[:, 5 + k, k] = -0.5
    T[:, -1, :] = 0.3
    T[:, -1, :4] = [-1.0, -0.9, -0.8, -0.7]
    T[:, :, -1] = rng.uniform(0.5, 1.5, size=(B, R))
    for b in range(B):
        T[b, 0, 7 + 30 * b] = np.inf
    basis = np.tile(np.arange(4, R + 3, dtype=np.int32)[None, :], (B, 1))
    return [torch.from_numpy(a) for a in (T, basis, np.zeros(B, np.int32),
                                          np.full(B, -1, np.int32))]


@pytest.mark.parametrize("k_pivots", [1, 4])
@pytest.mark.parametrize("cluster", [1, 8])
def test_simplex_pivot_kernel_nonfinite_pivot_row_on_card(card, cluster, k_pivots):
    """An inf in the pivot row: the dense update writes NaN into every row
    whose pcol' is 0 at that column, and so must the kernel (its block whose
    slice holds the inf updates every row); the next pivot rows hold that
    NaN, so every round here takes that branch."""
    B, R, C = 3, 50, 91
    base = _diagonal_stack(B, R, C)
    kw = dict(ncols_price=C - 1, bland_after=0, max_iter=100, k_pivots=k_pivots)
    plain = plain_on_cpu(base, **kw)
    kern = simplex_pivot(*[x.to(card) for x in base], cluster=cluster, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isnan(plain[0]).any()), "the case must reach the NaN"
    assert (plain[2] == k_pivots).all(), "every lane pivots in every round"
    assert_pivots_equal(kern, plain)


def _solve_both_phases(card, bucket, k_pivots):
    """Both phases of a real bucket's set-up stack to the end, the kernel
    and the plain version (on the CPU) launch for launch, compared after
    every launch.  The set-up and the step between the phases run once, on
    the CPU, and the card's side starts each phase from a copy."""
    from repro_torch.convert import to_tensor
    from repro_torch.engine import batched_simplex as bs
    from repro_torch.engine.batched_lp import build_lp_bucket

    lp = build_lp_bucket(bucket)
    c = np.tile(lp.c, (bucket.B, 1))
    args = [to_tensor(a, "cpu", torch.float64) for a in (c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)]
    n, m_ub = c.shape[1], lp.A_ub.shape[1]
    m_rows, dummy = m_ub + lp.A_eq.shape[1], n + m_ub
    kw = dict(ncols_price=dummy, bland_after=max(200, 4 * (m_rows + 1)), max_iter=20_000,
              k_pivots=k_pivots)
    T, basis, c_s, _ = bs._setup(*args)
    pivots = 0
    for phase in (1, 2):
        B = T.shape[0]
        plain = [T, basis, torch.zeros(B, dtype=torch.int32), torch.full((B,), -1, dtype=torch.int32)]
        kern = [x.to(card) for x in plain]
        while bool(((plain[3] == -1) & (plain[2] < kw["max_iter"])).any()):
            simplex_pivot(*kern, **kw)
            simplex_pivot_plain(*plain, **kw)
            assert_pivots_equal(kern, plain)
        pivots += int(plain[2].sum())
        if phase == 1:
            bs._between_phases(T, basis, plain[3], c_s, n, dummy)
    return pivots


@pytest.mark.parametrize("k_pivots", [1, 4, 64])
@pytest.mark.parametrize("family", ["chain", "star", "chain_ret_rel", "star_ret_rel"])
def test_simplex_pivot_kernel_real_tableaux_to_the_end_on_card(card, family, k_pivots):
    """Set-up tableaux of real buckets (m = 4, 2 loads, q = 2), both phases
    to the end: every launch equals the plain version's."""
    from repro_torch.core.instance import Instance, Loads
    from repro_torch.engine.arena import InstanceArena

    rng = np.random.default_rng(17)
    ret = family.endswith("ret_rel")
    insts = []
    for _ in range(6):
        inst = random_instance(rng, m=4, n_loads=2, q=2, topology=family.split("_")[0],
                               return_ratio=0.5 if ret else 0.0, with_latency=True)
        if ret:  # release dates, as the campaign draws them
            scale = float(np.mean(inst.platform.w) * inst.loads.v_comp.sum()) / inst.m
            ld = inst.loads
            inst = Instance(inst.platform, Loads(
                v_comm=ld.v_comm, v_comp=ld.v_comp, release=rng.uniform(0, 0.3 * scale, inst.N),
                return_ratio=ld.return_ratio), q=inst.q)
        insts.append(inst)
    (bucket,) = InstanceArena(insts).buckets
    assert _solve_both_phases(card, bucket, k_pivots) > 0


@pytest.mark.parametrize("n_lanes", [1, 5, 12, 20, 40, 100, 140])
def test_simplex_pivot_kernel_cluster_sizes_on_card(card, n_lanes):
    """Lane lists of every length class launch every cluster size (16, 16,
    8, 4, 2, 1 and 1 blocks a lane on a 132-SM card), and each equals the
    plain version; so does an explicit 16-block cluster."""
    from repro_torch.kernels.simplex_pivot import cluster_size

    B, R, C = 150, 64, 201
    base = _sparse_stack(np.random.default_rng(n_lanes), B, R, C, 0.1)
    rng = np.random.default_rng(n_lanes + 1)
    lanes = torch.from_numpy(np.sort(rng.choice(B, n_lanes, replace=False)).astype(np.int32))
    kw = dict(ncols_price=C - 1, bland_after=30, max_iter=200, k_pivots=16)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    reset_launch_counts()
    kern = simplex_pivot(*[x.to(card) for x in base], lanes=lanes.to(card), **kw)
    plain = plain_on_cpu(base, lanes=lanes, **kw)
    torch.cuda.synchronize()
    want = {1: 16, 5: 16, 12: 8, 20: 4, 40: 2, 100: 1, 140: 1}[n_lanes] if sms == 132 else None
    assert simplex_pivot.clusters == {want or cluster_size(n_lanes, sms): 1}
    assert_pivots_equal(kern, plain)
    wide = simplex_pivot(*[x.to(card) for x in base], lanes=lanes.to(card), cluster=16, **kw)
    torch.cuda.synchronize()
    assert_pivots_equal(wide, plain)


def test_simplex_pivot_lanes_entry_on_card(card):
    """The epoch driver's entry (no host check of the lane ids) gives the
    checked entry's bits, and the kernel ignores an id outside the stack."""
    base = _sparse_stack(np.random.default_rng(3), 8, 40, 81, 0.1)
    kw = dict(ncols_price=80, bland_after=30, max_iter=200, k_pivots=4)
    lanes = torch.tensor([6, 1, 3], dtype=torch.int32, device=card)
    want = simplex_pivot(*[x.to(card) for x in base], lanes=lanes, **kw)
    got = simplex_pivot_lanes(*[x.to(card) for x in base], lanes, **kw)
    torch.cuda.synchronize()
    assert_pivots_equal(got, want)
    stray = simplex_pivot_lanes(*[x.to(card) for x in base],
                                torch.tensor([6, 8, -1, 1, 3], dtype=torch.int32, device=card),
                                **kw)
    torch.cuda.synchronize()
    assert_pivots_equal(stray, want)


def _replay_case(rng, B, m, T, with_ret):
    """Replay inputs on the CPU, the last cell padded when T > 1 (masked by
    ``valid``; its fractions left nonzero, so the mask is all that zeroes its
    links' durations)."""
    valid = np.ones(T)
    if T > 1:
        valid[-1] = 0.0
    gamma = rng.uniform(0.0, 1.0, size=(B, m, T))
    args = [rng.uniform(0.1, 1.0, size=(B, m, T)), rng.uniform(0.1, 1.0, size=(B, m - 1)),
            rng.uniform(0.0, 0.1, size=(B, m - 1)), rng.uniform(0.0, 1.0, size=(B, m)),
            rng.uniform(1.0, 2.0, size=(B, T)), rng.uniform(1.0, 2.0, size=(B, T)),
            rng.uniform(0.0, 1.0, size=(B, T)), valid, gamma]
    ret = rng.uniform(0, 1, size=(B, T)) if with_ret else None
    return [torch.from_numpy(a) for a in args], None if ret is None else torch.from_numpy(ret)


def _replay_both(card, args, ret, topology):
    targs = [a.to(card) for a in args]
    tret = None if ret is None else ret.to(card)
    want = asap_replay_plain(*targs, tret, topology=topology)
    got = asap_replay(*targs, tret, topology=topology)
    torch.cuda.synchronize()
    return got, want


REPLAY_B = (1, 63, 64, 257)  # 257: one block past a multiple of 64


# m 16 is the largest with the carries in registers; 20 keeps them in shared
# memory.  T 32 with m 16 is the warm-hit path's ladder rung.
@pytest.mark.parametrize("with_ret", [False, True])
@pytest.mark.parametrize("topology", ["chain", "star"])
@pytest.mark.parametrize("T", [1, 6, 25, 32])
@pytest.mark.parametrize("m", [1, 4, 10, 16, 20])
def test_asap_replay_kernel_matches_plain_on_card(card, topology, with_ret, m, T):
    if with_ret and m == 1:
        pytest.skip("the return phase needs a link")
    B = REPLAY_B[(m + T) % len(REPLAY_B)]
    args, ret = _replay_case(np.random.default_rng(100 * m + T), B, m, T, with_ret)
    got, want = _replay_both(card, args, ret, topology)
    for g, w in zip(got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0)


@pytest.mark.parametrize("B", REPLAY_B)
def test_asap_replay_kernel_batch_sizes_on_card(card, B):
    args, ret = _replay_case(np.random.default_rng(B), B, 10, 25, True)
    got, want = _replay_both(card, args, ret, "chain")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=0)


def test_asap_replay_kernel_grid_stride_on_card(card):
    """More instances than the grid has blocks (16 an SM): blocks loop."""
    B = 16 * torch.cuda.get_device_properties(card).multi_processor_count * 2 + 5
    args, ret = _replay_case(np.random.default_rng(5), B, 3, 4, True)
    got, want = _replay_both(card, args, ret, "star")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=0)


@pytest.mark.parametrize("with_ret", [False, True])
@pytest.mark.parametrize("topology", ["chain", "star"])
@pytest.mark.parametrize("m", [4, 20])
def test_asap_replay_kernel_nan_lanes_on_card(card, topology, with_ret, m):
    """Lanes with a NaN fraction come back NaN where the plain version is
    NaN, makespan included; the other lanes are exactly the plain version's."""
    B, T = 64, 6
    args, ret = _replay_case(np.random.default_rng(m), B, m, T, with_ret)
    nan_lanes = [3, 17, 40]
    for k, b in enumerate(nan_lanes):
        args[-1][b, k % m, k] = float("nan")
    got, want = _replay_both(card, args, ret, topology)
    assert torch.isnan(got[-1][nan_lanes]).all()
    assert torch.isfinite(got[-1]).sum() == B - len(nan_lanes)
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0, equal_nan=True)


def test_asap_replay_outputs_come_back_in_one_copy_on_card(card):
    from repro_torch.kernels.asap_replay import outputs_to_numpy

    for m, with_ret in ((1, False), (5, True)):
        args, ret = _replay_case(np.random.default_rng(m), 7, m, 4, with_ret)
        got, _ = _replay_both(card, args, ret, "chain")
        host = outputs_to_numpy(got)
        for h, g in zip(host, got):
            assert (h is None) == (g is None)
            if g is not None:
                np.testing.assert_array_equal(h, g.cpu().numpy())
    with pytest.raises(ValueError):  # not laid end to end: rs and re left out
        outputs_to_numpy((*got[:4], None, None, got[6]))


def test_solve_bulk_on_card_matches_cpu(card):
    from repro_torch.engine import solve_bulk

    rng = np.random.default_rng(3)
    insts = [random_instance(rng, m=4, n_loads=2, q=2, topology=t, return_ratio=r,
                             with_latency=True)
             for t in ("chain", "star") for r in (0.0, 0.5) for _ in range(3)]
    reset_launch_counts()
    gpu = solve_bulk(insts)
    counts = launch_counts()
    cpu = solve_bulk(insts, device="cpu")
    assert counts["simplex_pivot"] > 0 and counts["asap_replay"] > 0
    for g, c in zip(gpu, cpu):
        assert g.ok and g.backend == "cuda"
        assert abs(g.makespan - c.makespan) <= 1e-9 * c.makespan


# float32: the same function with sums in another order; bfloat16: inputs and
# outputs rounded to bfloat16 (the kernel and the plain version both compute
# in float32 in between)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KVH, D, causal, window)
    (2, 512, 512, 24, 8, 128, True, 0),
    (4, 512, 512, 25, 5, 64, True, 1024),  # hymba-1.5b's heads and window
    (1, 500, 500, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 2, 32, True, 96),
    (1, 130, 200, 8, 8, 16, False, 0),
    # the edges of the TMA-fed tiles: one row or key, one past a 64-row tile
    # (rows and keys zero-filled past the end), a window of 1, Sq != Sk at
    # the smallest head dim
    (1, 1, 1, 4, 2, 64, True, 0),
    (1, 65, 65, 4, 2, 128, True, 0),
    (1, 65, 1, 4, 2, 64, False, 0),
    (1, 1, 65, 4, 2, 64, False, 0),
    (2, 100, 100, 4, 4, 64, True, 1),
    (1, 70, 150, 4, 2, 16, True, 0),
    # head dim 256: paligemma-3b's prefill (8 query heads on 1 kv head),
    # the edges of its tiles, no mask, a window (flash_attention_d256_kernel:
    # 64-row q tiles, float32 after the split kernel)
    (4, 512, 512, 8, 1, 256, True, 0),
    (1, 1, 1, 4, 2, 256, True, 0),
    (1, 65, 65, 4, 2, 256, True, 0),
    (1, 100, 130, 8, 8, 256, False, 0),
    (2, 200, 200, 8, 1, 256, True, 64),
    # Sk no kv tile divides (32 float32, 64 bfloat16) past a causal
    # diagonal, a q-tile edge (64 + 64 + 1 rows), two waves of blocks at
    # paligemma-3b's heads
    (2, 77, 203, 8, 1, 256, True, 0),
    (1, 129, 129, 8, 1, 256, True, 0),
    (4, 1024, 1024, 8, 1, 256, True, 0),
    # head dims run at the next instantiated width (columns past D read as
    # zeros, o's D columns written): kimi-k2-1t-a32b's prefill (64 heads on
    # 8 kv heads of 112), 8 : 1 GQA ragged, with a window, Sq != Sk unmasked;
    # 80 (a float32 row's last 32-column slice wholly past D), 48 and 96
    (4, 512, 512, 64, 8, 112, True, 0),
    (1, 500, 500, 8, 1, 112, True, 0),
    (2, 256, 256, 8, 1, 112, True, 96),
    (1, 130, 200, 8, 8, 112, False, 0),
    (1, 65, 65, 4, 2, 80, True, 0),
    (1, 500, 500, 8, 1, 80, True, 0),
    (2, 300, 300, 8, 1, 80, True, 64),
    (1, 200, 200, 4, 2, 48, True, 0),
    (1, 200, 200, 8, 1, 96, True, 32),
    # any head dim up to 256: 8 (width 16); SigLIP-so400m's 16 heads of 72
    # and 100 (width 128; bfloat16 at 100 is a layout TMA cannot address, so
    # the wrapper pads a copy); 192 and 200 on the head-dim-256 kernels;
    # ragged, a window, GQA, unmasked Sq != Sk
    (4, 512, 512, 16, 16, 72, True, 0),
    (1, 130, 200, 8, 8, 72, False, 0),
    (2, 300, 300, 8, 2, 72, True, 64),
    (1, 500, 500, 8, 1, 100, True, 0),
    (2, 256, 256, 4, 2, 100, True, 96),
    (1, 65, 65, 4, 2, 8, True, 0),
    (2, 200, 200, 8, 1, 8, True, 32),
    (4, 512, 512, 8, 1, 192, True, 0),
    (1, 77, 203, 8, 1, 192, True, 0),
    (2, 200, 200, 8, 1, 192, True, 64),
    (1, 100, 130, 8, 8, 200, False, 0),
    (1, 129, 129, 8, 1, 200, True, 0),
    # odd head dims: rows of 28 / 14 bytes (7) and 520 / 260, 524 / 262 (130,
    # 131), copied into rows padded to 16 bytes
    (1, 100, 100, 4, 2, 7, True, 0),
    (1, 100, 100, 8, 1, 130, True, 0),
    (1, 70, 150, 4, 2, 131, True, 32),
])
def test_flash_attention_kernel_matches_plain_on_card(card, case, dtype):
    B, Sq, Sk, H, KVH, D, causal, window = case
    g = torch.Generator(device=card).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(s, generator=g, device=card).to(dtype)
               for s in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1 and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_d256_back_to_back_shapes_on_card(card, dtype):
    """Calls at head dim 256 with other shapes in a row, each against its
    plain version: a workspace sized or laid out for the call before (float32
    splits K and V into one each call) would show as a wrong output."""
    shapes = [(4, 512, 512, 8, 1), (1, 100, 300, 4, 2), (2, 64, 40, 8, 1), (4, 512, 512, 8, 1)]
    outs = []
    for i, (B, Sq, Sk, H, KVH) in enumerate(shapes):
        g = torch.Generator(device=card).manual_seed(100 + i)
        q, k, v = (torch.randn(s, generator=g, device=card).to(dtype)
                   for s in ((B, Sq, H, 256), (B, Sk, KVH, 256), (B, Sk, KVH, 256)))
        causal = Sq == Sk
        outs.append((flash_attention(q, k, v, causal=causal),
                     flash_attention_plain(q, k, v, causal=causal)))
    torch.cuda.synchronize()
    for got, want in outs:
        assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [128, 112, 80, 8, 72, 100, 192, 200])
def test_flash_attention_kernel_reads_a_fused_projection_on_card(card, D, dtype):
    """q, k and v as strided views into one [B, S, (H + 2 KVH) D] projection,
    as a model with a fused QKV weight hands them over: the tensor maps
    read them in place (or, where the strides are no multiple of 16 bytes,
    as bfloat16's at 100, a padded copy).  At 112, 80, 8, 72, 100, 192 and
    200 (run at width 16, 128 or 256) the maps stop at D, so no column of
    the next head is read, and the output's rows hold only D columns: a
    store past them would write the next head's."""
    B, S, H, KVH = 2, 200, 8, 2
    g = torch.Generator(device=card).manual_seed(7)
    qkv = torch.randn(B, S, (H + 2 * KVH) * D, generator=g, device=card).to(dtype)
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + KVH) * D].view(B, S, KVH, D)
    v = qkv[..., (H + KVH) * D:].view(B, S, KVH, D)
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (heads, S, window, row blocks): a model axis's ranks' rows at their
    # q_offset; hymba-1.5b's window over 4 ranks of a 2,048 prompt, blocks
    # no tile divides, a block of one row
    ((24, 8, 128), 512, 0, (0, 128, 256, 384)),
    ((25, 5, 64), 2048, 1024, (0, 512, 1024, 1536)),
    ((24, 8, 128), 512, 96, (0, 1, 130, 511)),
    ((8, 1, 256), 512, 96, (0, 37, 300)),
    ((8, 1, 256), 2048, 1024, (0, 512, 1024, 1536)),
    ((64, 8, 112), 512, 0, (0, 128, 256, 384)),  # kimi-k2-1t-a32b's heads
    ((8, 1, 80), 300, 64, (0, 77, 150)),
    ((16, 16, 72), 512, 0, (0, 128, 256, 384)),  # SigLIP-so400m's heads
    ((8, 2, 100), 300, 64, (0, 77, 150)),
    ((8, 1, 192), 512, 0, (0, 128, 256, 384)),
    ((8, 1, 200), 300, 64, (0, 77, 150)),
    ((4, 2, 8), 300, 0, (0, 1, 150)),
])
def test_flash_attention_rows_at_their_offset_on_card(card, case, dtype):
    """Each row block of q (a strided view) run alone with its
    ``q_offset`` against the whole K and V equals the plain version's rows."""
    (H, KVH, D), S, window, cuts = case
    g = torch.Generator(device=card).manual_seed(S + window)
    q, k, v = (torch.randn(s, generator=g, device=card).to(dtype)
               for s in ((2, S, H, D), (2, S, KVH, D), (2, S, KVH, D)))
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    for a, b in zip(cuts, (*cuts[1:], S)):
        got = flash_attention(q[:, a:b], k, v, causal=True, window=window, q_offset=a)
        assert (got.float() - want[:, a:b].float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("cache_len", [1, 77, 151, 300])
@pytest.mark.parametrize("heads", [(24, 8, 128), (25, 5, 64), (8, 1, 256), (64, 8, 112),
                                   (8, 1, 80), (16, 16, 72), (8, 2, 100), (8, 1, 192),
                                   (8, 1, 200), (4, 2, 8)])
def test_decode_attention_cache_shards_merged_on_card(card, heads, cache_len, window, dtype):
    """A 300-entry cache in four shards at their ``kv_start``, each with its
    ``lse``, merged as the model merges the ranks': the plain version's
    output; each shard's output and lse its plain version's, a shard with
    no valid entry 0 and -1e30."""
    from repro_torch.models.attention import merge_splits

    H, KVH, D = heads
    g = torch.Generator(device=card).manual_seed(cache_len + window)
    q, kc, vc = (torch.randn(s, generator=g, device=card).to(dtype)
                 for s in ((3, 1, H, D), (3, 300, KVH, D), (3, 300, KVH, D)))
    n = torch.tensor([cache_len], dtype=torch.int32, device=card)
    parts, plain = [], []
    for a in range(0, 300, 75):
        args = (q, kc[:, a:a + 75], vc[:, a:a + 75], n)
        parts.append(decode_attention(*args, window=window, kv_start=a, with_lse=True))
        plain.append(decode_attention_plain(*args, window=window, kv_start=a, with_lse=True))
    lse = torch.stack([p[1] for p in parts])
    got = merge_splits(lse, torch.ones_like(lse), torch.stack([p[0][:, 0].float()
                                                               for p in parts]))
    want = decode_attention_plain(q, kc, vc, n, window=window)
    torch.cuda.synchronize()
    assert (got[:, None] - want.float()).abs().max().item() <= ATTN_TOL[dtype]
    for (o, l), (po, pl) in zip(parts, plain):
        assert (o.float() - po.float()).abs().max().item() <= ATTN_TOL[dtype]
        assert (l - pl).abs().max().item() <= 1e-4 and torch.isfinite(l).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("cache_len", [1, 63, 64, 300, 544])
# llama3.2-3b's, hymba-1.5b's, paligemma-3b's, kimi-k2-1t-a32b's heads; head
# dim 80; SigLIP-so400m's 72; 100 (bfloat16 rows of 200 bytes: 8-byte pieces),
# 192 and 200 on the cluster kernel, 8; odd ones, whose rows take the
# narrower copies: 7 (4-byte pieces in float32, plain loads in bfloat16), and
# on the cluster kernel 130 (8 / 4-byte pieces) and 131 (4-byte / plain)
@pytest.mark.parametrize("heads", [(24, 8, 128), (25, 5, 64), (8, 1, 256), (64, 8, 112),
                                   (8, 1, 80), (16, 16, 72), (8, 2, 100), (8, 1, 192),
                                   (8, 1, 200), (4, 2, 8), (4, 2, 7), (8, 1, 130),
                                   (8, 1, 131)])
def test_decode_attention_kernel_matches_plain_on_card(card, heads, cache_len, window, dtype):
    B, Smax = 4, 544
    H, KVH, D = heads
    g = torch.Generator(device=card).manual_seed(cache_len + window)
    q, kc, vc = (torch.randn(s, generator=g, device=card).to(dtype)
                 for s in ((B, 1, H, D), (B, Smax, KVH, D), (B, Smax, KVH, D)))
    n = torch.tensor([cache_len], dtype=torch.int32, device=card)
    reset_launch_counts()
    got = decode_attention(q, kc, vc, n, window=window)
    want = decode_attention_plain(q, kc, vc, n, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == 1 and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# llama3.2-3b's, hymba-1.5b's, paligemma-3b's, kimi-k2-1t-a32b's heads; head
# dims 80, 72, 100, 192
@pytest.mark.parametrize("heads", [(24, 8, 128), (25, 5, 64), (8, 1, 256), (64, 8, 112),
                                   (8, 1, 80), (16, 16, 72), (8, 2, 100), (8, 1, 192)])
def test_decode_attention_kernel_at_split_boundaries_on_card(card, heads, dtype):
    """A cache of 550 entries, which no split (a multiple of 16) divides;
    cache lengths on either side of the first and third split boundaries;
    every call of a window enqueued back to back on the one workspace, so
    a combine counter left unreset would leave an output unwritten.  Head
    dim 256 has no split, workspace or counter: there these lengths only
    hold the cluster kernel to its plain version (its shares' edges are
    test_decode_attention_d256_kernel_on_card's)."""
    B, Smax = 4, 550
    H, KVH, D = heads
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    split = decode_split(B, KVH, H // KVH, Smax, n_sms)
    assert Smax % split
    g = torch.Generator(device=card).manual_seed(split)
    q, kc, vc = (torch.randn(s, generator=g, device=card).to(dtype)
                 for s in ((B, 1, H, D), (B, Smax, KVH, D), (B, Smax, KVH, D)))
    lens = [split - 1, split, split + 1, 3 * split - 1, 3 * split, 3 * split + 1, Smax, 1]
    for window in (0, split + 3):
        ns = [torch.tensor([n], dtype=torch.int32, device=card) for n in lens]
        reset_launch_counts()
        got = [decode_attention(q, kc, vc, n, window=window) for n in ns]
        assert launch_counts()["decode_attention"] == len(lens)
        for n, out in zip(ns, got):
            want = decode_attention_plain(q, kc, vc, n, window=window)
            err = (out.float() - want.float()).abs().max().item()
            assert err <= ATTN_TOL[dtype], (n.item(), window, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [257, 320, 512])
def test_attention_kernels_refuse_other_head_dims_before_a_launch_on_card(card, D, dtype):
    """A head dim outside the kernels' rule (1 to 256) raises ValueError on
    the card, naming the head dims taken, before any launch: nothing falls
    back to the plain version."""
    q, k = (torch.zeros(s, device=card, dtype=dtype) for s in ((2, 64, 8, D), (2, 64, 2, D)))
    reset_launch_counts()
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="head dims"):
        decode_attention(q[:, :1], k, k, 5)
    counts = launch_counts()
    assert counts["flash_attention"] == 0 and counts["decode_attention"] == 0


# head dim 256 (decode_attention_d256_kernel): paligemma-3b's heads, 8 on one
# kv head; two kv heads; G = 12, two head groups of a kv head (8 + 4)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("smax", [550, 32768])
@pytest.mark.parametrize("heads", [(8, 1), (16, 2), (24, 2)])
def test_decode_attention_d256_kernel_on_card(card, heads, smax, dtype):
    """The cluster kernel against its plain version: cache lengths 0 and 1,
    on either side of the cluster's size (shares of 0 and 1 entries) and of
    32 entries a block (one ring stage), past two stages, windows that start
    mid-stage, the whole cache; every call enqueued back to back before the
    first result is read.  At cache_len 0 the output is 0, as the reference
    kernel's (the plain softmax over no valid entry is uniform instead)."""
    B, D = 4, 256
    H, KVH = heads
    c = decode_cluster_on(card, B, KVH, H // KVH, smax)
    g = torch.Generator(device=card).manual_seed(smax + H)
    q, kc, vc = (torch.randn(s, generator=g, device=card).to(dtype)
                 for s in ((B, 1, H, D), (B, smax, KVH, D), (B, smax, KVH, D)))
    lens = [(0, 0), (1, 0), (c - 1, 0), (c, 0), (c + 1, 0), (32 * c - 1, 0), (32 * c, 0),
            (32 * c + 1, 0), (64 * c + 1, 0), (smax, 0), (1, 64), (300, 64), (smax - 7, 64),
            (smax, 100)]
    lens = [(n, w) for n, w in lens if n <= smax]
    ns = [torch.tensor([n], dtype=torch.int32, device=card) for n, _ in lens]
    reset_launch_counts()
    got = [decode_attention(q, kc, vc, n_t, window=w) for n_t, (_, w) in zip(ns, lens)]
    assert launch_counts()["decode_attention"] == len(lens) >= 8
    for (n, w), n_t, out in zip(lens, ns, got):
        assert out.dtype == dtype and out.shape == q.shape
        if n == 0:
            assert out.abs().max().item() == 0
            continue
        want = decode_attention_plain(q, kc, vc, n_t, window=w)
        err = (out.float() - want.float()).abs().max().item()
        assert err <= ATTN_TOL[dtype], (n, w, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_d256_cache_len_above_smax_on_card(card, dtype):
    """A cache_len tensor above the cache's 544 entries clamps to the cache,
    with a window that still reaches into it and without one."""
    B, Smax, H, KVH, D = 4, 544, 8, 1, 256
    g = torch.Generator(device=card).manual_seed(Smax)
    q, kc, vc = (torch.randn(s, generator=g, device=card).to(dtype)
                 for s in ((B, 1, H, D), (B, Smax, KVH, D), (B, Smax, KVH, D)))
    for n, w in ((600, 0), (600, 64), (1 << 30, 0)):
        n_t = torch.tensor([n], dtype=torch.int32, device=card)
        got = decode_attention(q, kc, vc, n_t, window=w)
        want = decode_attention_plain(q, kc, vc, n_t, window=w)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATTN_TOL[dtype], (n, w, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, S, H, P, G, N, chunk, decay): mamba2-2.7b's and hymba-1.5b's heads,
    # a ragged chunk (480 -> 240), multi-group, P = 128, and weak decay
    (2, 512, 8, 64, 1, 128, 256, 1.0),
    (2, 512, 8, 64, 1, 16, 256, 1.0),
    (1, 480, 4, 64, 1, 128, 256, 1e-3),
    (1, 128, 4, 16, 2, 32, 64, 1.0),
    (1, 96, 2, 128, 1, 64, 32, 1e-3),
    # the kernels' split: three chunks with two groups of 4 heads; N = 16
    # with P = 128 over five chunks; a ragged chunk of 200 (600 -> 200, no
    # multiple of 64) over three chunks; a chunk of 500 (eight row tiles)
    (1, 768, 8, 64, 2, 64, 256, 1e-3),
    (2, 320, 4, 128, 1, 16, 64, 1.0),
    (1, 600, 8, 32, 2, 128, 256, 1.0),
    (1, 1000, 4, 64, 1, 128, 512, 1e-3),
    # any head dim and state size up to 256, any chunk and chunk count:
    # (P, N) = (48, 80) and (64, 256) at mamba2-2.7b's heads, (24, 48), (200,
    # 130) over three chunks; a chunk of 4,096 (its cumsum in the workspace);
    # S 4,099, a prime: chunks of 1, B nc = 65,584 past the grid's 65,535
    (4, 512, 80, 48, 1, 80, 256, 1.0),
    (4, 512, 80, 64, 1, 256, 256, 1.0),
    (1, 192, 4, 24, 2, 48, 64, 1e-3),
    (1, 192, 2, 200, 1, 130, 64, 1e-3),
    (1, 8192, 2, 64, 1, 128, 4096, 1e-3),
    (16, 4099, 2, 16, 1, 16, 256, 1.0),
])
def test_ssd_scan_kernel_matches_plain_on_card(card, case, dtype):
    B, S, H, P, G, N, chunk, decay = case
    g = torch.Generator(device=card).manual_seed(S + H + N)
    xbc = torch.randn(B, S, H * P + 2 * G * N, generator=g, device=card).to(dtype)
    x = xbc[..., :H * P].reshape(B, S, H, P)  # strided, as the mixer passes them
    Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=card))
    A = -torch.linspace(1.0, 16.0, H, device=card) * decay
    D = torch.linspace(0.5, 1.5, H, device=card)
    reset_launch_counts()
    got = ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
    want = ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=pick_chunk(S, chunk))
    torch.cuda.synchronize()
    assert launch_counts()["ssd_scan"] == 1 and got.dtype == dtype
    tol = ssd_scan_tolerance(x, dt, A, Bm, Cm, D, chunk=chunk)
    assert ((got.float() - want.float()).abs() <= tol).all()


@pytest.mark.parametrize("case", [(80, 64, 128, 512), (50, 64, 16, 2048)])
def test_ssd_scan_on_a_model_axis_rank_s_part_on_card(card, case):
    """What each of four ranks scans on a model axis: mamba2-2.7b's 80 heads
    20 a rank; hymba-1.5b's 50 heads (which 4 does not divide) on each
    rank's 16 of their 64 columns, a strided slice the kernel reads as laid
    out; against the plain version within ``ssd_scan_tolerance``."""
    H, P, N, S = case
    g = torch.Generator(device=card).manual_seed(H + S)
    xbc = torch.randn(2, S, H * P + 2 * N, generator=g, device=card)
    xs = xbc[..., :H * P].reshape(2, S, H, P)
    Bm, Cm = (xbc[..., H * P + i * N:H * P + (i + 1) * N].reshape(2, S, 1, N) for i in (0, 1))
    dt = torch.nn.functional.softplus(torch.randn(2, S, H, generator=g, device=card) - 2.0)
    A, D = -torch.linspace(1.0, 16.0, H, device=card), torch.ones(H, device=card)
    for r in range(4):
        heads, cols = ((slice(r * H // 4, (r + 1) * H // 4), slice(None)) if H % 4 == 0 else
                       (slice(None), slice(r * P // 4, (r + 1) * P // 4)))
        args = (xs[:, :, heads, cols], dt[:, :, heads], A[heads], Bm, Cm, D[heads])
        got = ssd_scan(*args, chunk=256)
        want = ssd_scan_plain(*args, chunk=pick_chunk(S, 256))
        torch.cuda.synchronize()
        assert ((got - want).abs() <= ssd_scan_tolerance(*args, chunk=256)).all()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b", "hymba-1.5b",
                                  "deepseek-v2-lite-16b", "paligemma-3b", "musicgen-medium"])
def test_smoke_serving_on_card_matches_cpu(card, arch):
    from repro_torch.config import get_arch, smoke_variant
    from repro_torch.launch.serve import (generate, load_model, prompt_patches, prompt_tokens,
                                          serve_policy)

    cfg = smoke_variant(get_arch(arch))
    model = load_model(cfg, seed=0, device="cpu")
    prompt = prompt_tokens(cfg, 2, 16, seed=0, device="cpu")
    patches = prompt_patches(cfg, 2, 16, seed=0, device="cpu")
    cpu = generate(model, cfg, serve_policy(16), prompt, 4, patches=patches)
    reset_launch_counts()
    gpu = generate(model.to(card), cfg, serve_policy(16), prompt.to(card), 4,
                   patches=None if patches is None else patches.to(card))
    counts = launch_counts()
    # MLA attends in plain PyTorch, as the reference's MLA is plain JAX
    attn = cfg.num_layers if cfg.has_attention and cfg.mla is None else 0
    assert counts["flash_attention"] == attn
    assert counts["decode_attention"] == 4 * attn
    assert counts["ssd_scan"] == (cfg.num_layers if cfg.has_ssm else 0)
    torch.testing.assert_close(gpu.prefill_logits.cpu(), cpu.prefill_logits, rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(gpu.tokens.cpu(), cpu.tokens)


def _moe_mla_params(cfg, seed):
    from types import SimpleNamespace

    from repro_torch.models.layers import Initializer
    from repro_torch.models.mla import init_mla
    from repro_torch.models.moe import init_moe

    def ns(tree):  # the deferred leaves made in order
        return SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v()
                                  for k, v in tree.items()})

    init = Initializer(seed, dtype=torch.float32, device="cpu")
    return ns(init_moe(init, cfg)), ns(init_mla(init, cfg))


def _to(tree, dev):
    from types import SimpleNamespace

    return SimpleNamespace(**{k: _to(v, dev) if isinstance(v, SimpleNamespace) else v.to(dev)
                              for k, v in vars(tree).items()})


@pytest.mark.parametrize("impl", ["gshard", "dense"])
def test_moe_ffn_on_card_matches_cpu(card, impl):
    """deepseek-v2-lite-16b's experts at full width (64 experts, top-6, 2
    shared) on a prefill of 2 x 64 tokens and a decode step of 4 (C = 1):
    the same routing and outputs within 1e-4 (float32, sums in another order)."""
    from repro_torch.config import get_arch
    from repro_torch.models.moe import _router, moe_ffn

    cfg = get_arch("deepseek-v2-lite-16b")
    moe, _ = _moe_mla_params(cfg, 3)
    moe_card = _to(moe, card)
    for shape in ((2, 64), (4, 1)):
        x = torch.randn(*shape, cfg.d_model, generator=torch.Generator().manual_seed(5))
        _, experts, _ = _router(moe, x.reshape(-1, cfg.d_model), cfg.moe)
        _, experts_card, _ = _router(moe_card, x.to(card).reshape(-1, cfg.d_model), cfg.moe)
        assert torch.equal(experts_card.cpu(), experts)
        y, aux = moe_ffn(moe, x, cfg, impl=impl)
        y_card, aux_card = moe_ffn(moe_card, x.to(card), cfg, impl=impl)
        torch.testing.assert_close(y_card.cpu(), y, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(aux_card.cpu(), aux, rtol=1e-5, atol=1e-7)


def test_mla_on_card_matches_cpu(card):
    """deepseek-v2-lite-16b's MLA at full width: the expanded prefill over
    2 x 64 tokens and the absorbed decode step against its latent cache, on
    the card against the CPU within 1e-4."""
    from repro_torch.config import get_arch
    from repro_torch.models.mla import init_mla_cache, mla_attention, mla_decode_step

    cfg = get_arch("deepseek-v2-lite-16b")
    _, mla = _moe_mla_params(cfg, 4)
    mla_card = _to(mla, card)
    B, S, Smax = 2, 64, 80
    x = torch.randn(B, S + 1, cfg.d_model, generator=torch.Generator().manual_seed(6))
    pos = torch.arange(S)[None].expand(B, S)
    out, lat = mla_attention(mla, x[:, :S], cfg, pos)
    out_card, lat_card = mla_attention(mla_card, x[:, :S].to(card), cfg, pos.to(card))
    torch.testing.assert_close(out_card.cpu(), out, rtol=1e-4, atol=1e-4)
    caches = []
    for dev, p in (("cpu", mla), (card, mla_card)):
        c = {k: v[0] for k, v in init_mla_cache(cfg, 1, B, Smax, torch.float32, dev).items()}
        for k in c:
            c[k][:, :S] = (lat if dev == "cpu" else lat_card)[k]
        n = torch.tensor([S], dtype=torch.int32, device=dev)
        caches.append((mla_decode_step(p, x[:, S:].to(dev), c, n, cfg), c))
    (o, c), (o_card, c_card) = caches
    torch.testing.assert_close(o_card.cpu(), o, rtol=1e-4, atol=1e-4)
    for k in c:
        torch.testing.assert_close(c_card[k].cpu(), c[k], rtol=1e-4, atol=1e-4)


# the served models' norm shapes (llama3.2-3b prefill and decode, mamba2-2.7b's
# gated norm over d_inner, hymba-1.5b), bfloat16, a ragged row count, and two
# the vectorised path does not take (an odd D, rows read through a stride)
RMS_CASES = [((2048, 3072), torch.float32), ((4, 3072), torch.float32),
             ((2048, 5120), torch.float32), ((2048, 1600), torch.float32),
             ((2048, 3072), torch.bfloat16), ((2047, 3072), torch.float32),
             ((33, 97), torch.float32), ((33, 97), torch.bfloat16),
             # one row; many rows (each resident block walks over several)
             ((1, 3072), torch.float32), ((1, 3072), torch.bfloat16),
             ((4096, 3072), torch.float32), ((4096, 5120), torch.bfloat16),
             # the register path at widths of 1, 2, 4 and 8 warps a row and at
             # its widest (16384 float32, 24576 bfloat16); one vector past it
             # (the generic kernel, row in shared memory); past 32768 (the
             # generic kernel reading the row twice), aligned and not
             ((64, 2048), torch.float32), ((64, 2048), torch.bfloat16),
             ((64, 128), torch.float32), ((64, 4096), torch.float32),
             ((64, 8192), torch.float32), ((64, 16384), torch.float32),
             ((64, 24576), torch.bfloat16), ((64, 16388), torch.float32),
             ((8, 40000), torch.float32), ((8, 40001), torch.bfloat16)]


def rms_norm_within_tolerance(got, x, w):
    """The kernel against the plain version's float32 value on the same
    inputs: 1e-5 of max(1, max |out|) for the float32 sum of squares taken
    in another order, plus, for bfloat16 output, its one rounding (2^-8
    relative)."""
    want = rms_norm_plain(x.float(), w)
    tol = 1e-5 * max(1.0, want.abs().max().item())
    if x.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * want.abs()
    return bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("shape,dtype", RMS_CASES)
def test_rms_norm_kernel_matches_plain_on_card(card, shape, dtype):
    g = torch.Generator(device=card).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    w = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=card)
    reset_launch_counts()
    got = rms_norm(x, w)
    torch.cuda.synchronize()
    assert launch_counts()["rms_norm"] == 1 and got.dtype == dtype and got.shape == x.shape
    assert rms_norm_within_tolerance(got, x, w)
    wide = torch.randn(shape[0], shape[-1] + 8, generator=g, device=card).to(dtype)
    strided = wide[:, 3:3 + shape[-1]]  # rows through a stride, unaligned
    assert rms_norm_within_tolerance(rms_norm(strided, w), strided, w)


def test_session_on_card_matches_the_serial_session(card):
    """The port's front door on the card ("cuda" and "torch" on the card)
    against its serial "auto" session, and evaluate_gammas through the
    replay kernel against the serial simulator."""
    from repro_torch.api import Policy, Session
    from repro_torch.core.simulator import simulate

    rng = np.random.default_rng(11)
    insts = [random_instance(rng, m=m, n_loads=2, q=q, topology=t, return_ratio=r,
                             with_latency=True)
             for t in ("chain", "star") for r in (0.0, 0.5) for m, q in ((3, 1), (4, 2))]
    serial = Session(policy=Policy(backend="auto")).solve_bulk(insts)
    for backend in ("cuda", "torch"):
        reset_launch_counts()
        arts = Session(policy=Policy(backend=backend)).solve_bulk(insts)
        counts = launch_counts()
        assert counts["simplex_pivot"] > 0 and counts["asap_replay"] > 0
        for a, s in zip(arts, serial):
            assert a.status == s.status == "optimal"
            assert a.backend == "cuda" or a.events[0]["kind"] == "serial-rescue"
            if a.backend == "cuda":
                assert a.events == ()
            for k in ("makespan", "lp_makespan", "objective_value"):
                assert abs(getattr(a, k) - getattr(s, k)) <= 1e-9 * max(1.0, abs(getattr(s, k)))
    sess = Session()
    reset_launch_counts()
    got = sess.evaluate_gammas(insts, [a.gamma for a in serial])
    assert launch_counts()["asap_replay"] > 0
    want = np.array([simulate(i, a.gamma).makespan for i, a in zip(insts, serial)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


def _grad_case(kernel, card):
    """Inputs on the card that each autograd-facing wrapper's kernel takes."""
    g = torch.Generator(device=card).manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g, device=card)  # noqa: E731
    if kernel == "flash_attention":
        return flash_attention, (r(1, 64, 4, 64), r(1, 64, 2, 64), r(1, 64, 2, 64)), {}
    if kernel == "decode_attention":
        return decode_attention, (r(1, 1, 4, 64), r(1, 64, 2, 64), r(1, 64, 2, 64), 40), {}
    if kernel == "ssd_scan":
        return ssd_scan, (r(1, 64, 2, 16), torch.rand(1, 64, 2, generator=g, device=card),
                          -torch.rand(2, generator=g, device=card), r(1, 64, 1, 16),
                          r(1, 64, 1, 16), torch.ones(2, device=card)), {"chunk": 32}
    return rms_norm, (r(8, 256), torch.ones(256, device=card)), {}


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention", "ssd_scan",
                                    "rms_norm"])
def test_kernel_wrappers_refuse_inputs_that_require_grad_on_card(card, kernel):
    """An input that requires grad, with grad mode on, raises before any
    launch; the same call under no_grad launches once."""
    fn, args, kw = _grad_case(kernel, card)
    marked = [a.detach().requires_grad_(True) if isinstance(a, torch.Tensor) and i == 0 else a
              for i, a in enumerate(args)]
    reset_launch_counts()
    with pytest.raises(ValueError, match="no backward kernel"):
        fn(*marked, **kw)
    assert launch_counts()[kernel] == 0
    with torch.no_grad():
        out = fn(*marked, **kw)
    torch.cuda.synchronize()
    assert launch_counts()[kernel] == 1 and out.grad_fn is None


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_smoke_train_step_on_card_matches_cpu(card, arch):
    """One train step of a smoke model (dense, ssm) on the card against the
    same step on the CPU from the same weights and batch: loss and grad
    norm within 1e-5 relative, every gradient leaf within 1e-4 of its max
    |g| (float32, sums in another order), and no kernel launched."""
    from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
    from repro_torch.data import make_batch
    from repro_torch.models import init_params
    from repro_torch.runtime import make_train_state, make_train_step

    cfg = smoke_variant(get_arch(arch))
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    step = make_train_step(cfg, ShardingPolicy(attn_chunk=16), tcfg)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 4, 32, step=0).items()}
    cpu = make_train_state(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"), tcfg)
    gpu = make_train_state(init_params(cfg, seed=0, dtype=torch.float32, device="cpu").to(card),
                           tcfg)
    assert gpu.opt.step.device.type == "cuda"
    cpu, m_cpu = step(cpu, batch)
    reset_launch_counts()
    gpu, m_gpu = step(gpu, {k: v.to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert sum(launch_counts().values()) == 0
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m_gpu[k]), float(m_cpu[k]), rtol=1e-5, err_msg=k)
    grads = {n: p.grad for n, p in cpu.params.named_parameters()}
    for n, p in gpu.params.named_parameters():
        err = float((p.grad.cpu() - grads[n]).abs().max())
        assert err <= 1e-4 * max(float(grads[n].abs().max()), 1e-30), (n, err)
