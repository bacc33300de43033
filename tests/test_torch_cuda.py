"""The port's CUDA kernels on the card, held against their plain versions
on the same card, and the engine on the card against the engine on the CPU.

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
from repro_torch.kernels import (asap_replay, asap_replay_plain, launch_counts,
                                 reset_launch_counts, simplex_pivot, simplex_pivot_plain)

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


@pytest.mark.parametrize("k_pivots", [1, 4])
@pytest.mark.parametrize("shape", [(4, 7, 13), (3, 300, 700)])
def test_simplex_pivot_kernel_matches_plain_on_card(card, shape, k_pivots):
    base = _stack(np.random.default_rng(sum(shape)), *shape)
    kw = dict(ncols_price=shape[2] - 1, bland_after=3, max_iter=50, k_pivots=k_pivots)
    plain = simplex_pivot_plain(*[x.to(card) for x in base], **kw)
    reset_launch_counts()
    kern = simplex_pivot(*[x.to(card) for x in base], **kw)
    torch.cuda.synchronize()
    assert launch_counts()["simplex_pivot"] == 1
    for a, b in zip(kern[1:], plain[1:]):
        assert torch.equal(a, b)
    assert (kern[0] - plain[0]).abs().max().item() <= 1e-12 * base[0].abs().max().item()


@pytest.mark.parametrize("with_ret", [False, True])
@pytest.mark.parametrize("topology", ["chain", "star"])
@pytest.mark.parametrize("m", [1, 4])
def test_asap_replay_kernel_matches_plain_on_card(card, topology, with_ret, m):
    if with_ret and m == 1:
        pytest.skip("the return phase needs a link")
    rng = np.random.default_rng(m)
    B, T = 64, 6
    valid = np.ones(T)
    valid[-1] = 0.0
    args = [rng.uniform(0.1, 1.0, size=(B, m, T)), rng.uniform(0.1, 1.0, size=(B, m - 1)),
            rng.uniform(0.0, 0.1, size=(B, m - 1)), rng.uniform(0.0, 1.0, size=(B, m)),
            rng.uniform(1.0, 2.0, size=(B, T)), rng.uniform(1.0, 2.0, size=(B, T)),
            rng.uniform(0.0, 1.0, size=(B, T)), valid, rng.uniform(0.0, 1.0, size=(B, m, T))]
    ret = torch.from_numpy(rng.uniform(0, 1, size=(B, T))).to(card) if with_ret else None
    targs = [torch.from_numpy(a).to(card) for a in args]
    want = asap_replay_plain(*targs, ret, topology=topology)
    got = asap_replay(*targs, ret, topology=topology)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0)


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
