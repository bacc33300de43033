"""The port's kernels (plain versions, on the CPU) against the JAX package's
Pallas kernels in interpret mode and its step-by-step oracles.

The reference kernels run here under a scoped ``jax.enable_x64(True)``, so
they compute in float64 and nothing of x64 leaks into other tests.  The
same NumPy inputs, made from a seed, go to both packages.

* ``simplex_pivot_plain`` must reproduce the reference kernel bit for bit
  (tableau, basis, iteration counts, statuses): the update is one fused
  multiply-add in both (``torch.addcmul``; XLA contracts the reference's
  ``T - pcol * prow``).  Against the oracle ``ref.simplex_pivot_ref``, which
  divides the pivot row first and then subtracts, basis/it/status are
  identical and the tableau agrees within 1e-12.
* ``asap_replay_plain`` agrees with the reference kernel and oracle within
  1e-9 relative (the sums and products are the same; XLA may contract
  some of them).
* ``rms_norm`` (its plain version here) agrees with the reference kernel
  and oracle within ``RMS_TOL`` (see there).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import (asap_replay, asap_replay_plain, launch_counts,
                                 reset_launch_counts, rms_norm, rms_norm_plain, simplex_pivot,
                                 simplex_pivot_plain)


def pivot_stack(rng, B, R, C):
    """A stack that keeps pivoting, with a finished lane (status 0), a lane
    past Bland's threshold and a lane at its iteration budget."""
    T = rng.uniform(0.1, 1.0, size=(B, R, C))
    T[:, -1, :] = rng.uniform(-1.0, 0.5, size=(B, C))
    T[:, :, -1] = rng.uniform(0.5, 1.5, size=(B, R))
    # duplicated values make Dantzig and ratio ties likely
    T[:, :, 1] = T[:, :, 0]
    basis = np.stack([rng.permutation(C - 1)[: R - 1] for _ in range(B)]).astype(np.int32)
    it = np.zeros(B, np.int32)
    status = np.full(B, -1, np.int32)
    status[1] = 0  # finished: rides through
    it[2] = 5  # past bland_after=3: Bland's rule
    it[3 % B] = 20  # at max_iter: rides through
    return T, basis, it, status


def torch_args(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


PIVOT_CASES = [(4, 7, 13), (5, 9, 17), (6, 12, 31)]


@pytest.mark.parametrize("k_pivots", [1, 2, 4])
@pytest.mark.parametrize("shape", PIVOT_CASES)
def test_simplex_pivot_plain_matches_pallas_kernel_bitwise(shape, k_pivots):
    T, basis, it, status = pivot_stack(np.random.default_rng(sum(shape) + k_pivots), *shape)
    kw = dict(ncols_price=shape[2] - 1, bland_after=3, max_iter=20)
    with jax.enable_x64(True):
        want = [np.asarray(o) for o in ops.simplex_pivot(
            T, basis, it, status, k_pivots=k_pivots, interpret=True, **kw)]
    got = [o.numpy() for o in simplex_pivot_plain(*torch_args(T, basis, it, status),
                                                   k_pivots=k_pivots, **kw)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[2] != it).any(), "some lane must have pivoted"


@pytest.mark.parametrize("shape", PIVOT_CASES)
def test_simplex_pivot_plain_matches_oracle(shape):
    T, basis, it, status = pivot_stack(np.random.default_rng(7 * sum(shape)), *shape)
    kw = dict(ncols_price=shape[2] - 1, bland_after=3, max_iter=20)
    with jax.enable_x64(True):
        want = [np.asarray(o) for o in ref.simplex_pivot_ref(
            *(jax.numpy.asarray(a) for a in (T, basis, it, status)), **kw)]
    got = [o.numpy() for o in simplex_pivot_plain(*torch_args(T, basis, it, status), **kw)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12 * np.abs(T).max())
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_simplex_pivot_k_fused_equals_k_single():
    T, basis, it, status = pivot_stack(np.random.default_rng(11), 5, 9, 17)
    kw = dict(ncols_price=16, bland_after=3, max_iter=20)
    fused = simplex_pivot_plain(*torch_args(T, basis, it, status), k_pivots=4, **kw)
    single = torch_args(T, basis, it, status)
    for _ in range(4):
        simplex_pivot_plain(*single, **kw)
    for a, b in zip(fused, single):
        assert torch.equal(a, b)


def test_simplex_pivot_lanes_touch_only_those_lanes():
    T, basis, it, status = pivot_stack(np.random.default_rng(12), 6, 7, 13)
    kw = dict(ncols_price=12, bland_after=3, max_iter=20)
    lanes = torch.tensor([4, 0], dtype=torch.int32)
    sub = simplex_pivot(*torch_args(T, basis, it, status), lanes=lanes, **kw)
    full = simplex_pivot(*torch_args(T, basis, it, status), **kw)
    for a, b, orig in zip(sub, full, (T, basis, it, status)):
        for lane in range(6):
            want = b[lane] if lane in (0, 4) else torch.from_numpy(np.asarray(orig[lane]))
            assert torch.equal(a[lane], want)


def replay_inputs(rng, B, m, T, n_valid, with_ret):
    valid = np.zeros(T)
    valid[:n_valid] = 1.0
    gamma = rng.uniform(0.0, 1.0, size=(B, m, T))
    gamma[:, :, n_valid:] = 0.0  # padded cells carry no fraction
    args = (rng.uniform(0.1, 1.0, size=(B, m, T)), rng.uniform(0.1, 1.0, size=(B, m - 1)),
            rng.uniform(0.0, 0.1, size=(B, m - 1)), rng.uniform(0.0, 1.0, size=(B, m)),
            rng.uniform(1.0, 2.0, size=(B, T)), rng.uniform(1.0, 2.0, size=(B, T)),
            rng.uniform(0.0, 1.0, size=(B, T)), valid, gamma)
    ret = rng.uniform(0.0, 1.0, size=(B, T)) if with_ret else None
    return args, ret


def assert_replay_close(got, want):
    got = [g.numpy() for g in got if g is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("with_ret", [False, True])
@pytest.mark.parametrize("topology", ["chain", "star"])
@pytest.mark.parametrize("dims", [(3, 4, 5, 4), (2, 2, 3, 3), (4, 5, 6, 4)])
def test_asap_replay_plain_matches_pallas_kernel_and_oracle(topology, with_ret, dims):
    B, m, T, n_valid = dims
    args, ret = replay_inputs(np.random.default_rng(B * 100 + m * 10 + T), B, m, T,
                              n_valid, with_ret)
    with jax.enable_x64(True):
        kern = [np.asarray(o) for o in ops.asap_replay(*args, ret, topology=topology,
                                                       interpret=True)]
        oracle = [np.asarray(o) for o in ref.asap_replay_ref(*args, ret, topology=topology)]
    got = asap_replay_plain(*torch_args(*args), None if ret is None else torch_args(ret)[0],
                            topology=topology)
    assert_replay_close(got, kern)
    assert_replay_close(got, oracle)


def test_asap_replay_single_processor_matches_serial_simulator():
    """m == 1 (no links) runs through the same wrapper."""
    from repro.core.instance import Chain, Instance, Loads
    from repro.core.simulator import simulate

    inst = Instance(Chain(w=[0.7], z=[], tau=0.3), Loads(v_comm=[1.0, 2.0], v_comp=[1.5, 0.5],
                                                         release=[0.0, 2.0]), q=2)
    gamma = np.ones((1, 4))
    want = simulate(inst, gamma)
    from repro_torch.convert import instance_from_reference
    from repro_torch.engine.batched_sim import simulate_many

    (got,) = simulate_many([instance_from_reference(inst)], [gamma], device="cpu")
    assert got.comm_start.shape == (0, 4)
    np.testing.assert_allclose(got.comp_end, want.comp_end, rtol=1e-12)
    assert abs(got.makespan - want.makespan) <= 1e-12 * want.makespan


def test_wrappers_run_the_plain_version_on_cpu_and_count_no_launch():
    reset_launch_counts()
    T, basis, it, status = pivot_stack(np.random.default_rng(1), 4, 7, 13)
    simplex_pivot(*torch_args(T, basis, it, status), ncols_price=12, bland_after=3, max_iter=20)
    args, ret = replay_inputs(np.random.default_rng(2), 2, 3, 4, 4, True)
    asap_replay(*torch_args(*args), torch_args(ret)[0], topology="star")
    assert launch_counts() == {"simplex_pivot": 0, "asap_replay": 0, "flash_attention": 0,
                               "decode_attention": 0, "ssd_scan": 0, "rms_norm": 0}


def test_wrappers_reject_bad_arguments():
    T, basis, it, status = torch_args(*pivot_stack(np.random.default_rng(1), 4, 7, 13))
    kw = dict(ncols_price=12, bland_after=3, max_iter=20)
    with pytest.raises(TypeError):
        simplex_pivot(T.float(), basis, it, status, **kw)
    with pytest.raises(TypeError):
        simplex_pivot(T, basis.long(), it, status, **kw)
    with pytest.raises(ValueError):
        simplex_pivot(T.transpose(1, 2).contiguous().transpose(1, 2), basis, it, status, **kw)
    with pytest.raises(ValueError):
        simplex_pivot(T, basis, it, status, lanes=torch.tensor([7], dtype=torch.int32), **kw)
    with pytest.raises(ValueError):
        simplex_pivot(T.to("meta"), basis.to("meta"), it.to("meta"), status.to("meta"), **kw)
    args, ret = replay_inputs(np.random.default_rng(2), 2, 3, 4, 4, True)
    targs = torch_args(*args)
    with pytest.raises(TypeError):
        asap_replay(*targs[:-1], targs[-1].float(), topology="chain")
    with pytest.raises(ValueError):
        asap_replay(*targs, topology="ring")
    single = torch_args(*replay_inputs(np.random.default_rng(3), 2, 1, 4, 4, False)[0])
    with pytest.raises(ValueError):
        asap_replay(*single, torch.zeros(2, 4, dtype=torch.float64), topology="chain")


# ---------------------------------------------------------------- rmsnorm

# Both packages evaluate the same float32 formula; the mean of D squares is
# summed in another order (and XLA's rsqrt is not PyTorch's), which moves a
# float32 result by a few ulps: 1e-6 of max(1, max |out|).  In bfloat16 the
# output is then rounded to 8 bits of mantissa, and a float32 value a few
# ulps from a rounding boundary can land one bfloat16 step away: 2^-8
# relative to max(1, max |out|).
RMS_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
RMS_SHAPES = [(4, 64), (2, 8, 128), (3, 5, 96)]  # the reference's tests/test_kernels.py cases


def rms_inputs(shape, dtype, seed):
    """x (float32 or bfloat16, as a torch tensor and a JAX array holding the
    same values) and w (float32 around 1), from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(getattr(torch, dtype))
    w = torch.from_numpy((1.0 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32))
    xj = jax.numpy.asarray(x.float().numpy()).astype(getattr(jax.numpy, dtype))
    return x, w, xj, jax.numpy.asarray(w.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rms_norm_plain_matches_pallas_kernel_and_oracle(shape, dtype):
    x, w, xj, wj = rms_inputs(shape, dtype, sum(shape))
    got = rms_norm(x, w)
    assert got.dtype == x.dtype and got.shape == x.shape
    got = got.float().numpy()
    for want in (ops.rms_norm(xj, wj, interpret=True), ref.rms_norm_ref(xj, wj)):
        assert want.dtype == xj.dtype
        want = np.asarray(want.astype(jax.numpy.float32))
        tol = RMS_TOL[dtype] * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_rms_norm_wrapper_is_the_plain_version_on_cpu():
    x, w, _, _ = rms_inputs((3, 7, 40), "float32", 3)
    reset_launch_counts()
    assert torch.equal(rms_norm(x, w, eps=1e-3), rms_norm_plain(x, w, eps=1e-3))
    assert torch.equal(rms_norm(x.transpose(0, 1), w), rms_norm_plain(x.transpose(0, 1), w))
    assert launch_counts()["rms_norm"] == 0


@pytest.mark.parametrize("what", ["w_shape", "x_dtype", "scalar"])
def test_rms_norm_rejects_bad_arguments(what):
    x, w, _, _ = rms_inputs((4, 16), "float32", 4)
    args = {"w_shape": (x, w[:8]), "x_dtype": (x.double(), w), "scalar": (x[0, 0], w)}[what]
    with pytest.raises((ValueError, TypeError)):
        rms_norm(*args)
