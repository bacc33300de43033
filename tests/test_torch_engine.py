"""The port's engine (``repro_torch.engine``, run with ``device="cpu"``)
against the JAX engine (``repro.engine``).

The reference engine does not import under the installed JAX without the
``jax.experimental.enable_x64`` alias, and setting that alias in this
process would change which of the reference's own tests pass depending on
where xdist puts them.  So the reference runs in a child process (one per
module, through a module-scoped fixture) that sets the alias, solves the
same instances — built here from a seeded NumPy generator and pickled —
with ``solve_bulk(use_pallas=True)`` (Pallas kernels in interpret mode) and
with its default path, and writes back results, packed buckets, LP stacks
and the set-up tableau stacks of its simplex.

What is held, and why:

* packed bucket arrays and LP stacks: byte-equal (NumPy code, copied);
* given the reference's own set-up stack, the port's phase drivers,
  inter-phase step and extraction reproduce the reference's statuses,
  pivots per phase, exit bases and x exactly;
* end to end, statuses are identical and the makespan and LP objective
  agree within 1e-9.  Pivot counts and exit bases are compared only where
  the two set-ups agree: XLA on the CPU emits the reference's
  ``1.0 / jnp.sqrt`` as an f64 ``rsqrt`` that is not correctly rounded, so
  its Ruiz scales differ from the port's (correctly rounded) ones in the
  last ulp, and on these degenerate LPs that can turn a Dantzig tie the
  other way.  Where the final bases agree, gamma agrees within 1e-9; where
  they do not, both plans are certified optimal by replay.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.instance import Chain, Instance, Loads, Star
from repro_torch.convert import from_reference, instance_from_reference
from repro_torch.engine import SolutionCache, solve_bulk
from repro_torch.engine.arena import InstanceArena
from repro_torch.engine.batched_lp import build_lp_bucket
from repro_torch.engine import batched_simplex as pbs

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-9
GOLDEN_976 = 976.1527780792386  # star/ret0.75/rel0/m2/n3/q4/het1/cc0.02, HiGHS
GOLDEN_Q2 = 781.0 / 653.0 * 0.75  # the §3 example at lambda = 3/4, Q = 2


def _instance(rng, m, n_loads, q, topology, returns, release):
    w = rng.uniform(0.2, 2.0, size=m)
    z = rng.uniform(0.05, 1.0, size=m - 1)
    lat = rng.uniform(0.01, 0.2, size=m - 1)
    v_comp = rng.uniform(0.5, 3.0, size=n_loads)
    v_comm = v_comp * rng.uniform(0.2, 2.0, size=n_loads)
    rel = rng.uniform(0.0, 2.0, size=n_loads) if release else 0.0
    ret = rng.uniform(0.1, 1.0, size=n_loads) if returns else 0.0
    cls = Star if topology == "star" else Chain
    return Instance(cls(w=w, z=z, latency=lat),
                    Loads(v_comm=v_comm, v_comp=v_comp, release=rel, return_ratio=ret),
                    q=q)


def golden_976_instance():
    """The campaign's mis-convergence instance, written out (it is
    ``full_spec().materialize(cell, 0)`` for the cell above)."""
    return Instance(
        Star(w=[2.306126709357919e-08, 1.7265569726405336e-08],
             z=[9.289405095685187e-08], tau=0.0, latency=[0.001]),
        Loads(v_comm=[990409583.4589807, 370593864.8133155, 616276888.6382855],
              v_comp=[49520479172.949036, 18529693240.665775, 30813844431.914276],
              release=0.0, return_ratio=0.75),
        q=4)


def example_instance(lam=0.75, q=2):
    """The paper's §3 motivating example."""
    return Instance(Chain(w=[lam, lam], z=[1.0]),
                    Loads(v_comm=[1.0, 1.0], v_comp=[1.0, 1.0]), q=q)


def populations():
    rng = np.random.default_rng(20261017)
    pops = {}
    for topology in ("chain", "star"):
        for returns, release in ((False, False), (True, True)):
            name = f"{topology}{'_ret_rel' if returns else ''}"
            pops[name] = [_instance(rng, 3, 2, 2, topology, returns, release)
                          for _ in range(3)]
    # several exact shapes: several buckets on the miss path, and padded
    # cells and processors once the hits replay through padded buckets
    pops["mixed"] = [_instance(rng, m, n, q, topo, ret, ret)
                     for m, n, q, topo, ret in ((2, 1, 1, "chain", False),
                                                (3, 2, 1, "star", True),
                                                (4, 2, 2, "chain", True),
                                                (3, 1, 2, "chain", False),
                                                (4, 1, 1, "star", False))]
    pops["golden"] = [golden_976_instance(), example_instance()]
    return pops


def raw_lps():
    """Raw LP stacks: a degenerate corner (status 4) and a random stack
    that mixes optimal, infeasible and unbounded lanes."""
    rng = np.random.default_rng(42)
    B, n, mu, me = 8, 6, 5, 2
    mixed = (rng.normal(size=(B, n)), rng.normal(size=(B, mu, n)),
             rng.uniform(0.5, 2, size=(B, mu)), rng.normal(size=(B, me, n)),
             rng.uniform(-1, 1, size=(B, me)))
    degenerate = (np.array([[1.0, 1.0]]), np.zeros((1, 0, 2)), np.zeros((1, 0)),
                  np.array([[[-1.0, -1.0]]]), np.array([[0.0]]))
    return {"mixed": mixed, "degenerate": degenerate}


# the first lines of every child that runs the reference engine: the alias
# it needs under the installed JAX (set in the child, never in pytest)
ALIAS = r"""
import pickle, sys
import numpy as np
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
"""


def run_reference(script: str, payload, tmp_dir: Path):
    """Run ``script`` after :data:`ALIAS` in a child process, with
    ``sys.argv[1]`` a pickle of ``payload`` and ``sys.argv[2]`` the path of
    the pickle it writes back; returns what it wrote."""
    src, dst = tmp_dir / "in.pkl", tmp_dir / "out.pkl"
    with open(src, "wb") as f:
        pickle.dump(payload, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", ALIAS + script, str(src), str(dst)],
                          env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(dst, "rb") as f:
        return pickle.load(f)  # written by the child, from our input


CHILD = r"""
from repro.engine import solve_bulk
from repro.engine.arena import InstanceArena
from repro.engine.batched_lp import build_lp_bucket
from repro.engine import batched_simplex as bs

def summary(res):
    out = []
    for r in res:
        lp = (r.telemetry or {}).get("lp", {})
        out.append(dict(status=r.status, backend=r.backend, makespan=r.makespan,
                        lp_makespan=r.lp_makespan, gamma=np.asarray(r.schedule.gamma),
                        p1=lp.get("pivots_phase1"), p2=lp.get("pivots_phase2"),
                        lp_status=lp.get("status"), basis=lp.get("final_basis"),
                        warm=lp.get("warm"), rescue="serial_rescue" in (r.telemetry or {})))
    return out

def bucket_dump(b):
    keys = ("w_cell", "z", "latency", "tau", "vcomm_cell", "vcomp_cell", "rel_cell",
            "ret_cell", "cell_valid", "load_of_cell")
    return dict({k: getattr(b, k) for k in keys}, indices=list(b.indices), key=b.key)

src = pickle.load(open(sys.argv[1], "rb"))
out = {"pops": {}, "raw": {}}
for name, insts in src["pops"].items():
    pal = solve_bulk(insts, use_pallas=True)
    warm = solve_bulk(insts, use_pallas=True,
                      warm_starts=[r.telemetry["lp"].get("final_basis") for r in pal])
    buckets = []
    with jax.enable_x64(True):
        for b in InstanceArena(insts, pad_shapes=False).buckets:
            lp = build_lp_bucket(b)
            c = np.tile(lp.c, (b.B, 1))
            setup = [np.asarray(x) for x in bs._setup_batch(c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)]
            solved = [np.asarray(x) for x in bs._solve_batch_pallas_compact(
                c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq, 20000, True)]
            buckets.append(dict(bucket_dump(b), c=c, A_ub=lp.A_ub, b_ub=lp.b_ub,
                                A_eq=lp.A_eq, b_eq=lp.b_eq, setup=setup, solved=solved))
    padded = [bucket_dump(b) for b in InstanceArena(insts, pad_shapes=True).buckets]
    out["pops"][name] = dict(pallas=summary(pal), plain=summary(solve_bulk(insts)),
                             warm=summary(warm), buckets=buckets, padded=padded)
for name, args in src["raw"].items():
    r = bs.solve_simplex_batched(*args, use_pallas=True)
    out["raw"][name] = dict(x=r.x, objective=r.objective, status=r.status,
                            it1=r.iterations_phase1, it2=r.iterations_phase2, basis=r.basis)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference engine's answers, computed in a child process."""
    return run_reference(CHILD, {"pops": populations(), "raw": raw_lps()},
                         tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def port():
    """The port's answers on the CPU for the same populations."""
    out = {}
    for name, insts in populations().items():
        ported = [instance_from_reference(i) for i in insts]
        res = solve_bulk(ported, device="cpu")
        out[name] = (ported, res)
    return out


POPS = list(populations())


@pytest.mark.parametrize("name", POPS)
def test_packed_buckets_byte_equal(reference, name):
    ported = [instance_from_reference(i) for i in populations()[name]]
    for pad, key in ((False, "buckets"), (True, "padded")):
        mine = InstanceArena(ported, pad_shapes=pad).buckets
        theirs = reference["pops"][name][key]
        assert len(mine) == len(theirs)
        for b, ref in zip(mine, theirs):
            assert b.key == ref["key"] and list(b.indices) == ref["indices"]
            for k in ("w_cell", "z", "latency", "tau", "vcomm_cell", "vcomp_cell",
                      "rel_cell", "ret_cell", "cell_valid", "load_of_cell"):
                a, r = getattr(b, k), ref[k]
                assert a.dtype == r.dtype and a.tobytes() == r.tobytes(), k


@pytest.mark.parametrize("name", POPS)
def test_lp_stacks_byte_equal(reference, name):
    ported = [instance_from_reference(i) for i in populations()[name]]
    for b, ref in zip(InstanceArena(ported).buckets, reference["pops"][name]["buckets"]):
        lp = build_lp_bucket(b)
        assert np.tile(lp.c, (b.B, 1)).tobytes() == ref["c"].tobytes()
        for k in ("A_ub", "b_ub", "A_eq", "b_eq"):
            assert getattr(lp, k).dtype == ref[k].dtype
            assert getattr(lp, k).tobytes() == ref[k].tobytes(), k


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("name", POPS)
def test_phases_from_reference_setup_bit_identical(reference, name, compact):
    """From the reference's own set-up stack, the port's phases reproduce
    the reference's pivot sequence exactly."""
    for ref in reference["pops"][name]["buckets"]:
        T, basis, c_s, col_scale = ref["setup"]
        c, A_ub, A_eq = ref["c"], ref["A_ub"], ref["A_eq"]
        n, m_ub = c.shape[1], A_ub.shape[1]
        m_rows, dummy = m_ub + A_eq.shape[1], n + m_ub
        bland_after = max(200, 4 * (m_rows + 1))
        t = from_reference({"T": T.copy(), "basis": basis.astype(np.int32),
                            "c_s": c_s, "col": col_scale, "c": c}, device="cpu")
        T_, b_ = t["T"], t["basis"]

        def run():
            if compact:
                return pbs._phase_compact(T_, b_, dummy, 20_000, bland_after, 2, 3)
            return pbs._phase_masked(T_, b_, dummy, 20_000, bland_after)

        it1, st1 = run()
        inf, drv = pbs._between_phases(T_, b_, st1, t["c_s"], n, dummy)
        it2, st2 = run()
        x, obj, status, _, p1, p2, bas = (o.numpy() for o in pbs._extract(
            T_, b_, t["col"], t["c"], inf, drv, st1, st2, it1, it2, n, dummy))
        rx, robj, rstatus, _, rp1, rp2, rbas = ref["solved"]
        np.testing.assert_array_equal(status, rstatus)
        np.testing.assert_array_equal(p1, rp1)
        np.testing.assert_array_equal(p2, rp2)
        np.testing.assert_array_equal(bas, rbas)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_allclose(obj, robj, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", POPS)
def test_solve_bulk_matches_reference(reference, port, name):
    ported, res = port[name]
    for path in ("pallas", "plain"):
        ref = reference["pops"][name][path]
        for r, want in zip(res, ref):
            assert r.status == want["status"] == "optimal"
            assert r.telemetry["lp"]["status"] == want["lp_status"]
            assert ("serial_rescue" in r.telemetry) == want["rescue"]
            scale = max(abs(want["makespan"]), 1.0)
            assert abs(r.makespan - want["makespan"]) <= RTOL * scale
            assert abs(r.lp_makespan - want["lp_makespan"]) <= RTOL * scale
            if r.telemetry["lp"].get("final_basis") == want["basis"] and not want["rescue"]:
                assert (r.telemetry["lp"]["pivots_phase1"], r.telemetry["lp"]["pivots_phase2"]) \
                    == (want["p1"], want["p2"])
                np.testing.assert_allclose(r.schedule.gamma, want["gamma"], rtol=0, atol=RTOL)


def test_goldens(port):
    _, res = port["golden"]
    assert res[0].ok and abs(res[0].makespan - GOLDEN_976) <= RTOL * GOLDEN_976
    assert res[1].ok and abs(res[1].makespan - GOLDEN_Q2) <= RTOL


def test_reference_pallas_and_plain_agree(reference):
    """The two reference paths the port is held against agree with each
    other (so holding the port to either is the same bar)."""
    for name in POPS:
        for a, b in zip(reference["pops"][name]["pallas"], reference["pops"][name]["plain"]):
            assert a["status"] == b["status"] and a["basis"] == b["basis"]
            assert (a["p1"], a["p2"]) == (b["p1"], b["p2"])


@pytest.mark.parametrize("name", list(raw_lps()))
def test_raw_lp_statuses_match_reference(reference, name):
    """Status 1/2/4 lanes: the same statuses as the reference; optimal
    lanes within 1e-9 of its objective."""
    args = raw_lps()[name]
    res = pbs.solve_simplex_batched(*args, device="cpu")
    ref = reference["raw"][name]
    np.testing.assert_array_equal(res.status, ref["status"])
    opt = ref["status"] == 0
    np.testing.assert_allclose(res.objective[opt], ref["objective"][opt], rtol=RTOL, atol=RTOL)
    assert np.isnan(res.x[~opt & ((ref["status"] == 1) | (ref["status"] == 4))]).all()
    if name == "degenerate":
        assert res.status.tolist() == [4]
    else:
        assert len(set(res.status.tolist())) >= 2


def test_lps_without_rows_are_rejected():
    """The reference's batched simplex cannot take an LP with no rows (an
    argmin over an empty ratio test); the port says so up front."""
    c = np.array([[1.0, 2.0]])
    with pytest.raises(ValueError, match="constraint row"):
        pbs.solve_simplex_batched(c, device="cpu")


def test_false_optimal_exit_is_demoted():
    """Status 5: an "optimal" iterate that violates a row is demoted; NaN
    lanes pass through."""
    x = np.array([[2.0, 0.0], [0.5, 0.5]])
    A_ub = np.tile(np.array([[[1.0, 1.0]]]), (2, 1, 1))
    b_ub = np.array([[1.0], [1.0]])
    out = pbs._demote_false_optimal(x, np.zeros(2, np.int32), A_ub, b_ub,
                                    np.zeros((2, 0, 2)), np.zeros((2, 0)))
    assert out.tolist() == [5, 0] and pbs.STATUS[5] == "false_optimal"
    out2 = pbs._demote_false_optimal(np.array([[np.nan, np.nan]]), np.array([1], np.int32),
                                     A_ub[:1], b_ub[:1], np.zeros((1, 0, 2)), np.zeros((1, 0)))
    assert out2.tolist() == [1]


def test_status4_lanes_reach_the_serial_rescue(monkeypatch):
    """A degenerate (status 4) lane is certified by the serial rescue,
    counted in its telemetry."""
    import repro_torch.engine.service as service

    real = service.solve_simplex_batched

    def forced(*args, **kwargs):
        res = real(*args, **kwargs)
        res.status = np.full_like(res.status, 4)
        res.x = np.full_like(res.x, np.nan)
        return res

    monkeypatch.setattr(service, "solve_simplex_batched", forced)
    inst = instance_from_reference(_instance(np.random.default_rng(3), 3, 2, 2, "star", True, False))
    (r,) = solve_bulk([inst], device="cpu")
    assert r.ok and r.backend not in ("torch", "cuda")
    assert r.telemetry["serial_rescue"]["reason"] == "degenerate"


@pytest.mark.parametrize("name", POPS)
def test_compact_equals_masked_bit_for_bit(name):
    ported = [instance_from_reference(i) for i in populations()[name]]
    for b in InstanceArena(ported).buckets:
        lp = build_lp_bucket(b)
        c = np.tile(lp.c, (b.B, 1))
        r1 = pbs.solve_simplex_batched(c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq,
                                       compact=True, device="cpu")
        r2 = pbs.solve_simplex_batched(c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq,
                                       compact=False, device="cpu")
        for k in ("x", "status", "iterations_phase1", "iterations_phase2", "basis"):
            np.testing.assert_array_equal(getattr(r1, k), getattr(r2, k))


@pytest.mark.parametrize("name", ["chain_ret_rel", "star_ret_rel"])
def test_warm_restart_from_final_basis(reference, port, name):
    """A re-solve seeded with each exit basis takes zero pivots and gives
    the same plan; the reference's warm entry does the same."""
    ported, cold = port[name]
    warm = solve_bulk(ported, device="cpu",
                      warm_starts=[r.telemetry["lp"]["final_basis"] for r in cold])
    for w, c, ref in zip(warm, cold, reference["pops"][name]["warm"]):
        assert w.telemetry["lp"]["warm"] and ref["warm"]
        assert w.telemetry["lp"]["pivots_phase1"] == w.telemetry["lp"]["pivots_phase2"] == 0
        assert w.telemetry["lp"]["final_basis"] == c.telemetry["lp"]["final_basis"]
        np.testing.assert_allclose(w.schedule.gamma, c.schedule.gamma, rtol=0, atol=RTOL)
        assert abs(w.makespan - c.makespan) <= RTOL * max(1.0, c.makespan)


def test_cache_hits_replay_through_the_port():
    rng = np.random.default_rng(5)
    ported = [instance_from_reference(_instance(rng, m, 2, q, topo, ret, ret))
              for m, q, topo, ret in ((3, 2, "chain", True), (2, 1, "star", False),
                                      (4, 1, "chain", False))]
    cache = SolutionCache()
    cold = solve_bulk(ported, device="cpu", cache=cache)
    hot = solve_bulk(ported, device="cpu", cache=cache)
    for h, c in zip(hot, cold):
        assert h.backend == "torch+cache" and h.telemetry["cache_hit"]
        np.testing.assert_array_equal(h.schedule.gamma, c.schedule.gamma)
        assert abs(h.makespan - c.makespan) <= RTOL * max(1.0, c.makespan)
    assert cache.stats()["hits"] == len(ported)


def test_from_reference_checks_shapes_and_dtypes():
    with pytest.raises(TypeError):
        from_reference(np.zeros(3, np.float32), device="cpu")
    bad = {"c": np.zeros((2, 3)), "A_ub": np.zeros((2, 4, 5)), "b_ub": np.zeros((2, 4)),
           "A_eq": np.zeros((2, 0, 3)), "b_eq": np.zeros((2, 0))}
    with pytest.raises(ValueError):
        from_reference(bad, device="cpu")
    got = from_reference([np.arange(3), None], device="cpu")
    assert got[0].dtype == torch.int64 and got[1] is None
    # a packed bucket (a dataclass of arrays): fields become tensors, and a
    # field of the wrong shape is refused
    (bucket,) = InstanceArena([instance_from_reference(i)
                               for i in populations()["chain"]]).buckets
    fields = from_reference(bucket, device="cpu")
    assert fields["w_cell"].shape == bucket.w_cell.shape and fields["w_cell"].dtype == torch.float64
    assert fields["topology"] == "chain"
    import dataclasses

    with pytest.raises(ValueError, match="bucket field z"):
        from_reference(dataclasses.replace(bucket, z=bucket.z[:, :1]), device="cpu")
