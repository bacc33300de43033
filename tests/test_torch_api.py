"""The port's front door (``repro_torch.api``) and the §3 heuristics against
the reference's (``repro.api``, ``repro.core.heuristics``).

The same problems, made from a seeded NumPy generator, go to both packages:

* on the serial ``"auto"`` backend both run the same NumPy code, so the
  artifacts must be the same plan bit for bit: ``diff(tol=0)`` is empty and
  the JSON documents are byte-equal;
* on the port's engine (``"torch"`` with ``device="cpu"``: the kernels'
  plain versions) the LPs are degenerate and may exit at another optimal
  basis than the serial solver's (ROADMAP C.2), so statuses must be equal
  and makespan, LP makespan and objective within 1e-9 — gamma is not
  compared;
* the same bars against the reference's JAX engine (``"batched"``), which
  runs in a child process (see ``tests/test_torch_engine.py``);
* the heuristics are host code copied bit for bit: every strategy's gamma,
  installment structure, makespan and failure are identical.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.api import PlanArtifact as RefArtifact
from repro.api import Policy as RefPolicy
from repro.api import Problem as RefProblem
from repro.api import Session as RefSession
from repro.core.heuristics import ALL_HEURISTICS as REF_HEURISTICS
from repro.core.heuristics import run_strategy as ref_run_strategy
from repro.core.instance import random_instance as ref_random_instance
from repro_torch.api import PlanArtifact, Policy, Problem, Session
from repro_torch.convert import instance_from_reference
from repro_torch.core.heuristics import ALL_HEURISTICS, run_strategy
from test_torch_engine import run_reference

RTOL = 1e-9


def problem_kwargs(rng, m, n_loads, topology, returns, release) -> dict:
    w = rng.uniform(0.2, 2.0, size=m)
    v_comp = rng.uniform(0.5, 3.0, size=n_loads)
    return dict(
        w=w, z=rng.uniform(0.05, 1.0, size=m - 1), v_comm=v_comp * rng.uniform(0.2, 2.0, n_loads),
        v_comp=v_comp, topology=topology, latency=rng.uniform(0.01, 0.2, size=m - 1),
        release=rng.uniform(0.0, 2.0, size=n_loads) if release else 0.0,
        return_ratio=rng.uniform(0.1, 1.0, size=n_loads) if returns else 0.0)


def population() -> list:
    """chain/star x (no returns, returns + release, release only), m 2-4,
    1-2 loads: problem keyword arguments both packages take."""
    rng = np.random.default_rng(20261017)
    out = []
    for topology in ("chain", "star"):
        for returns, release in ((False, False), (True, True), (False, True)):
            for m, n in ((2, 1), (3, 2), (4, 2)):
                out.append(problem_kwargs(rng, m, n, topology, returns, release))
    return out


# a fixed plan, a finer fixed plan, and an auto-T sweep (three rungs)
POLICIES = {"q1": dict(installments=1), "q2": dict(installments=2),
            "auto_t": dict(auto_t=True, t_max=3, installment_cost=0.01)}


def both(policy: str, backend_port: str, backend_ref: str = "auto"):
    kw = POLICIES[policy]
    return Policy(backend=backend_port, **kw), RefPolicy(backend=backend_ref, **kw)


def assert_same_outcome(got, want):
    assert got.status == want.status == "optimal"
    for k in ("makespan", "lp_makespan", "objective_value"):
        g, w = getattr(got, k), getattr(want, k)
        assert abs(g - w) <= RTOL * max(1.0, abs(w)), (k, g, w)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_serial_session_matches_the_reference_bit_for_bit(policy):
    pol, ref_pol = both(policy, "auto")
    kws = population()
    got = Session(policy=pol).solve_bulk([Problem(**kw) for kw in kws])
    want = RefSession(policy=ref_pol).solve_bulk([RefProblem(**kw) for kw in kws])
    for g, w in zip(got, want):
        assert g.to_json() == w.to_json()
        assert g.diff(PlanArtifact.from_json(w.to_json()), tol=0) == {}
        assert g.problem.key() == w.problem.key()
        assert g.problem.bucket_key() == w.problem.bucket_key()


@pytest.mark.parametrize("policy", list(POLICIES))
def test_torch_session_on_cpu_matches_the_reference(policy):
    pol, ref_pol = both(policy, "torch")
    kws = population()
    sess = Session(policy=pol, device="cpu")
    got = sess.solve_bulk([Problem(**kw) for kw in kws])
    want = RefSession(policy=ref_pol).solve_bulk([RefProblem(**kw) for kw in kws])
    for g, w in zip(got, want):
        assert_same_outcome(g, w)
        assert g.backend == "torch" or g.events[0]["kind"] == "serial-rescue"
        assert (g.events == ()) == (g.backend == "torch")
        if policy == "auto_t":
            for a, b in zip(g.sweep["makespans"], w.sweep["makespans"]):
                assert abs(a - b) <= RTOL * max(1.0, abs(b))
    # a second solve of the same problems replays from the session's cache
    again = sess.solve_bulk([Problem(**kw) for kw in kws])
    assert all(a.cache_hit and a.backend == "torch+cache" for a in again)
    for a, g in zip(again, got):
        assert a.diff(g, tol=RTOL * max(1.0, g.makespan)) == {}


REF_ENGINE = r"""
from repro.api import Policy, Problem, Session
src = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, kw in src["policies"].items():
    arts = Session(policy=Policy(backend="batched", **kw)).solve_bulk(
        [Problem(**p) for p in src["problems"]])
    out[name] = [dict(status=a.status, makespan=a.makespan, lp_makespan=a.lp_makespan,
                      objective_value=a.objective_value, backend=a.backend) for a in arts]
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def test_torch_session_matches_the_reference_engine(tmp_path):
    """The reference's JAX engine ("batched", in a child process) and the
    port's engine on the CPU, on the same problems and policies."""
    import types

    kws = population()
    ref = run_reference(REF_ENGINE, {"problems": kws, "policies": POLICIES}, tmp_path)
    for name in POLICIES:
        pol, _ = both(name, "torch")
        got = Session(policy=pol, device="cpu").solve_bulk([Problem(**kw) for kw in kws])
        for g, w in zip(got, ref[name]):
            assert_same_outcome(g, types.SimpleNamespace(**w))
            assert w["backend"].startswith("batched") or w["backend"] in ("simplex", "scipy")


def test_submit_flush_and_deadlines_coalesce():
    kws = population()[:5]
    sess = Session(policy=Policy(backend="torch"), device="cpu", max_batch=3)
    tickets = [sess.submit(Problem(**kw)) for kw in kws]
    assert sess.flush_count == 1  # the third submit filled the queue
    assert all(t.done() for t in tickets[:3]) and not tickets[3].done()
    assert sess.flush() and sess.flush_count == 2
    assert sess.flush() == [] and sess.flush_count == 2  # idempotent
    arts = [t.result() for t in tickets]
    assert all(a.ok and a.backend == "torch" for a in arts)
    # an expired deadline flushes at the next session call
    t = sess.submit(Problem(**kws[0]), deadline=0.0)
    assert sess.flush_count == 3 and t.done() and t.result().cache_hit
    # result() on a pending ticket flushes on its own
    t = sess.submit(Problem(**kws[1]))
    assert not t.done()
    assert t.result().ok and sess.flush_count == 4
    with pytest.raises(ValueError, match="unknown solver backend"):
        sess.submit(Problem(**kws[0]), Policy(backend="batched"))  # no alias in the port
    assert sess.stats()["pending"] == 0


def test_subscribe_and_publish():
    kw = population()[3]
    sess = Session()
    sub = sess.subscribe(Problem(**kw))
    first = sub.next(timeout=0)
    assert first.ok and sub.latest() is first
    later = sess.solve(Problem(**kw), Policy(installments=2))
    sub.publish(later)
    assert sub.next(timeout=0) is later and sub.next(timeout=0) is None
    sub.close()
    assert sub.closed and sub.next() is None


def test_artifact_documents_cross_read_between_the_packages():
    kws = population()
    port = Session(policy=Policy(backend="torch", auto_t=True, t_max=2),
                   device="cpu").solve_bulk([Problem(**kw) for kw in kws[:6]])
    ref = RefSession(policy=RefPolicy(auto_t=True, t_max=2)).solve_bulk(
        [RefProblem(**kw) for kw in kws[:6]])
    for p, r in zip(port, ref):
        s = p.to_json()
        assert RefArtifact.from_json(s).to_json() == s
        t = r.to_json()
        back = PlanArtifact.from_json(t)
        assert back.to_json() == t
        assert back.schedule().makespan == pytest.approx(r.makespan, rel=RTOL)


def test_store_is_not_ported_and_cuda_never_runs_off_the_card(tmp_path):
    # the name is kept from before the plan store was ported (A.9, done):
    # store= now builds the tiered cache, and cache= beside it raises
    from repro_torch.engine.cache import SolutionCache
    from repro_torch.serve import TieredSolutionCache

    with pytest.raises(ValueError, match="either cache= or store="):
        Session(cache=SolutionCache(), store=str(tmp_path / "plans.sqlite"))
    sess = Session(policy=Policy(backend="torch"), store=str(tmp_path / "plans.sqlite"),
                   device="cpu")
    assert isinstance(sess.cache, TieredSolutionCache)
    with pytest.raises(ValueError, match="runs on the card"):
        Session(policy=Policy(backend="cuda"), device="cpu").solve(Problem(**population()[0]))


def test_planner_runs_on_the_port_session():
    from repro.core.planner import BatchSpec as RefBatchSpec
    from repro.core.planner import LinkSpec as RefLinkSpec
    from repro.core.planner import Planner as RefPlanner
    from repro.core.planner import StageSpec as RefStageSpec
    from repro_torch.core.planner import BatchSpec, LinkSpec, Planner, StageSpec

    def build(mod_stage, mod_link, mod_batch, planner, **kw):
        stages = [mod_stage(f"s{i}", f) for i, f in enumerate((4e12, 2e12, 3e12))]
        links = [mod_link(1e9, 1e-4), mod_link(5e8, 2e-4)]
        batches = [mod_batch(64, 4096.0, 1e10), mod_batch(32, 8192.0, 2e10, release_at=0.5)]
        return planner(stages, links, **kw), batches

    p, batches = build(StageSpec, LinkSpec, BatchSpec, Planner,
                       session=Session(device="cpu"))
    r, ref_batches = build(RefStageSpec, RefLinkSpec, RefBatchSpec, RefPlanner)
    got, want = p.plan(batches, q=2), r.plan(ref_batches, q=2)
    assert got.samples and [list(s) for s in got.samples] == [list(s) for s in want.samples]
    assert got.makespan == want.makespan
    bulk = p.plan_bulk([batches, batches[:1]], q=1)  # the engine, on the session's device
    assert all(b.artifact.backend.startswith("torch") for b in bulk)
    auto = p.plan_auto_T(batches, t_max=3, installment_cost=1e-3)
    ref_auto = r.plan_auto_T(ref_batches, t_max=3, installment_cost=1e-3, backend="auto")
    assert auto.t_star == ref_auto.t_star
    assert abs(auto.plan.makespan - ref_auto.plan.makespan) <= RTOL * ref_auto.plan.makespan


def heuristic_instances():
    """Seeded chain instances from the reference's generator (the strategies'
    model), cheap and expensive communications; plus one star (unsupported)."""
    rng = np.random.default_rng(7)
    out = [ref_random_instance(rng, m=m, n_loads=n, q=1, comm_to_comp=cc, with_latency=True)
           for m, n, cc in ((2, 1, 0.02), (3, 2, 0.02), (4, 3, 0.5), (3, 2, 2.0), (5, 2, 0.2))]
    out.append(ref_random_instance(rng, m=3, n_loads=2, q=1, topology="star"))
    return out


@pytest.mark.parametrize("name", list(ALL_HEURISTICS))
def test_heuristics_bit_identical_to_the_reference(name):
    assert list(ALL_HEURISTICS) == list(REF_HEURISTICS)
    for inst in heuristic_instances():
        got = run_strategy(name, ALL_HEURISTICS[name], instance_from_reference(inst))
        want = ref_run_strategy(name, REF_HEURISTICS[name], inst)
        # the reasons name each package's own modules
        reason = got.reason.replace("repro_torch.", "repro.")
        assert (got.failed, got.failure, reason) == (want.failed, want.failure, want.reason)
        if want.failed:
            continue
        assert got.instance.q == want.instance.q
        assert got.gamma.tobytes() == np.asarray(want.gamma).tobytes()
        assert got.makespan == want.makespan
        assert got.schedule.comp_end.tobytes() == want.schedule.comp_end.tobytes()


def test_adversary_sweep_replays_through_the_session():
    from repro.core.heuristics import adversary_sweep as ref_sweep
    from repro_torch.core.heuristics import adversary_sweep

    insts = heuristic_instances()
    got = adversary_sweep([instance_from_reference(i) for i in insts],
                          session=Session(device="cpu"))
    want = ref_sweep(insts, simulator="serial")
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL)


def test_solve_batch_warns_as_the_reference_does():
    """``repro_torch.core.solve_batch`` is deprecated as the reference's is:
    a DeprecationWarning naming ``Session.solve_bulk``, raised at the
    caller's line (the same stacklevel), and the same plans."""
    from repro.core.solver import solve_batch as ref_solve_batch
    from repro_torch.core import solve_batch

    kws = population()[:4]
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.api\.Session\.solve_bulk") as got:
        reports = solve_batch([Problem(**kw).to_instance(1) for kw in kws], backend="serial")
    with pytest.warns(DeprecationWarning, match=r"repro\.api\.Session\.solve_bulk") as want:
        ref = ref_solve_batch([RefProblem(**kw).to_instance(1) for kw in kws], backend="serial")
    assert [w.filename for w in got] == [w.filename for w in want] == [__file__]
    assert len(reports) == len(ref) == len(kws)
    for r, w in zip(reports, ref):
        assert r.status == w.status
        assert abs(r.makespan - w.makespan) <= RTOL * max(1.0, abs(w.makespan))
