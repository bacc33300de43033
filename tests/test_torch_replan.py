"""The port's replanning runtime (``repro_torch.runtime.replan``, ``ft``)
against the reference's, on the CPU with the ``"torch"`` engine backend.

* In-process, the pure parts: ``_fold`` of every event type and the fault
  tolerance machinery (``RecoveringChain``, ``FailureSim``,
  ``StragglerSim``; ``tests/test_ft.py``'s eight cases as one parametrised
  test) equal the reference's within 1e-9.
* Through a child process with the ``enable_x64`` alias (the reference's
  engine does not import here without it, ROADMAP C.1): an eight-event
  stream through ``EventStreamReplanner``, warm and cold, whose makespans
  and provenance (``warm_requested``, ``warm``, ``cache_hit``) equal the
  reference's.
* The port's own copies of ``tests/test_replan.py``'s replanner cases.
* ``ChainReplanner`` (``repro_torch.runtime.dlt_runner``) with
  ``backend="torch"`` on the CPU: the copies of the reference's cases
  (``tests/test_replan.py:176``, ``tests/test_api_session.py:384``,
  ``tests/test_backends_auto_t.py:224``, ``tests/test_engine_wiring.py:50-70``),
  and ``replan``, ``on_failure``, ``what_if_speeds`` and
  ``auto_installments`` within 1e-9 of the reference's (its engine in the
  child process with the alias).
"""

from __future__ import annotations

import numpy as np
import pytest

import repro.core.planner as ref_planner
import repro.runtime.ft as ref_ft
import repro.runtime.replan as ref_replan
from repro.api import Problem as RefProblem
import repro_torch.core.planner as port_planner
import repro_torch.runtime.ft as port_ft
import repro_torch.runtime.replan as port_replan
from repro_torch.api import Policy, Problem, Session
from repro_torch.runtime.replan import (
    EventStreamReplanner,
    LoadArrived,
    ProcessorDown,
    ProcessorUp,
    SpeedObserved,
)
from test_torch_engine import run_reference

RTOL = 1e-9
_POLICY = Policy(installments=2, backend="torch")
_FIELDS = ("w", "z", "v_comm", "v_comp", "topology", "tau", "latency", "release",
           "return_ratio", "w_per_load")


def _spec(topology="chain", m=3, per_load=False):
    kw = dict(w=[1.0 + 0.25 * i for i in range(m)],
              z=[0.1 + 0.05 * i for i in range(m - 1)],
              v_comm=[1.0, 2.0], v_comp=[3.0, 4.0], latency=0.05,
              release=[0.0, 0.5], topology=topology)
    if per_load:
        kw["w_per_load"] = [[1.0 + 0.25 * i, 1.5 + 0.1 * i] for i in range(m)]
    return kw


def _problem(topology="chain", m=3):
    return Problem(**_spec(topology, m))


def _session():
    return Session(_POLICY, device="cpu")


# ================================================================ _fold


# (event type name, keyword arguments): the same event built in each package
EVENTS = [
    ("SpeedObserved", dict(index=1, w=9.0)),
    ("SpeedObserved", dict(index=0, w=0.5)),
    ("LoadArrived", dict(v_comm=0.5, v_comp=1.5, release=2.0, return_ratio=0.25)),
    ("LoadArrived", dict(v_comm=0.5, v_comp=1.5, deadline=7.0)),
    ("ProcessorDown", dict(index=1, restore_delay=0.5)),
    ("ProcessorDown", dict(index=0)),
    ("ProcessorDown", dict(index=3)),
    ("ProcessorUp", dict(w=1.7, z=0.4, latency=0.02, tau=1.0)),
]


def _fields(p) -> dict:
    return {f: getattr(p, f) for f in _FIELDS}


@pytest.mark.parametrize("per_load", [False, True], ids=["w", "w_per_load"])
@pytest.mark.parametrize("topology", ["chain", "star"])
@pytest.mark.parametrize("name,kw", EVENTS, ids=[f"{n}{i}" for i, (n, _) in enumerate(EVENTS)])
def test_fold_equals_the_references(name, kw, topology, per_load):
    spec = _spec(topology, m=4, per_load=per_load)
    port_ev, ref_ev = getattr(port_replan, name)(**kw), getattr(ref_replan, name)(**kw)
    if topology == "star" and name == "ProcessorDown" and kw["index"] == 0:
        for fold, p, ev in ((port_replan._fold, Problem(**spec), port_ev),
                            (ref_replan._fold, RefProblem(**spec), ref_ev)):
            with pytest.raises(ValueError, match="master"):
                fold(p, ev)
        return
    got = _fields(port_replan._fold(Problem(**spec), port_ev))
    want = _fields(ref_replan._fold(RefProblem(**spec), ref_ev))
    assert got == want


@pytest.mark.parametrize("name,kw,problem_kw,exc", [
    ("SpeedObserved", dict(index=5, w=1.0), {}, ValueError),
    ("ProcessorDown", dict(index=-1), {}, ValueError),
    ("ProcessorDown", dict(index=0), dict(m=1), ValueError),
    ("LoadArrived", dict(v_comm=1, v_comp=1, release=5.0, deadline=4.0), {}, ValueError),
], ids=["speed_range", "down_range", "last_processor", "deadline_before_release"])
def test_fold_refuses_what_the_reference_refuses(name, kw, problem_kw, exc):
    m = problem_kw.get("m", 3)
    spec = _spec(m=m) if m > 1 else dict(w=[1.0], z=[], v_comm=[1.0], v_comp=[1.0])
    messages = []
    for mod, P in ((port_replan, Problem), (ref_replan, RefProblem)):
        with pytest.raises(exc) as ei:
            mod._fold(P(**spec), getattr(mod, name)(**kw))
        messages.append(str(ei.value))
    assert messages[0] == messages[1]
    with pytest.raises(TypeError, match="unknown replan event"):
        port_replan._fold(_problem(), object())


# ================================================================ ft


def _ft_case(case: str, ft, planner) -> list:
    """Run one of ``tests/test_ft.py``'s scenarios with ``ft``/``planner``
    (either package's modules); returns plain records of what it produced."""

    def chain(m=4, q=1, n_loads=2):
        stages = [planner.StageSpec(f"s{i}", 1e9 / (1 + 0.2 * i)) for i in range(m)]
        links = [planner.LinkSpec(bytes_per_sec=1e8, startup_sec=1e-4) for _ in range(m - 1)]
        loads = [planner.BatchSpec(num_samples=32, bytes_per_sample=1e4, flops_per_sample=1e6)
                 for _ in range(n_loads)]
        return ft.RecoveringChain(planner.Planner(stages, links), loads, q=q)

    def record(c, **extra):
        return dict(makespan=c.plan.makespan,
                    samples=[[int(x) for x in s] for s in c.plan.samples],
                    totals=[c.plan.total_samples(n) for n in range(len(c.batches))],
                    names=c.stage_names(), generation=c.generation, replans=c.replans,
                    log=list(c.log), z=[1.0 / lk.bytes_per_sec for lk in c.planner.links],
                    **extra)

    if case == "plan_conserves_samples":
        return [record(chain(q=2))]
    if case == "failure_drops_stage_and_replans":
        c = chain()
        before = c.plan.makespan
        c.on_failure(ft.FailureEvent(step=3, stage=1, restore_delay=0.1))
        return [record(c, before=before)]
    if case == "head_and_tail_failures":
        out = []
        for dead in (0, 3):
            c = chain()
            c.on_failure(ft.FailureEvent(step=0, stage=dead))
            out.append(record(c))
        return out
    if case == "link_fusion_on_middle_failure":
        c = chain()
        z_before = [1.0 / lk.bytes_per_sec for lk in c.planner.links]
        c.on_failure(ft.FailureEvent(step=0, stage=2))
        return [record(c, z_before=z_before)]
    if case == "straggler_shifts_load_off_slow_stage":
        c = chain(m=3)
        slow_before = sum(int(s[1]) for s in c.plan.samples)
        fired = []
        for _ in range(6):
            fired.append(bool(c.on_observation(1, c.planner.stages[1].flops_per_sec / 4)))
            if fired[-1]:
                break
        return [record(c, slow_before=slow_before, fired=fired)]
    if case == "elastic_join_adds_capacity":
        c = chain(m=2)
        c.on_join(planner.StageSpec("new", 1e9), planner.LinkSpec(1e8, 1e-4))
        return [record(c)]
    if case == "failure_sim_fires_once":
        sim = ft.FailureSim([ft.FailureEvent(step=5, stage=1)])
        fired = [sim.check(s) for s in (4, 5, 5)]
        return [dict(fired=[None if e is None else (e.step, e.stage) for e in fired])]
    if case == "straggler_sim_profile":
        s = ft.StragglerSim(stage=2, after_step=10, slowdown=2.0)
        return [dict(speeds=[s.effective_speed(2, 100.0, 9), s.effective_speed(2, 100.0, 10),
                             s.effective_speed(1, 100.0, 99)])]
    raise ValueError(case)


def _assert_close_records(got, want, path="record"):
    if isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL, abs=RTOL), path
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_close_records(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_records(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


FT_CASES = ["plan_conserves_samples", "failure_drops_stage_and_replans",
            "head_and_tail_failures", "link_fusion_on_middle_failure",
            "straggler_shifts_load_off_slow_stage", "elastic_join_adds_capacity",
            "failure_sim_fires_once", "straggler_sim_profile"]


@pytest.mark.parametrize("case", FT_CASES)
def test_ft_equals_the_references(case):
    got = _ft_case(case, port_ft, port_planner)
    _assert_close_records(got, _ft_case(case, ref_ft, ref_planner))
    # and each case's own property (tests/test_ft.py), on the port
    rec = got[0]
    if "totals" in rec:
        assert all(t == 32 for r in got for t in r["totals"])
    if case == "failure_drops_stage_and_replans":
        assert rec["names"] == ["s0", "s2", "s3"] and rec["generation"] == 1
        assert rec["makespan"] >= 0.1  # the restore delay floors availability
    elif case == "head_and_tail_failures":
        assert [len(r["names"]) for r in got] == [3, 3]
    elif case == "link_fusion_on_middle_failure":
        assert len(rec["z"]) == len(rec["z_before"]) - 1
        assert rec["z"][1] == pytest.approx(rec["z_before"][1] + rec["z_before"][2])
    elif case == "straggler_shifts_load_off_slow_stage":
        assert rec["fired"][-1], "10% drift must trigger a replan"
        assert sum(s[1] for s in rec["samples"]) <= rec["slow_before"]
    elif case == "elastic_join_adds_capacity":
        assert len(rec["names"]) == 3
    elif case == "failure_sim_fires_once":
        assert rec["fired"] == [None, (5, 1), None]
    elif case == "straggler_sim_profile":
        assert rec["speeds"] == [100.0, 50.0, 100.0]


# ================================================================ the stream against the reference


STREAM = [
    ("SpeedObserved", dict(index=1, w=1.9)),
    ("SpeedObserved", dict(index=2, w=1.4)),
    ("SpeedObserved", dict(index=0, w=1.1)),
    ("LoadArrived", dict(v_comm=0.5, v_comp=1.5, release=0.2)),
    ("SpeedObserved", dict(index=3, w=2.0)),
    ("ProcessorDown", dict(index=1, restore_delay=0.3)),
    ("SpeedObserved", dict(index=1, w=1.6)),
    ("ProcessorUp", dict(w=1.3, z=0.2, latency=0.02)),
]
_PROVENANCE = ("kind", "trigger", "warm_requested", "warm", "cache_hit")

CHILD = r"""
from repro.api import Policy, Problem, Session
import repro.runtime.replan as replan

src = pickle.load(open(sys.argv[1], "rb"))
out = {}
for topology, spec in src["problems"].items():
    for warm in (True, False):
        sess = Session(Policy(installments=2, backend="batched"))
        rp = replan.EventStreamReplanner(sess, Problem(**spec), warm=warm)
        arts = [rp.artifact] + [rp.apply(getattr(replan, n)(**kw)) for n, kw in src["events"]]
        out[(topology, warm)] = [dict(makespan=a.makespan, status=a.status,
                                      event=dict(a.events[-1]) if a.events else None)
                                 for a in arts]
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def reference_stream(tmp_path_factory):
    """The reference replanner's artifacts over :data:`STREAM`, computed in
    a child process."""
    problems = {t: _spec(t, m=4) for t in ("chain", "star")}
    return run_reference(CHILD, {"problems": problems, "events": STREAM},
                         tmp_path_factory.mktemp("replan_ref"))


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("topology", ["chain", "star"])
def test_event_stream_equals_the_references(reference_stream, topology, warm):
    rp = EventStreamReplanner(_session(), Problem(**_spec(topology, m=4)), warm=warm)
    arts = [rp.artifact] + [rp.apply(getattr(port_replan, n)(**kw)) for n, kw in STREAM]
    want = reference_stream[(topology, warm)]
    assert len(arts) == len(want) == len(STREAM) + 1
    n_warm = 0
    for k, (a, w) in enumerate(zip(arts, want)):
        assert a.ok and a.status == w["status"], k
        assert a.makespan == pytest.approx(w["makespan"], rel=RTOL), k
        if k == 0:
            continue
        ev = a.events[-1]
        assert {f: ev[f] for f in _PROVENANCE} == {f: w["event"][f] for f in _PROVENANCE}, k
        if ev["warm"]:
            n_warm += 1
            assert ev["pivots_phase1"] == 0
        if ev["trigger"] != "SpeedObserved":
            assert not ev["warm_requested"] and not ev["warm"]
    assert (n_warm > 0) == warm


# ================================================================ the warm entry


def test_warm_entry_rejects_a_singular_seed_alone():
    # the reference factors a bucket's seeds in one NumPy call, so one
    # exactly singular seed sends the whole bucket cold; the port factors
    # each lane on the device and rejects that lane alone, counting why
    from repro_torch.core.instance import random_instance
    from repro_torch.engine import solve_bulk
    from repro_torch.obs import metrics as obs_metrics

    rng = np.random.default_rng(3)
    insts = [random_instance(rng, m=4, n_loads=2, q=2) for _ in range(4)]
    cold = solve_bulk(insts, device="cpu")
    bases = [list(r.telemetry["lp"]["final_basis"]) for r in cold]
    bases[2][1] = bases[2][0]  # a repeated column: an exactly singular basis matrix
    bases[3] = None  # no seed
    reg = obs_metrics.get_registry()
    before = reg.value("repro_simplex_warm_rejects_total", reason="singular")
    warm = solve_bulk(insts, device="cpu", warm_starts=bases)
    assert [r.telemetry["lp"]["warm"] for r in warm] == [True, True, False, False]
    assert reg.value("repro_simplex_warm_rejects_total", reason="singular") == before + 1
    for w, c in zip(warm, cold):
        assert w.makespan == pytest.approx(c.makespan, rel=RTOL)


# ================================================================ the port's replanner


def test_replanner_warm_provenance_and_basis_carry():
    rp = EventStreamReplanner(_session(), _problem())
    assert rp.artifact is not None and rp._basis is not None
    ev = rp.apply(SpeedObserved(1, 1.9)).events[-1]
    assert ev["kind"] == "replan" and ev["trigger"] == "SpeedObserved"
    assert ev["warm_requested"] and ev["warm"]
    assert ev["pivots_phase1"] == 0  # the whole point: phase 1 skipped
    ev2 = rp.apply(ProcessorUp(w=1.3, z=0.2)).events[-1]  # structural: cold
    assert not ev2["warm_requested"] and not ev2["warm"]
    assert rp._basis is not None


def test_replanner_warm_false_never_seeds():
    rp = EventStreamReplanner(_session(), _problem(), warm=False)
    art = rp.apply(SpeedObserved(0, 1.2))
    assert not art.events[-1]["warm_requested"] and art.ok


def test_replanner_deadline_recorded():
    rp = EventStreamReplanner(_session(), _problem())
    met = rp.apply(LoadArrived(v_comm=0.1, v_comp=0.1, deadline=1e9))
    assert met.events[-1]["deadline_met"] is True
    missed = rp.apply(LoadArrived(v_comm=0.1, v_comp=0.1, deadline=1e-9))
    assert missed.events[-1]["deadline_met"] is False
    assert missed.ok  # a missed deadline is provenance, not a failure


def test_replanner_cache_hit_keeps_basis():
    rp = EventStreamReplanner(_session(), _problem())
    rp.apply(SpeedObserved(1, 1.9))
    basis1 = rp._basis
    rp.apply(SpeedObserved(1, float(_problem().w[1])))  # back to the start
    rp.apply(SpeedObserved(1, 1.9))  # quantized-identical to the 2nd state
    assert rp.artifact.cache_hit
    assert rp._basis == basis1  # kept, not dropped
    assert rp.apply(SpeedObserved(1, 1.88)).events[-1]["warm_requested"]


def test_replanner_serializes_through_artifacts():
    from repro_torch.api import PlanArtifact

    sess = _session()
    rp = EventStreamReplanner(sess, _problem())
    art = rp.apply(SpeedObserved(1, 1.9))
    revived = PlanArtifact.from_json(art.to_json())
    rp2 = EventStreamReplanner(sess, revived.problem, solve_initial=False)
    rp2.artifact = revived
    rp2._basis = EventStreamReplanner._extract_basis(revived)
    assert rp2._basis == rp._basis
    a = rp2.apply(SpeedObserved(1, 1.7))
    assert a.events[-1]["warm_requested"] and a.ok


def test_replanner_publishes_every_apply_in_order():
    rp = EventStreamReplanner(_session(), _problem())
    arts = rp.replay([SpeedObserved(1, 1.9), SpeedObserved(0, 1.1)])
    sub = rp.subscription
    seen = [sub.next(timeout=1) for _ in range(3)]  # initial + 2 replans
    assert seen[0].events == () or seen[0].events[-1].get("kind") != "replan"
    assert seen[1].events[-1]["trigger"] == "SpeedObserved"
    assert [s.makespan for s in seen[1:]] == [a.makespan for a in arts]
    assert sub.problem == rp.problem


def _debounced(window):
    clk = [0.0]
    rp = EventStreamReplanner(_session(), _problem(), debounce_window=window,
                              clock=lambda: clk[0])
    return rp, clk


def test_debounce_storm_one_solve_per_window():
    rp, clk = _debounced(1.0)
    stale = rp.artifact
    for k in range(50):
        clk[0] += 0.01  # 50 ticks, all inside the 1s window
        assert rp.apply(SpeedObserved(1, 1.5 + 0.001 * k)) is stale
    assert rp.solve_count == 0
    assert rp.problem.w[1] == pytest.approx(1.5 + 0.001 * 49)  # folds are immediate
    clk[0] = 2.0  # past the window edge: the next event fires the solve
    art = rp.apply(SpeedObserved(1, 1.7))
    assert rp.solve_count == 1
    assert art.events[-1]["coalesced"] == 50 and art.problem.w[1] == pytest.approx(1.7)


def test_debounce_multiple_windows_one_solve_each():
    rp, clk = _debounced(1.0)
    for window in range(3):
        base = float(2 * window)
        for k in range(10):  # burst inside the window
            clk[0] = base + 0.05 * (k + 1)
            rp.apply(SpeedObserved(1, 1.2 + 0.01 * k))
        clk[0] = base + 1.5  # edge crossed: this event solves the backlog
        rp.apply(SpeedObserved(1, 1.4 + 0.1 * window))
    assert rp.solve_count == 3


def test_debounce_flush_solves_backlog_once():
    rp, clk = _debounced(10.0)
    for k in range(5):
        clk[0] += 0.1
        rp.apply(SpeedObserved(1, 1.5 + 0.01 * k))
    art = rp.flush()
    assert rp.solve_count == 1 and art.events[-1]["coalesced"] == 4
    assert art is rp.flush() and rp.solve_count == 1  # empty backlog: a no-op


def test_debounce_structural_event_flushes_backlog():
    rp, _ = _debounced(10.0)
    rp.apply(SpeedObserved(1, 1.5))
    rp.apply(SpeedObserved(2, 1.6))
    art = rp.apply(ProcessorUp(w=1.7, z=0.4))
    assert rp.solve_count == 1
    ev = art.events[-1]
    assert ev["trigger"] == "ProcessorUp" and ev["coalesced"] == 2
    assert not ev["warm_requested"]
    assert len(art.problem.w) == 4 and art.problem.w[1] == pytest.approx(1.5)


def test_debounce_close_flushes():
    rp, _ = _debounced(10.0)
    rp.apply(SpeedObserved(1, 1.9))
    rp.close()
    assert rp.solve_count == 1 and rp.subscription.closed
    assert rp.artifact.problem.w[1] == pytest.approx(1.9)


def test_debounce_disabled_by_default_and_validates():
    rp = EventStreamReplanner(_session(), _problem())
    rp.apply(SpeedObserved(1, 1.5))
    assert rp.solve_count == 1 and "coalesced" not in rp.artifact.events[-1]
    with pytest.raises(ValueError, match="debounce_window"):
        EventStreamReplanner(_session(), _problem(), debounce_window=0.0)


def test_replanned_artifact_equals_a_cold_solve_of_the_folded_problem():
    # the event log and a cold solve of the folded problem give one plan
    rp = EventStreamReplanner(_session(), _problem(m=4))
    for n, kw in STREAM:
        art = rp.apply(getattr(port_replan, n)(**kw))
    cold = Session(_POLICY, device="cpu").solve(rp.problem)
    assert art.problem == cold.problem
    assert art.makespan == pytest.approx(cold.makespan, rel=RTOL)


# ================================================================ ChainReplanner

_CHAIN_STAGES = [port_planner.StageSpec(f"s{i}", 1e9 * (1 + 0.3 * i)) for i in range(3)]
_CHAIN_LINKS = [port_planner.LinkSpec(1e8, 50e-6)] * 2
_CHAIN_BATCHES = [port_planner.BatchSpec(num_samples=64, bytes_per_sample=4096,
                                         flops_per_sample=1e7) for _ in range(2)]
_SCALES = [[1.0, 1.0, 1.0], [0.25, 1.0, 1.0], [1.0, 0.5, 1.0], [1.0, 1.0, 0.7], [2.0, 1.0, 0.9]]


def _chain_replanner(q=2):
    from repro_torch.runtime.dlt_runner import ChainReplanner

    planner = port_planner.Planner(list(_CHAIN_STAGES), list(_CHAIN_LINKS))
    return ChainReplanner(planner, q=q, backend="torch", device="cpu")


def test_chain_replanner_stream_bridge():
    from repro_torch.runtime.dlt_runner import ChainReplanner

    stages = [port_planner.StageSpec("s0", flops_per_sec=1e9),
              port_planner.StageSpec("s1", flops_per_sec=2e9),
              port_planner.StageSpec("s2", flops_per_sec=1.5e9)]
    links = [port_planner.LinkSpec(bytes_per_sec=1e9), port_planner.LinkSpec(bytes_per_sec=2e9)]
    cr = ChainReplanner(port_planner.Planner(stages, links), q=2, backend="torch", device="cpu")
    batches = [port_planner.BatchSpec(num_samples=64, bytes_per_sample=1e6,
                                      flops_per_sample=1e7)]
    rp = cr.stream(batches)
    assert isinstance(rp, EventStreamReplanner)
    assert rp.session is cr.session  # shares cache + backend handles
    art = rp.apply(SpeedObserved(1, rp.problem.w[1] * 1.2))
    assert art.ok and art.events[-1]["kind"] == "replan"
    rp.close()


def test_chain_replanner_shares_the_planner_session():
    rp = _chain_replanner()
    plan = rp.replan(_CHAIN_BATCHES)
    assert rp.session is rp.planner.session and rp.session.device.type == "cpu"
    assert plan.artifact is not None and plan.artifact.ok
    # failure replan keeps the same session (cache carries over)
    rp.on_failure(1, _CHAIN_BATCHES, restore_delay=0.01)
    assert rp.planner.session is rp.session
    mks = rp.what_if_speeds(_CHAIN_BATCHES, [[1.0, 1.0], [0.5, 1.0]])
    assert mks.shape == (2,) and mks[1] >= mks[0] - 1e-12


def test_chain_replanner_auto_installments():
    rp = _chain_replanner()
    res = rp.auto_installments(_CHAIN_BATCHES, t_max=3, installment_cost=1e-3)
    assert res.t_star in (1, 2, 3)
    assert res.plan.makespan > 0
    again = rp.auto_installments(_CHAIN_BATCHES, t_max=3, installment_cost=1e-3)
    assert all(r.backend == "torch+cache" for r in again.reports)


def test_chain_replanner_lifecycle():
    rp = _chain_replanner()
    plan = rp.replan(_CHAIN_BATCHES)
    assert plan.result.backend.startswith("torch")
    # same platform state on the next tick: must be a cache hit
    again = rp.replan(_CHAIN_BATCHES)
    assert again.result.backend == "torch+cache"
    assert again.makespan == pytest.approx(plan.makespan, abs=1e-9)
    # losing a stage fuses the links and still re-solves through the engine
    plan2 = rp.on_failure(1, _CHAIN_BATCHES, restore_delay=0.01)
    assert len(rp.planner.stages) == len(_CHAIN_STAGES) - 1
    assert plan2.makespan > 0
    # no-drift observation returns None; a big drift triggers a fresh plan
    rp2 = _chain_replanner()
    rp2.replan(_CHAIN_BATCHES)
    assert rp2.observe(0, _CHAIN_STAGES[0].flops_per_sec, _CHAIN_BATCHES) is None
    assert rp2.observe(0, _CHAIN_STAGES[0].flops_per_sec * 0.2, _CHAIN_BATCHES) is not None


def test_what_if_speeds_orders_scenarios_and_validates_shape():
    rp = _chain_replanner()
    mks = rp.what_if_speeds(_CHAIN_BATCHES, [[1.0, 1.0, 1.0], [0.25, 1.0, 1.0]])
    assert mks.shape == (2,)
    assert mks[1] > mks[0]  # slowing a stage can only hurt
    with pytest.raises(ValueError):  # wrong row length must not zip-truncate
        rp.what_if_speeds(_CHAIN_BATCHES, [[1.0, 1.0]])


def test_chain_replanner_cuda_backend_needs_the_card():
    import torch

    from repro_torch.runtime.dlt_runner import ChainReplanner

    planner = port_planner.Planner(list(_CHAIN_STAGES), list(_CHAIN_LINKS))
    with pytest.raises(ValueError, match="runs on the card"):
        ChainReplanner(planner, device="cpu")  # the default backend is "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default backend runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChainReplanner(port_planner.Planner(list(_CHAIN_STAGES), list(_CHAIN_LINKS)))


CHAIN_CHILD = r"""
from repro.core.planner import BatchSpec, LinkSpec, Planner, StageSpec
from repro.runtime.dlt_runner import ChainReplanner

src = pickle.load(open(sys.argv[1], "rb"))
stages = [StageSpec(*s) for s in src["stages"]]
links = [LinkSpec(*l) for l in src["links"]]
batches = [BatchSpec(*b) for b in src["batches"]]
rp = ChainReplanner(Planner(stages, links), q=2)
out = {"replan": rp.replan(batches).makespan,
       "what_if": list(rp.what_if_speeds(batches, src["scales"]))}
res = rp.auto_installments(batches, t_max=3, installment_cost=1e-3)
out["auto_t"] = (res.t_star, dict(res.makespans), res.plan.makespan)
out["on_failure"] = rp.on_failure(1, batches, restore_delay=0.01).makespan
out["what_if_after"] = list(rp.what_if_speeds(batches, [s[:2] for s in src["scales"]]))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def test_chain_replanner_makespans_equal_the_references(tmp_path):
    payload = dict(stages=[(s.name, s.flops_per_sec) for s in _CHAIN_STAGES],
                   links=[(l.bytes_per_sec, l.startup_sec) for l in _CHAIN_LINKS],
                   batches=[(b.num_samples, b.bytes_per_sample, b.flops_per_sample)
                            for b in _CHAIN_BATCHES], scales=_SCALES)
    want = run_reference(CHAIN_CHILD, payload, tmp_path)
    rp = _chain_replanner()
    assert rp.replan(_CHAIN_BATCHES).makespan == pytest.approx(want["replan"], rel=RTOL)
    np.testing.assert_allclose(rp.what_if_speeds(_CHAIN_BATCHES, _SCALES), want["what_if"],
                               rtol=RTOL)
    res = rp.auto_installments(_CHAIN_BATCHES, t_max=3, installment_cost=1e-3)
    t_star, makespans, best = want["auto_t"]
    assert res.t_star == t_star and set(res.makespans) == set(makespans)
    for q, mk in makespans.items():
        assert res.makespans[q] == pytest.approx(mk, rel=RTOL)
    assert res.plan.makespan == pytest.approx(best, rel=RTOL)
    assert rp.on_failure(1, _CHAIN_BATCHES, restore_delay=0.01).makespan == pytest.approx(
        want["on_failure"], rel=RTOL)
    np.testing.assert_allclose(rp.what_if_speeds(_CHAIN_BATCHES, [s[:2] for s in _SCALES]),
                               want["what_if_after"], rtol=RTOL)
