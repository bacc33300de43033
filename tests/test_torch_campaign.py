"""The port's campaign (``repro_torch.eval``) against the reference's
(``repro.eval``) and its committed full tier.

* A micro campaign (the reference tests' ``micro_spec``) through the port's
  engine on the CPU (``"torch"``, the kernels' plain versions) against the
  reference's on the serial ``"auto"`` backend: the same labels and content
  keys, and ratios within 1e-9 (the LP optima agree to 1e-9; the heuristic
  makespans are bit-identical host code).
* The port's ``full_spec`` generates the committed tier's 1,296 instances:
  its content keys equal ``bench_out/campaign.json``'s, in order.  This
  checks generation only; the full tier runs on the card
  (``chip_smoke.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from repro.eval import build_document as ref_build_document
from repro.eval import run_campaign as ref_run_campaign
from repro.eval import smoke_spec as ref_smoke_spec
from repro_torch.api import Policy, Session
from repro_torch.core.keys import instance_content_key
from repro_torch.eval import (CampaignSpec, build_document, full_spec, run_campaign, smoke_spec,
                              validate_campaign)
from test_campaign import micro_spec as ref_micro_spec

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-9


def micro_spec(**kw) -> CampaignSpec:
    """The port's copy of the reference tests' micro campaign (8 instances)."""
    return CampaignSpec.from_dict(ref_micro_spec(**kw).to_dict())


def assert_same_rows(got: dict, want: dict):
    assert len(got["instances"]) == len(want["instances"])
    for g, w in zip(got["instances"], want["instances"]):
        assert (g["cell_id"], g["index"], g["content_key"], g["label"], g["best_strategy"]) == \
            (w["cell_id"], w["index"], w["content_key"], w["label"], w["best_strategy"])
        assert (g["ratio"] is None) == (w["ratio"] is None)
        if w["ratio"] is not None:
            assert abs(g["ratio"] - w["ratio"]) <= RTOL * abs(w["ratio"])


@pytest.mark.parametrize("releases", [(False, True), (True,)])
def test_micro_campaign_on_the_port_engine_matches_the_reference(releases):
    spec = micro_spec(releases=releases)
    got = run_campaign(spec, Session(policy=Policy(backend="torch"), device="cpu"))
    want = ref_run_campaign(ref_micro_spec(releases=releases))
    assert got.n == want.n and got.anomalies == [] and got.domination_rate == 1.0
    doc = build_document(got)
    assert validate_campaign(doc) == []
    assert_same_rows(doc, ref_build_document(want))


def test_micro_campaign_on_the_serial_backend_is_the_reference_document():
    spec = micro_spec()
    got = build_document(run_campaign(spec))  # spec.backend is "auto"
    want = ref_build_document(ref_run_campaign(ref_micro_spec()))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_presets_default_to_the_card_and_match_the_reference_grid():
    for port, ref in ((smoke_spec(), ref_smoke_spec()), (full_spec(), None)):
        assert port.backend == "cuda" and port.matched_backend == "auto"
        if ref is not None:
            d = dict(ref.to_dict(), backend="cuda")
            assert port.to_dict() == d


def test_full_spec_generates_the_committed_tier():
    golden = json.loads((REPO / "bench_out" / "campaign.json").read_text())
    spec = full_spec()
    want = {k: v for k, v in golden["spec"].items() if k != "backend"}
    assert {k: v for k, v in spec.to_dict().items() if k != "backend"} == want
    rows = [(CampaignSpec.cell_id(cell), idx, instance_content_key(inst))
            for cell, idx, inst in spec.instances()]
    assert len(rows) == golden["totals"]["n"] == 1296
    assert rows == [(r["cell_id"], r["index"], r["content_key"]) for r in golden["instances"]]


def test_cli_never_writes_the_reference_record(tmp_path):
    from repro_torch.eval.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["--smoke", "--out", str(REPO / "bench_out")])
    assert e.value.code == 2


def full_tier_instance(cell_id: str):
    spec = full_spec()
    cell = next(c for c in spec.cells() if CampaignSpec.cell_id(c) == cell_id)
    return spec.materialize(cell, 0)


def highs_makespan(inst) -> float:
    from repro_torch.core.backends import _solve_scipy
    from repro_torch.core.lp import build_lp, extract_schedule
    from repro_torch.core.simulator import simulate

    lp = build_lp(inst)
    x, status = _solve_scipy(lp)
    assert status == "optimal"
    return simulate(inst, extract_schedule(lp, x).gamma).makespan


def test_serial_simplex_infeasible_exit_is_rescued_by_highs():
    """A feasible but badly scaled schedule LP of the full tier (w 1e-8,
    v_comm 2.4e11, a release date and returns) on which the dense simplex
    exits "infeasible": the reference's serial path reports that (ROADMAP
    C.7); the port's rescues it through HiGHS, as it rescues an
    "unbounded" exit."""
    from repro.api import Policy as RefPolicy
    from repro.api import Session as RefSession
    from repro.core.instance import Chain, Instance, Loads

    inst = full_tier_instance("chain/ret0.75/rel1/m4/n1/q4/het0/cc5")
    got = Session().solve(inst)
    assert got.ok and abs(got.makespan - highs_makespan(inst)) <= RTOL * got.makespan
    p, ld = inst.platform, inst.loads
    ref = Instance(Chain(w=p.w, z=p.z, tau=p.tau, latency=p.latency),
                   Loads(v_comm=ld.v_comm, v_comp=ld.v_comp, release=ld.release,
                         return_ratio=ld.return_ratio), q=inst.q)
    assert RefSession(policy=RefPolicy()).solve(ref).status == "infeasible"


def test_engine_values_are_re_solved_from_the_exit_basis():
    """An ill-conditioned instance of the full tier (communications 5x the
    computation at m = 8, q = 4 over 3 loads) on which the tableau's values,
    after hundreds of pivots, replay to more than 1e-9 above the optimum;
    re-solved from the exit basis, the engine's plan replays to the HiGHS
    optimum."""
    from repro_torch.engine import solve_bulk

    inst = full_tier_instance("chain/ret0/rel0/m8/n3/q4/het1/cc5")
    (r,) = solve_bulk([inst], device="cpu")
    assert r.backend == "torch" and r.telemetry["lp"]["status"] == "optimal"
    want = highs_makespan(inst)
    assert abs(r.makespan - want) <= 1e-12 * want
    assert abs(r.lp_makespan - want) <= 1e-12 * want


def test_refinement_keeps_lanes_it_cannot_re_solve():
    """Lanes whose exit basis holds the dummy column, or whose basis matrix
    is singular, keep the tableau's values; optimal lanes take the
    re-solved ones."""
    import torch

    from repro_torch.engine import batched_simplex as bs

    # min -x0 - x1  s.t.  x0 + 2 x1 <= 4,  3 x0 + x1 <= 6  (optimum (1.6, 1.2))
    A = torch.tensor([[[1.0, 2.0], [3.0, 1.0]]], dtype=torch.float64).repeat(3, 1, 1)
    b = torch.tensor([[4.0, 6.0]], dtype=torch.float64).repeat(3, 1)
    c = torch.tensor([[-1.0, -1.0]], dtype=torch.float64).repeat(3, 1)
    none = torch.zeros(3, 0, 2, dtype=torch.float64), torch.zeros(3, 0, dtype=torch.float64)
    _, _, _, col = bs._standard_rows(c, A, b, *none)
    x0 = torch.full((3, 2), 7.0, dtype=torch.float64)
    basis = torch.tensor([[0, 1], [0, 4], [0, 0]], dtype=torch.int32)  # dummy id is 4
    status = torch.zeros(3, dtype=torch.int32)
    x, obj = bs._refine(x0, -x0.sum(1), status, basis, c, A, b, *none, col, 4)
    torch.testing.assert_close(x[0], torch.tensor([1.6, 1.2], dtype=torch.float64))
    assert abs(obj[0].item() + 2.8) <= 1e-15
    assert torch.equal(x[1:], x0[1:]) and torch.equal(obj[1:], -x0[1:].sum(1))
