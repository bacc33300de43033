"""Campaign execution: drive the grid through the Session and the §3 strategies.

The runner is the glue between :mod:`repro_torch.eval.spec` (what to sweep),
:mod:`repro_torch.api` (the LP side — every instance is bulk-submitted to one
coalescing :class:`Session` on the spec's backend, so the engine buckets
and batches the whole campaign), :mod:`repro_torch.core.heuristics` (the paper's
strategies, run through the never-raising ``run_strategy`` contract), and
:mod:`repro_torch.eval.classify` (the verdicts).

Anomaly candidates re-solve at the heuristic's exact installment structure
through a dedicated serial-backend session (``spec.matched_backend``) — a
lazy path that costs nothing on the expected all-clean campaign.

Observability: the run is wrapped in an ``eval.campaign`` span with
``eval.generate`` / ``eval.lp`` / ``eval.heuristics`` / ``eval.classify``
stage spans, and per-class ``repro_campaign_instances_total`` counters plus
``repro_campaign_anomalies_total`` / per-strategy
``repro_campaign_strategy_failures_total`` land in the metrics registry.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.api import Policy, Session
from repro_torch.core.heuristics import ALL_HEURISTICS, multi_inst, run_strategy
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import span

from .classify import Classification, classify_instance
from .spec import CampaignSpec

__all__ = ["CampaignAnomalyError", "CampaignResult", "run_campaign"]


class CampaignAnomalyError(AssertionError):
    """The domination invariant broke: one or more instances classified
    ``anomaly``.  Carries the offending classifications for replay."""

    def __init__(self, anomalies: list):
        self.anomalies = list(anomalies)
        lines = [f"{len(self.anomalies)} campaign anomaly(ies):"]
        for c in self.anomalies[:10]:
            kind = (c.anomaly or {}).get("kind", "?")
            lines.append(
                f"  [{kind}] cell={c.cell_id} index={c.index} "
                f"key={c.content_key} lp={c.lp_makespan} best={c.best_makespan}"
            )
        if len(self.anomalies) > 10:
            lines.append(f"  ... and {len(self.anomalies) - 10} more")
        super().__init__("\n".join(lines))


@dataclasses.dataclass
class CampaignResult:
    """Everything one campaign produced: spec + per-instance verdicts."""

    spec: CampaignSpec
    classifications: list  # Classification, canonical grid order

    @property
    def n(self) -> int:
        return len(self.classifications)

    def counts(self) -> dict:
        out: dict = {}
        for c in self.classifications:
            out[c.label] = out.get(c.label, 0) + 1
        return out

    @property
    def anomalies(self) -> list:
        return [c for c in self.classifications if c.label == "anomaly"]

    @property
    def domination_rate(self) -> float:
        """Fraction of instances where the LP was not beaten (1 - anomalies/n)."""
        return 1.0 - (len(self.anomalies) / self.n) if self.n else 1.0

    def require_clean(self) -> "CampaignResult":
        """Hard-fail on any anomaly (the campaign's central invariant)."""
        bad = self.anomalies
        if bad:
            raise CampaignAnomalyError(bad)
        return self


def _strategy_fns(spec: CampaignSpec) -> dict:
    fns = dict(ALL_HEURISTICS)
    # bound the uncapped MULTIINST construction: beyond the limit the
    # strategy reports a structured infeasible instead of grinding on
    fns["MULTIINST"] = functools.partial(multi_inst, max_uncapped=spec.multiinst_limit)
    return fns


def run_campaign(
    spec: CampaignSpec,
    session: Session | None = None,
    *,
    strict: bool = False,
    progress=None,
    device=None,
) -> CampaignResult:
    """Run one campaign end to end; returns the classified result.

    ``session`` overrides the LP-side session (tests inject serial-backend
    sessions; by default one is built on ``spec.backend`` and ``device`` —
    None: the CUDA card, ``"cpu"``: the kernels' plain versions).  ``strict``
    raises :class:`CampaignAnomalyError` as soon as the run ends with any
    anomaly; ``progress`` is an optional ``str -> None`` callable for
    coarse stage updates.
    """
    reg = get_registry()
    say = progress if progress is not None else (lambda _msg: None)

    with span("eval.campaign", campaign=spec.name, n=spec.n_instances,
              backend=spec.backend):
        with span("eval.generate", n=spec.n_instances):
            triples = list(spec.instances())
        say(f"campaign {spec.name}: {len(triples)} instances "
            f"({len(spec.cells())} cells)")

        # -- LP side: one coalescing bulk submission ----------------------
        if session is None:
            session = Session(policy=Policy(backend=spec.backend), device=device)
        with span("eval.lp", n=len(triples), backend=spec.backend):
            tickets = [session.submit(inst) for _cell, _idx, inst in triples]
            artifacts = [t.result() for t in tickets]
        say(f"campaign {spec.name}: LP side solved")

        # -- heuristic side + matched-verification session ----------------
        fns = _strategy_fns(spec)
        with span("eval.heuristics", n=len(triples)):
            heuristic_runs = [
                [run_strategy(name, fn, inst) for name, fn in fns.items()]
                for _cell, _idx, inst in triples
            ]
        say(f"campaign {spec.name}: heuristics run")

        matched_session = Session(policy=Policy(backend=spec.matched_backend))
        matched_solve = matched_session.solve

        # -- verdicts ------------------------------------------------------
        classifications: list = []
        with span("eval.classify", n=len(triples)):
            for (cell, idx, inst), art, runs in zip(triples, artifacts,
                                                    heuristic_runs):
                c = classify_instance(
                    inst, art, runs,
                    rtol=spec.rtol,
                    matched_solve=matched_solve,
                    matched_t_cap=spec.matched_t_cap,
                    cell_id=CampaignSpec.cell_id(cell),
                    index=idx,
                )
                classifications.append(c)
                reg.inc("repro_campaign_instances_total", 1.0,
                        campaign=spec.name, label=c.label)
                if c.label == "anomaly":
                    reg.inc("repro_campaign_anomalies_total", 1.0,
                            campaign=spec.name,
                            kind=(c.anomaly or {}).get("kind", "?"))
                for sname, entry in c.strategies.items():
                    if entry["failure"] in ("infeasible", "error"):
                        reg.inc("repro_campaign_strategy_failures_total", 1.0,
                                campaign=spec.name, strategy=sname,
                                failure=entry["failure"])

    result = CampaignResult(spec=spec, classifications=classifications)
    say(f"campaign {spec.name}: {result.counts()} "
        f"domination_rate={result.domination_rate:.6f}")
    if strict:
        result.require_clean()
    return result
