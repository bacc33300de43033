"""Golden-eval campaigns: sweep instance grids, classify LP vs heuristics.

The paper's central empirical claim — the LP always produces the best
schedule while the §3 strategies (SIMPLE, SINGLELOAD [18], SINGLEINST /
MULTIINST [19], HEURISTIC B) can fail outright or land far from optimal —
lives here as an always-on, machine-checked evaluation:

* :class:`CampaignSpec` (``spec.py``) — a seeded deterministic grid over
  topology x return_ratio x release x m x n_loads x q x heterogeneity x
  comm_to_comp; every instance re-derives bit-identically from the seed;
* :func:`run_campaign` (``runner.py``) — bulk-solves the LP side through
  one coalescing :class:`repro_torch.api.Session` and runs every strategy
  through the structured-failure contract;
* :func:`classify_instance` (``classify.py``) — buckets each case into
  lp-wins / tie / heuristic-infeasible / lp-fallback / anomaly, with lazy
  matched-structure verification before anything is called an anomaly;
* :func:`build_document` (``report.py``) — the schema-versioned
  ``campaign.json`` + markdown report.

Copies of the reference package's ``repro.eval``, run through the port's
:class:`repro_torch.api.Session`; the presets default to the ``"cuda"``
backend.  The documents are the reference's, so the port's full tier is held
against the committed ``bench_out/campaign.json`` (a record of the
reference, which the port never writes).

Quickstart::

    from repro_torch.eval import smoke_spec, run_campaign, build_document, write_campaign
    result = run_campaign(smoke_spec(), strict=True)   # on the card; raises on any anomaly
    write_campaign(build_document(result), "build/campaign_torch/campaign.json",
                   "build/campaign_torch/campaign.md")

or from the shell: ``python -m repro_torch.eval --smoke``.
"""

from .classify import CLASSES, Classification, classify_instance
from .report import (
    CAMPAIGN_SCHEMA_VERSION,
    build_document,
    load_campaign,
    render_markdown,
    validate_campaign,
    write_campaign,
)
from .runner import CampaignAnomalyError, CampaignResult, run_campaign
from .spec import CampaignSpec, full_spec, smoke_spec

__all__ = [
    "CLASSES",
    "CAMPAIGN_SCHEMA_VERSION",
    "CampaignSpec",
    "CampaignResult",
    "CampaignAnomalyError",
    "Classification",
    "classify_instance",
    "run_campaign",
    "build_document",
    "render_markdown",
    "write_campaign",
    "load_campaign",
    "validate_campaign",
    "smoke_spec",
    "full_spec",
]
