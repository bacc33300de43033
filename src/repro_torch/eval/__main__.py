"""CLI for running evaluation campaigns.

Examples::

    python -m repro_torch.eval --smoke                                 # on the card
    python -m repro_torch.eval --full --strict                         # the full tier
    python -m repro_torch.eval --smoke --backend torch --device cpu    # plain versions
    python -m repro_torch.eval --smoke --backend auto                  # serial NumPy

The documents go to ``build/campaign_torch/`` unless ``--out`` says
otherwise; ``bench_out/`` holds the reference package's record.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from .report import build_document, write_campaign
from .runner import CampaignAnomalyError, run_campaign
from .spec import full_spec, smoke_spec

# the reference package's committed campaign record: never written here
REFERENCE_RECORD = Path(__file__).resolve().parents[3] / "bench_out"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.eval",
        description="Run an LP-vs-heuristics evaluation campaign.",
    )
    tier = p.add_mutually_exclusive_group(required=True)
    tier.add_argument("--smoke", action="store_true",
                      help="the ~256-instance CI tier")
    tier.add_argument("--full", action="store_true",
                      help="the >=1000-instance full tier")
    p.add_argument("--out", default=os.path.join("build", "campaign_torch"),
                   help="output directory for campaign.json / campaign.md")
    p.add_argument("--backend", default=None,
                   help="LP-side backend override (default: spec preset)")
    p.add_argument("--device", default=None,
                   help="the engine's device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    p.add_argument("--strict", action="store_true",
                   help="exit non-zero on any anomaly (after writing the report)")
    args = p.parse_args(argv)
    if Path(args.out).resolve() == REFERENCE_RECORD:
        p.error(f"--out {args.out}: bench_out/ holds the reference package's record")

    spec = smoke_spec() if args.smoke else full_spec()
    if args.backend:
        import dataclasses
        spec = dataclasses.replace(spec, backend=args.backend)

    result = run_campaign(spec, progress=lambda m: print(m, flush=True),
                          device=args.device)
    doc = build_document(result)
    json_path = os.path.join(args.out, "campaign.json")
    md_path = os.path.join(args.out, "campaign.md")
    write_campaign(doc, json_path, md_path)
    print(f"wrote {json_path} and {md_path}")

    if args.strict:
        try:
            result.require_clean()
        except CampaignAnomalyError as e:
            print(f"CAMPAIGN FAILED:\n{e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
