"""Campaign aggregation: schema-versioned JSON document + markdown report.

The document is the campaign's durable artifact (``campaign.json``; the
reference package's full tier is committed as ``bench_out/campaign.json``):
it records the spec verbatim (seed included — the whole campaign re-derives
bit-identically from it), headline totals, per-grid-slice rates, strategy
failure tallies, the worst observed makespan ratios, a compact per-instance
row set, and the full evidence for every anomaly.  It deliberately contains
**no timestamps, durations, or environment fingerprints**: two runs of the
same spec must serialize to byte-identical JSON (that is a test).

Schema changes bump :data:`CAMPAIGN_SCHEMA_VERSION`;
:func:`validate_campaign` is the structural gate both the CI checker and
the tests share.
"""

from __future__ import annotations

import json
import os

from .classify import CLASSES
from .spec import AXES, CampaignSpec

__all__ = [
    "CAMPAIGN_SCHEMA_VERSION",
    "build_document",
    "render_markdown",
    "write_campaign",
    "load_campaign",
    "validate_campaign",
]

CAMPAIGN_SCHEMA_VERSION = 1

# how many worst-ratio rows the document keeps
WORST_N = 10


def _slice_stats(rows: list) -> dict:
    """Aggregate one group of per-instance rows into rates."""
    n = len(rows)
    counts = {label: 0 for label in CLASSES}
    worst = None
    for r in rows:
        counts[r["label"]] += 1
        if r["ratio"] is not None and (worst is None or r["ratio"] > worst):
            worst = r["ratio"]
    compared = n - counts["heuristic-infeasible"] - counts["anomaly"]
    return {
        "n": n,
        "counts": counts,
        "domination_rate": 1.0 - counts["anomaly"] / n if n else 1.0,
        "match_rate": counts["tie"] / compared if compared else None,
        "worst_ratio": worst,
    }


def build_document(result) -> dict:
    """Aggregate a :class:`repro_torch.eval.runner.CampaignResult` into the
    schema-versioned campaign document (JSON-safe, deterministic)."""
    spec: CampaignSpec = result.spec
    cells_by_id = {CampaignSpec.cell_id(c): c for c in spec.cells()}

    rows = []
    for c in result.classifications:
        rows.append({
            "cell_id": c.cell_id,
            "index": c.index,
            "content_key": c.content_key,
            "label": c.label,
            "ratio": None if c.ratio is None else float(c.ratio),
            "best_strategy": c.best_strategy,
        })

    # per-axis slices: for every axis value, the stats over its instances
    slices: dict = {}
    for axis in AXES:
        groups: dict = {}
        for r in rows:
            val = cells_by_id[r["cell_id"]][axis]
            groups.setdefault(str(val), []).append(r)
        slices[axis] = {val: _slice_stats(g) for val, g in sorted(groups.items())}

    # per-strategy tallies across the whole campaign
    strategies: dict = {}
    for c in result.classifications:
        for name, entry in c.strategies.items():
            s = strategies.setdefault(name, {
                "feasible": 0, "infeasible": 0, "error": 0, "unsupported": 0,
                "best": 0,
            })
            f = entry["failure"]
            if f == "":
                s["feasible"] += 1
            else:
                s[f] += 1
            if c.best_strategy == name:
                s["best"] += 1
    for name, s in strategies.items():
        applicable = s["feasible"] + s["infeasible"] + s["error"]
        s["failure_rate"] = (
            (s["infeasible"] + s["error"]) / applicable if applicable else None
        )

    ranked = sorted(
        (r for r in rows if r["ratio"] is not None),
        key=lambda r: (-r["ratio"], r["cell_id"], r["index"]),
    )
    worst = ranked[:WORST_N]

    anomalies = [
        c.to_dict() for c in result.classifications if c.label == "anomaly"
    ]

    return {
        "schema_version": CAMPAIGN_SCHEMA_VERSION,
        "spec": spec.to_dict(),
        "totals": _slice_stats(rows),
        "slices": slices,
        "strategies": {k: strategies[k] for k in sorted(strategies)},
        "worst_ratios": worst,
        "instances": rows,
        "anomalies": anomalies,
    }


def to_canonical_json(doc: dict) -> str:
    """Canonical serialization: sorted keys, fixed separators, trailing
    newline — byte-identical for equal documents."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"),
                      allow_nan=False) + "\n"


def write_campaign(doc: dict, json_path: str, md_path: str | None = None) -> None:
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    with open(json_path, "w") as f:
        f.write(to_canonical_json(doc))
    if md_path is not None:
        with open(md_path, "w") as f:
            f.write(render_markdown(doc))


def load_campaign(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    errs = validate_campaign(doc)
    if errs:
        raise ValueError(f"invalid campaign document {path}: " + "; ".join(errs))
    return doc


def validate_campaign(doc: dict) -> list:
    """Structural checks shared by the tests and the campaign gate;
    returns violation strings (empty == valid)."""
    errs = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("schema_version") != CAMPAIGN_SCHEMA_VERSION:
        errs.append(
            f"schema_version {doc.get('schema_version')!r} != "
            f"{CAMPAIGN_SCHEMA_VERSION}"
        )
    for key in ("spec", "totals", "slices", "strategies", "worst_ratios",
                "instances", "anomalies"):
        if key not in doc:
            errs.append(f"missing key {key!r}")
    if errs:
        return errs
    try:
        CampaignSpec.from_dict(doc["spec"])
    except Exception as e:  # noqa: BLE001 - report, don't crash the gate
        errs.append(f"spec does not round-trip: {e}")
    totals = doc["totals"]
    rows = doc["instances"]
    if totals.get("n") != len(rows):
        errs.append(f"totals.n {totals.get('n')} != len(instances) {len(rows)}")
    counts = totals.get("counts", {})
    if sorted(counts) != sorted(CLASSES):
        errs.append(f"totals.counts keys {sorted(counts)} != {sorted(CLASSES)}")
    elif sum(counts.values()) != len(rows):
        errs.append("totals.counts do not sum to len(instances)")
    bad = [r["label"] for r in rows if r.get("label") not in CLASSES]
    if bad:
        errs.append(f"unknown labels in instances: {sorted(set(bad))}")
    n_anom = counts.get("anomaly", 0)
    if n_anom != len(doc["anomalies"]):
        errs.append(
            f"counts.anomaly {n_anom} != len(anomalies) {len(doc['anomalies'])}"
        )
    if len(rows):
        want = 1.0 - n_anom / len(rows)
        got = totals.get("domination_rate")
        if not isinstance(got, (int, float)) or abs(got - want) > 1e-12:
            errs.append(f"domination_rate {got} inconsistent (want {want})")
    return errs


def _pct(x) -> str:
    return "n/a" if x is None else f"{100.0 * x:.2f}%"


def _num(x) -> str:
    return "n/a" if x is None else f"{x:.4f}"


def render_markdown(doc: dict) -> str:
    """Human-readable report of one campaign document."""
    spec = doc["spec"]
    totals = doc["totals"]
    counts = totals["counts"]
    out = []
    out.append(f"# Campaign report: {spec['name']}")
    out.append("")
    out.append(
        f"{totals['n']} instances, seed {spec['seed']}, backend "
        f"`{spec['backend']}` (matched re-solves on `{spec['matched_backend']}`)."
    )
    out.append("")
    out.append("## Totals")
    out.append("")
    out.append("| class | count | share |")
    out.append("|---|---:|---:|")
    for label in CLASSES:
        share = counts[label] / totals["n"] if totals["n"] else 0.0
        out.append(f"| {label} | {counts[label]} | {_pct(share)} |")
    out.append("")
    out.append(
        f"**Domination rate: {_pct(totals['domination_rate'])}** "
        f"(anomalies: {counts['anomaly']}) · "
        f"match rate {_pct(totals['match_rate'])} · "
        f"worst makespan ratio {_num(totals['worst_ratio'])}"
    )
    out.append("")
    out.append("## Grid slices")
    for axis in AXES:
        out.append("")
        out.append(f"### {axis}")
        out.append("")
        out.append("| value | n | domination | match | worst ratio | anomalies |")
        out.append("|---|---:|---:|---:|---:|---:|")
        for val, s in doc["slices"][axis].items():
            out.append(
                f"| {val} | {s['n']} | {_pct(s['domination_rate'])} | "
                f"{_pct(s['match_rate'])} | {_num(s['worst_ratio'])} | "
                f"{s['counts']['anomaly']} |"
            )
    out.append("")
    out.append("## Strategies")
    out.append("")
    out.append("| strategy | feasible | infeasible | error | unsupported | "
               "best | failure rate |")
    out.append("|---|---:|---:|---:|---:|---:|---:|")
    for name, s in doc["strategies"].items():
        out.append(
            f"| {name} | {s['feasible']} | {s['infeasible']} | {s['error']} | "
            f"{s['unsupported']} | {s['best']} | {_pct(s['failure_rate'])} |"
        )
    out.append("")
    out.append("## Worst makespan ratios")
    out.append("")
    out.append("| ratio | strategy | cell | index | content key |")
    out.append("|---:|---|---|---:|---|")
    for r in doc["worst_ratios"]:
        out.append(
            f"| {_num(r['ratio'])} | {r['best_strategy']} | `{r['cell_id']}` | "
            f"{r['index']} | `{r['content_key']}` |"
        )
    out.append("")
    if doc["anomalies"]:
        out.append("## Anomalies")
        out.append("")
        for a in doc["anomalies"]:
            out.append(
                f"- **{(a.get('anomaly') or {}).get('kind', '?')}** at "
                f"`{a['cell_id']}` index {a['index']} "
                f"(content key `{a['content_key']}`): "
                f"lp={a['lp_makespan']} best={a['best_makespan']} "
                f"({a['best_strategy']})"
            )
    else:
        out.append("## Anomalies")
        out.append("")
        out.append("None. The LP dominated every feasible heuristic schedule.")
    out.append("")
    return "\n".join(out)
