"""Fleet health report CLI: ``python -m repro_torch.obs.health`` — a copy of
``repro/obs/health.py`` with its imports rewritten.

Consumes metric snapshots and decision-audit logs from one or many fabrics
(one process or many) and emits the per-fabric / fleet table the ROADMAP's
streaming-controller SLO story needs as its substrate:

* realized **MLU / loss / stretch** distributions (p50 / p99 / p99.9 from the
  fixed-bucket histograms — mergeable across processes, quantiles are
  bucket-resolution approximations);
* **decisions**: topology updates applied / skipped, §4.6 gate evaluations
  vetoed, with the top veto reason (from decision counters, enriched by an
  audit log when given);
* **predictor quality**: realized-vs-predicted coverage ratio and critical-TM
  hit rate (:mod:`repro_torch.obs.quality`);
* **SLO burn** against configurable targets (``--slo mlu=1.0``): the
  fraction of scored intervals whose metric exceeded the target.

Inputs are flexible: plain metrics-snapshot JSONs
(:func:`repro_torch.obs.metrics.export_json`), bench artifacts that stamp a
snapshot under ``"_metrics"`` (and optionally an audit log under
``"_audit"``) — e.g. ``BENCH_fleet.json`` — and audit JSONLs via
``--audit``.  Everything merges: counters and histogram buckets sum across
files (fixed buckets exist precisely so this is sound).

    python -m repro_torch.obs.health BENCH_fleet.json
    python -m repro_torch.obs.health snap_*.json --audit audit.jsonl \
        --slo mlu=1.0 --slo loss=0.01 --json
"""

from __future__ import annotations

import argparse
import json
import math

from repro_torch.obs import audit as audit_mod
from repro_torch.obs import metrics
from repro_torch.obs.quality import snapshot_quality

__all__ = ["load_inputs", "health_report", "format_report", "main"]

FLEET = "FLEET"
DEFAULT_SLOS = (("mlu", 1.0),)


def load_inputs(paths: list, audit_paths: list | None = None) -> tuple:
    """Load and merge snapshots + audit records from the given files.

    Each positional path may be a metrics snapshot or a bench artifact
    carrying ``"_metrics"`` / ``"_audit"``.  Returns
    ``(merged_snapshot, audit_records)``.
    """
    snaps, audits = [], []
    for path in paths:
        with open(path) as fh:
            doc = json.load(fh)
        if "_metrics" in doc:
            snaps.append(doc["_metrics"])
            audits.extend(doc.get("_audit") or [])
        elif any(k in doc for k in ("counters", "gauges", "histograms")):
            snaps.append(doc)
        else:
            raise ValueError(
                f"{path}: neither a metrics snapshot nor a bench artifact "
                "with a '_metrics' stamp")
    for path in audit_paths or []:
        audits.extend(audit_mod.read_jsonl(path))
    snap = metrics.merge_snapshots(snaps) if snaps else {
        "counters": [], "gauges": [], "histograms": []}
    return snap, audits


def _hists_by_fabric(snap: dict, name: str) -> dict:
    out: dict = {}
    for h in snap.get("histograms", []):
        if h["name"] == name:
            out[h["labels"].get("fabric", "")] = h
    return out


def _counter_series(snap: dict, name: str) -> list:
    return [c for c in snap.get("counters", []) if c["name"] == name]


def _fabrics(snap: dict, audits: list) -> list:
    fabs = set()
    for h in snap.get("histograms", []):
        if h["labels"].get("fabric"):
            fabs.add(h["labels"]["fabric"])
    for c in snap.get("counters", []):
        if c["labels"].get("fabric"):
            fabs.add(c["labels"]["fabric"])
    for rec in audits:
        if rec.get("fabric"):
            fabs.add(rec["fabric"])
    return sorted(fabs)


def _merge_unlabeled(hists: dict) -> dict | None:
    """Sum one metric's per-fabric histograms into a fleet histogram."""
    entries = [dict(h, labels={}) for h in hists.values()]
    if not entries:
        return None
    merged = metrics.merge_snapshots(
        [{"histograms": [e]} for e in entries])
    return merged["histograms"][0]


def _decisions(snap: dict, audits: list, fabric: str | None) -> dict:
    """Applied/skipped/vetoed counts + top veto reason for one fabric (or
    fleet-wide with ``fabric=None``), merging counters with audit records."""
    applied = skipped = 0.0
    for c in _counter_series(snap, "controller.topology_updates"):
        if fabric is not None and c["labels"].get("fabric") != fabric:
            continue
        if c["labels"].get("outcome") == "applied":
            applied += c["value"]
        elif c["labels"].get("outcome") == "skipped":
            skipped += c["value"]
    vetoes: dict = {}
    n_gate = 0.0
    for c in _counter_series(snap, "reconfigure.decisions"):
        if fabric is not None and c["labels"].get("fabric") != fabric:
            continue
        n_gate += c["value"]
        if c["labels"].get("outcome") == "vetoed":
            reason = c["labels"].get("reason", "unknown")
            vetoes[reason] = vetoes.get(reason, 0.0) + c["value"]
    if not n_gate:  # no counters — fall back to the audit log
        for rec in audits:
            if rec.get("kind") != "should_reconfigure":
                continue
            if fabric is not None and rec.get("fabric") != fabric:
                continue
            n_gate += 1
            if not rec.get("decision"):
                reason = rec.get("reason", "unknown")
                vetoes[reason] = vetoes.get(reason, 0.0) + 1
    n_vetoed = sum(vetoes.values())
    top = max(vetoes.items(), key=lambda kv: kv[1])[0] if vetoes else ""
    return {"applied": int(applied), "skipped": int(skipped),
            "vetoed": int(n_vetoed), "gate_evaluations": int(n_gate),
            "top_veto_reason": top}


def _parse_slos(specs: list) -> list:
    slos = []
    for spec in specs:
        if "=" not in spec:
            raise ValueError(f"--slo expects metric=target, got {spec!r}")
        name, _, val = spec.partition("=")
        slos.append((name.strip(), float(val)))
    return slos


def health_report(snap: dict, audits: list, slos: list | None = None) -> dict:
    """Build the structured per-fabric + fleet health report."""
    slos = list(DEFAULT_SLOS) if slos is None else slos
    by_metric = {m: _hists_by_fabric(snap, f"interval.{m}")
                 for m in ("mlu", "loss", "stretch")}
    rows = []
    for fab in _fabrics(snap, audits) + [None]:
        name = FLEET if fab is None else fab
        row: dict = {"fabric": name}
        for m, hists in by_metric.items():
            h = _merge_unlabeled(hists) if fab is None else hists.get(fab)
            if h is None or not h["count"]:
                row[m] = None
                continue
            row[m] = {"n": int(h["count"]),
                      "p50": metrics.histogram_quantile(h, 0.50),
                      "p99": metrics.histogram_quantile(h, 0.99),
                      "p999": metrics.histogram_quantile(h, 0.999)}
        row["n_intervals"] = row["mlu"]["n"] if row.get("mlu") else 0
        row["decisions"] = _decisions(snap, audits, fab)
        row["predictor"] = snapshot_quality(snap, fab)
        row["slo_burn"] = {}
        for m, target in slos:
            hists = by_metric.get(m) or _hists_by_fabric(snap,
                                                         f"interval.{m}")
            h = _merge_unlabeled(hists) if fab is None else hists.get(fab)
            row["slo_burn"][f"{m}>{target:g}"] = (
                metrics.histogram_frac_above(h, target)
                if h and h["count"] else None)
        rows.append(row)
    return {"fabrics": rows[:-1], "fleet": rows[-1],
            "slos": [f"{m}={t:g}" for m, t in slos],
            "n_audit_records": len(audits)}


def _fmt(v, spec: str = ".3f", width: int = 7) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return f"{'-':>{width}}"
    return f"{v:>{width}{spec}}"


def format_report(report: dict) -> str:
    """Render the report as the fleet health table."""
    burns = sorted({k for row in report["fabrics"] + [report["fleet"]]
                    for k in row["slo_burn"]})
    head = (f"{'fabric':<10}{'n':>7}"
            f"{'mlu_p50':>9}{'mlu_p99':>9}{'mlu_p999':>10}"
            f"{'loss_p999':>11}{'stretch_p999':>13}"
            f"{'appl':>6}{'skip':>6}{'veto':>6}"
            f"{'coverage':>10}{'hit':>7}")
    for b in burns:
        head += f"{'burn(' + b + ')':>16}"
    head += "  top_veto_reason"
    lines = [head, "-" * len(head)]
    for row in report["fabrics"] + [report["fleet"]]:
        d, pred = row["decisions"], row["predictor"]
        mlu, loss, stretch = row["mlu"], row["loss"], row["stretch"]
        parts = [f"{row['fabric'][:9]:<10}", f"{row['n_intervals']:>7d}",
                 _fmt(mlu and mlu["p50"], ".3f", 9),
                 _fmt(mlu and mlu["p99"], ".3f", 9),
                 _fmt(mlu and mlu["p999"], ".3f", 10),
                 _fmt(loss and loss["p999"], ".5f", 11),
                 _fmt(stretch and stretch["p999"], ".3f", 13),
                 f"{d['applied']:>6d}", f"{d['skipped']:>6d}",
                 f"{d['vetoed']:>6d}",
                 _fmt(pred["coverage_ratio"], ".3f", 10),
                 _fmt(pred["hit_rate"], ".3f", 7)]
        for b in burns:
            parts.append(_fmt(row["slo_burn"].get(b), ".4f", 16))
        parts.append(f"  {d['top_veto_reason']}")
        lines.append("".join(parts))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.health",
        description="Fleet health report from metric snapshots and decision "
                    "audit logs (per-fabric MLU/loss/stretch percentiles, "
                    "decisions, predictor coverage, SLO burn).")
    ap.add_argument("inputs", nargs="+",
                    help="metrics snapshot JSONs and/or bench artifacts "
                         "with a '_metrics' stamp (e.g. BENCH_fleet.json)")
    ap.add_argument("--audit", action="append", default=[],
                    metavar="AUDIT.jsonl",
                    help="decision-audit JSONL (repeatable)")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="METRIC=TARGET",
                    help="SLO target, e.g. mlu=1.0 or loss=0.01 "
                         "(repeatable; default mlu=1.0)")
    ap.add_argument("--json", action="store_true",
                    help="emit the structured report as JSON")
    ap.add_argument("--verify-audit", action="store_true",
                    help="replay every audit decision and fail on mismatch")
    args = ap.parse_args(argv)

    snap, audits = load_inputs(args.inputs, args.audit)
    slos = _parse_slos(args.slo) if args.slo else None
    report = health_report(snap, audits, slos)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(format_report(report))
        print(f"\n{len(report['fabrics'])} fabrics, "
              f"{report['fleet']['n_intervals']} scored intervals, "
              f"{report['n_audit_records']} audit records")
    if args.verify_audit and audits:
        problems = audit_mod.verify(audits)
        for p in problems:
            print(f"AUDIT MISMATCH: {p}")
        if problems:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
