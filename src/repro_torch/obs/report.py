"""Trace report CLI: ``python -m repro_torch.obs.report <trace.jsonl>`` — a
copy of ``repro/obs/report.py``.

Reads a JSONL trace exported by :func:`repro_torch.obs.export_jsonl` and prints a
per-span-name table of call count, cumulative wall time, *self* time
(cumulative minus time spent in child spans), and latency percentiles
(p50/p95/p99 over individual span durations).  ``--chrome OUT.json``
additionally converts the trace to Chrome ``trace_event`` JSON for
``chrome://tracing`` / Perfetto.

Self time is computed per thread with a containment stack: events are sorted
by start timestamp and a span is a child of the deepest still-open span on
the same ``tid`` whose ``[ts, ts+dur]`` interval contains it (the recorded
``depth`` field breaks exact-timestamp ties).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from .trace import export_chrome_trace, read_jsonl

__all__ = ["summarize", "format_table", "main"]


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (q in [0, 100])."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def summarize(records: list) -> list:
    """Aggregate "X" span records into per-name rows.

    Returns rows sorted by self time (descending):
    ``{"name", "count", "total_ms", "self_ms", "p50_ms", "p95_ms", "p99_ms"}``.
    """
    spans = [r for r in records if r.get("ph") == "X"]
    by_tid: dict = defaultdict(list)
    for r in spans:
        by_tid[r.get("tid", 0)].append(r)

    durs: dict = defaultdict(list)  # name -> [dur_us, ...]
    self_us: dict = defaultdict(float)  # name -> self time (µs)
    for recs in by_tid.values():
        recs.sort(key=lambda r: (r["ts_us"], r.get("depth", 0)))
        stack = []  # (end_us, record, child_us_accumulator)
        for r in recs:
            ts, dur = r["ts_us"], r.get("dur_us", 0.0)
            while stack and ts >= stack[-1][0] - 1e-9:
                end, parent, child_us = stack.pop()
                self_us[parent["name"]] += parent.get("dur_us", 0.0) - child_us
                if stack:
                    stack[-1][2] += parent.get("dur_us", 0.0)
            stack.append([ts + dur, r, 0.0])
            durs[r["name"]].append(dur)
        while stack:
            end, parent, child_us = stack.pop()
            self_us[parent["name"]] += parent.get("dur_us", 0.0) - child_us
            if stack:
                stack[-1][2] += parent.get("dur_us", 0.0)

    rows = []
    for name, ds in durs.items():
        ds.sort()
        rows.append({
            "name": name,
            "count": len(ds),
            "total_ms": sum(ds) / 1000.0,
            "self_ms": self_us[name] / 1000.0,
            "p50_ms": _percentile(ds, 50) / 1000.0,
            "p95_ms": _percentile(ds, 95) / 1000.0,
            "p99_ms": _percentile(ds, 99) / 1000.0,
        })
    rows.sort(key=lambda r: r["self_ms"], reverse=True)
    return rows


def format_table(rows: list) -> str:
    cols = [("name", 28), ("count", 7), ("total_ms", 12), ("self_ms", 12),
            ("p50_ms", 10), ("p95_ms", 10), ("p99_ms", 10)]
    head = "".join(f"{c:>{w}}" if c != "name" else f"{c:<{w}}"
                   for c, w in cols)
    lines = [head, "-" * len(head)]
    for r in rows:
        parts = [f"{r['name'][:27]:<28}", f"{r['count']:>7d}"]
        for c in ("total_ms", "self_ms", "p50_ms", "p95_ms", "p99_ms"):
            w = dict(cols)[c]
            parts.append(f"{r[c]:>{w}.3f}")
        lines.append("".join(parts))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch.obs JSONL trace "
                    "(self/cumulative time per span, latency percentiles).")
    ap.add_argument("trace", help="path to a trace .jsonl file")
    ap.add_argument("--chrome", metavar="OUT.json", default=None,
                    help="also write a Chrome trace_event JSON "
                         "(chrome://tracing / Perfetto)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary rows as JSON instead of a table")
    args = ap.parse_args(argv)

    records = read_jsonl(args.trace)
    rows = summarize(records)
    n_inst = sum(1 for r in records if r.get("ph") == "i")
    n_dropped = sum(int(r.get("args", {}).get("count", 0)) for r in records
                    if r.get("ph") == "M" and r.get("name") == "trace.dropped")
    if args.json:
        print(json.dumps({"rows": rows, "n_events": len(records),
                          "n_instants": n_inst, "n_dropped": n_dropped},
                         indent=2))
    else:
        print(format_table(rows))
        print(f"\n{len(records)} events "
              f"({sum(r['count'] for r in rows)} spans, {n_inst} instants)")
    if n_dropped:
        print(f"WARNING: {n_dropped} events were dropped before export "
              "(ring buffer overflow) — this trace is missing its oldest "
              "events; raise obs.enable(capacity=...) or export more often.",
              file=sys.stderr)
    if args.chrome:
        export_chrome_trace(args.chrome, records)
        print(f"chrome trace written to {args.chrome}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
