"""Fleet health metrics: counters, gauges, histograms with labeled series.

:mod:`repro.obs.trace` answers "where did the time go" for one process run;
this module is the *fleet health* substrate — per-fabric time series of the
quantities Gemini's monitoring-driven control loop (§4) actually steers by:
realized MLU / loss / stretch distributions, reconfiguration decisions
applied / skipped / vetoed (with veto reasons), predictor coverage, solver
fallbacks.  The same contract as tracing applies:

* **Disabled (the default) it is free**: every recording call is one flag
  check, no allocation — safe to leave on hot host-side paths.
* **Enabled it is invisible**: nothing here touches jitted computation or any
  numeric code path; enabling metrics leaves every controller result
  bit-identical (test-enforced, like tracing).

Three instrument kinds, each carried as labeled series (a ``(name, labels)``
pair is one series — e.g. ``interval.mlu{fabric="F3"}``):

* :func:`inc` — monotonic counters (decision counts, fallback counts);
* :func:`set_gauge` — last-value gauges (worst-contingency MLU of the most
  recent evaluation);
* :func:`observe` / :func:`observe_many` — histograms over **fixed
  exponential buckets** (:data:`DEFAULT_EDGES`: 12 buckets per decade from
  1e-6 to 1e3, plus underflow-at-the-first-bucket and overflow).  Fixed
  buckets make snapshots mergeable across processes and fabrics — the fleet
  health report (:mod:`repro.obs.health`) sums counts arrays, never raw
  samples — at the cost of quantile estimates being bucket-resolution
  approximations (≤ ~10% relative error at 12 buckets/decade).

Snapshots export as JSON (:func:`snapshot` / :func:`export_json`, the
``repro.obs.health`` input, stamped into bench artifacts) and as Prometheus
text exposition (:func:`prometheus_text`) for scrape-based setups.
"""

from __future__ import annotations

import json
import math
import threading

import numpy as np

__all__ = [
    "enable", "disable", "enabled", "clear", "inc", "set_gauge", "observe",
    "observe_many", "snapshot", "export_json", "read_json",
    "merge_snapshots", "prometheus_text", "histogram_quantile",
    "histogram_frac_above", "DEFAULT_EDGES",
]


def _exponential_edges(lo: float = 1e-6, hi: float = 1e3,
                       per_decade: int = 12) -> tuple:
    """Fixed exponential bucket upper bounds (``le`` edges)."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


DEFAULT_EDGES = _exponential_edges()
_EDGES_ARR = np.asarray(DEFAULT_EDGES)

_enabled = False
_lock = threading.Lock()
_counters: dict = {}  # (name, labels) -> float
_gauges: dict = {}  # (name, labels) -> float
_hists: dict = {}  # (name, labels) -> _Hist


class _Hist:
    """One histogram series: counts over the fixed edges (+ overflow)."""

    __slots__ = ("counts", "sum", "count", "vmin", "vmax")

    def __init__(self):
        self.counts = np.zeros(len(DEFAULT_EDGES) + 1, np.int64)
        self.sum = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe_array(self, values: np.ndarray) -> None:
        v = np.asarray(values, np.float64).ravel()
        v = v[np.isfinite(v)]
        if not v.size:
            return
        # bucket i holds values <= EDGES[i]; the last slot is overflow
        idx = np.searchsorted(_EDGES_ARR, v, side="left")
        np.add.at(self.counts, idx, 1)
        self.sum += float(v.sum())
        self.count += int(v.size)
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()


def _key(name: str, labels: dict) -> tuple:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def inc(name: str, value: float = 1.0, **labels) -> None:
    """Add to a labeled monotonic counter.  No-op when disabled."""
    if not _enabled:
        return
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + float(value)


def set_gauge(name: str, value: float, **labels) -> None:
    """Set a labeled last-value gauge.  No-op when disabled."""
    if not _enabled:
        return
    with _lock:
        _gauges[_key(name, labels)] = float(value)


def observe(name: str, value: float, **labels) -> None:
    """Record one sample into a labeled histogram.  No-op when disabled."""
    if not _enabled:
        return
    _observe(name, np.asarray([value]), labels)


def observe_many(name: str, values, **labels) -> None:
    """Record an array of samples into a labeled histogram in one vectorized
    pass (one ``searchsorted`` — this is how per-interval MLU/loss series are
    folded in, whole sweeps at a time).  No-op when disabled."""
    if not _enabled:
        return
    _observe(name, values, labels)


def _observe(name: str, values, labels: dict) -> None:
    k = _key(name, labels)
    with _lock:
        h = _hists.get(k)
        if h is None:
            h = _hists[k] = _Hist()
        h.observe_array(values)


# ---- snapshots ---------------------------------------------------------------

def snapshot() -> dict:
    """JSON-able snapshot of every live series (the health-report input)."""
    with _lock:
        counters = [{"name": n, "labels": dict(ls), "value": v}
                    for (n, ls), v in sorted(_counters.items())]
        gauges = [{"name": n, "labels": dict(ls), "value": v}
                  for (n, ls), v in sorted(_gauges.items())]
        hists = []
        for (n, ls), h in sorted(_hists.items()):
            hists.append({
                "name": n, "labels": dict(ls),
                "edges": list(DEFAULT_EDGES),
                "counts": [int(c) for c in h.counts],
                "count": int(h.count), "sum": float(h.sum),
                "min": None if h.count == 0 else float(h.vmin),
                "max": None if h.count == 0 else float(h.vmax),
            })
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def export_json(path, snap: dict | None = None) -> dict:
    snap = snapshot() if snap is None else snap
    with open(path, "w") as fh:
        json.dump(snap, fh)
    return snap


def read_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def merge_snapshots(snaps: list) -> dict:
    """Merge snapshots from many processes / fabrics / runs.

    Counters and histogram counts sum; gauges are last-writer-wins (snapshot
    list order); histograms must share their fixed edges — that is the point
    of fixed buckets.
    """
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    for snap in snaps:
        for c in snap.get("counters", []):
            k = _key(c["name"], c["labels"])
            counters[k] = counters.get(k, 0.0) + float(c["value"])
        for g in snap.get("gauges", []):
            gauges[_key(g["name"], g["labels"])] = float(g["value"])
        for h in snap.get("histograms", []):
            k = _key(h["name"], h["labels"])
            prev = hists.get(k)
            if prev is None:
                hists[k] = {**h, "labels": dict(h["labels"]),
                            "counts": list(h["counts"])}
                continue
            if list(prev["edges"]) != list(h["edges"]):
                raise ValueError(
                    f"cannot merge histogram {h['name']}: bucket edges differ")
            prev["counts"] = [a + b for a, b in zip(prev["counts"],
                                                    h["counts"])]
            prev["count"] += h["count"]
            prev["sum"] += h["sum"]
            for fn, key in ((min, "min"), (max, "max")):
                vals = [v for v in (prev[key], h[key]) if v is not None]
                prev[key] = fn(vals) if vals else None
    return {
        "counters": [{"name": n, "labels": dict(ls), "value": v}
                     for (n, ls), v in sorted(counters.items())],
        "gauges": [{"name": n, "labels": dict(ls), "value": v}
                   for (n, ls), v in sorted(gauges.items())],
        "histograms": [hists[k] for k in sorted(hists)],
    }


# ---- histogram readout -------------------------------------------------------

def histogram_quantile(hist: dict, q: float) -> float:
    """Approximate the q-quantile (q in [0, 1]) of a snapshot histogram.

    Linear interpolation inside the selected bucket, clamped to the recorded
    min/max — exact at the extremes, bucket-resolution-accurate in between.
    """
    counts = np.asarray(hist["counts"], np.float64)
    total = counts.sum()
    if total <= 0:
        return float("nan")
    edges = hist["edges"]
    target = q * total
    cum = np.cumsum(counts)
    i = int(np.searchsorted(cum, target, side="left"))
    lo = 0.0 if i == 0 else edges[i - 1]
    hi = edges[i] if i < len(edges) else hist["max"]
    prev_cum = 0.0 if i == 0 else cum[i - 1]
    in_bucket = counts[i]
    frac = (target - prev_cum) / in_bucket if in_bucket > 0 else 0.0
    val = lo + (hi - lo) * frac
    if hist.get("min") is not None:
        val = min(max(val, hist["min"]), hist["max"])
    return float(val)


def histogram_frac_above(hist: dict, threshold: float) -> float:
    """Fraction of recorded samples above ``threshold`` (SLO burn).

    Conservative at bucket resolution: a bucket straddling the threshold
    counts as fully above it, so burn is never under-reported.
    """
    counts = np.asarray(hist["counts"], np.float64)
    total = counts.sum()
    if total <= 0:
        return float("nan")
    # first bucket whose upper edge exceeds the threshold may straddle it
    # (side="right" so a threshold sitting exactly on an edge excludes the
    # bucket it bounds — those samples are <= threshold by construction)
    i = int(np.searchsorted(np.asarray(hist["edges"]), threshold,
                            side="right"))
    return float(counts[i:].sum() / total)


# ---- Prometheus text exposition ---------------------------------------------

def _prom_name(name: str) -> str:
    return "repro_" + "".join(c if c.isalnum() or c == "_" else "_"
                              for c in name)


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    items = {**labels, **(extra or {})}
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


def prometheus_text(snap: dict | None = None) -> str:
    """Render a snapshot in the Prometheus text exposition format."""
    snap = snapshot() if snap is None else snap
    lines = []
    for c in snap["counters"]:
        n = _prom_name(c["name"]) + "_total"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n}{_prom_labels(c['labels'])} {c['value']:g}")
    for g in snap["gauges"]:
        n = _prom_name(g["name"])
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n}{_prom_labels(g['labels'])} {g['value']:g}")
    for h in snap["histograms"]:
        n = _prom_name(h["name"])
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for edge, count in zip(h["edges"], h["counts"]):
            cum += count
            lines.append(f"{n}_bucket"
                         f"{_prom_labels(h['labels'], {'le': f'{edge:g}'})}"
                         f" {cum}")
        cum += h["counts"][-1]
        lines.append(f"{n}_bucket"
                     f"{_prom_labels(h['labels'], {'le': '+Inf'})} {cum}")
        lines.append(f"{n}_sum{_prom_labels(h['labels'])} {h['sum']:g}")
        lines.append(f"{n}_count{_prom_labels(h['labels'])} {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")
