"""Prediction-quality monitoring: did the robust multi-TM prediction cover
realized demand?

Gemini's §4 prediction pipeline abstracts a sliding window of recent traffic
matrices into ``k`` *critical TMs* and optimizes routing/topology to be
simultaneously feasible for all of them.  The operational question the paper
leaves to monitoring is whether that robust set actually covered what the
next interval delivered — the signal that says whether the aggregation
window, ``k``, and the hedging margin are doing their job per fabric.  Three
measurements per scored interval ``d_t`` against its epoch's critical TMs
``{tm_1..tm_m}``:

* **coverage** — is ``d_t`` elementwise inside the *envelope*
  ``max_m tm_m``?  The envelope is what multi-TM robustness guarantees
  feasibility for; an uncovered interval carried some commodity beyond
  everything the optimizer prepared for.  ``coverage_excess`` is the worst
  per-commodity ratio ``d_t / envelope`` (1.0 = exactly at the boundary).
* **overprovisioning factor** — envelope volume over realized volume
  (``Σ envelope / Σ d_t``): how much slack the robust set paid for.  High
  coverage at enormous overprovisioning means the predictor is padding, not
  predicting.
* **critical-TM hit rate** — was some *single* critical TM an elementwise
  upper bound for ``d_t``?  Stricter than coverage (the envelope mixes
  maxima across TMs); a high coverage / low hit-rate gap means realized
  demand lives between the critical TMs, which is exactly the regime the
  multi-TM formulation exists for.

:func:`record_epoch_quality` folds one epoch's measurements into the
:mod:`repro.obs.metrics` registry (counters for coverage/hit, a histogram
for overprovisioning) — a no-op when metrics are disabled, so the engines
call it unconditionally.  The fleet health report reads the ratios back out
of snapshots via :func:`snapshot_quality`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs import metrics

__all__ = ["epoch_quality", "record_epoch_quality", "record_interval_metrics",
           "snapshot_quality"]

_TINY = 1e-12
_EPS = 1e-9  # boundary tolerance: d == envelope counts as covered


def epoch_quality(tms, block) -> dict:
    """Per-interval prediction-quality measurements for one routing epoch.

    Args:
      tms: ``(m, C)`` critical TMs the epoch was optimized for (zero-padded
        rows are harmless — an all-zero TM never becomes any commodity's
        envelope unless every TM is zero there).
      block: ``(T, C)`` realized demand of the epoch's scored intervals.

    Returns arrays over the ``T`` intervals: ``coverage_excess`` (worst
    per-commodity realized/envelope ratio), ``covered`` (bool),
    ``hit`` (bool — some single TM dominates the interval), and
    ``overprovision`` (envelope volume / realized volume).
    """
    tms = np.asarray(tms, np.float64)
    d = np.asarray(block, np.float64)
    env = tms.max(axis=0) if tms.size else np.zeros(d.shape[1])
    # a zero-envelope commodity with positive realized demand is uncovered
    # (the optimizer prepared zero capacity share for it): ratio -> inf
    ratio = np.where(d > _TINY, d / np.maximum(env, _TINY), 0.0)
    excess = ratio.max(axis=1) if d.size else np.zeros(d.shape[0])
    covered = excess <= 1.0 + _EPS
    if tms.size and d.size:
        # (T, m): worst commodity ratio of each interval against each TM
        per_tm = np.where(d[:, None, :] > _TINY,
                          d[:, None, :] / np.maximum(tms[None], _TINY),
                          0.0).max(axis=2)
        hit = per_tm.min(axis=1) <= 1.0 + _EPS
    else:
        hit = covered.copy()
    overprov = float(env.sum()) / np.maximum(d.sum(axis=1), _TINY)
    return {"coverage_excess": excess, "covered": covered, "hit": hit,
            "overprovision": overprov}


def record_epoch_quality(fabric: str, tms, block) -> None:
    """Fold one epoch's prediction-quality stats into the metrics registry.

    No-op (one flag check) when metrics are disabled; never touches any
    numeric result either way.
    """
    if not metrics.enabled():
        return
    block = np.asarray(block)
    if block.size == 0:
        return
    q = epoch_quality(tms, block)
    metrics.inc("predictor.intervals_total", float(block.shape[0]),
                fabric=fabric)
    metrics.inc("predictor.intervals_covered", float(q["covered"].sum()),
                fabric=fabric)
    metrics.inc("predictor.intervals_hit", float(q["hit"].sum()),
                fabric=fabric)
    metrics.observe_many("predictor.overprovision", q["overprovision"],
                         fabric=fabric)
    metrics.observe_many("predictor.coverage_excess", q["coverage_excess"],
                         fabric=fabric)


def record_interval_metrics(fabric: str, m) -> None:
    """Fold a sweep's realized per-interval metrics into the fleet histograms.

    ``m`` is duck-typed :class:`repro.core.simulator.IntervalMetrics` (kept an
    untyped parameter so :mod:`repro.obs` never imports the scoring stack).
    One vectorized ``observe_many`` per series — ``interval.mlu`` /
    ``interval.alu`` / ``interval.olr`` / ``interval.stretch`` and, when loss
    tracking was on, ``interval.loss`` — labeled by fabric, which is what the
    fleet health report reads back as p50/p99/p99.9 and SLO burn.  No-op when
    metrics are disabled.
    """
    if not metrics.enabled():
        return
    for name in ("mlu", "alu", "olr", "stretch", "loss"):
        vals = getattr(m, name, None)
        if vals is not None and np.asarray(vals).size:
            metrics.observe_many(f"interval.{name}", vals, fabric=fabric)


def _counter_by_fabric(snap: dict, name: str) -> dict:
    out: dict = {}
    for c in snap.get("counters", []):
        if c["name"] == name:
            fab = c["labels"].get("fabric", "")
            out[fab] = out.get(fab, 0.0) + float(c["value"])
    return out


def snapshot_quality(snap: dict, fabric: str | None = None) -> dict:
    """Coverage / hit-rate ratios from a metrics snapshot.

    With ``fabric`` given, the ratios for that fabric alone; otherwise
    fleet-wide (counters summed over fabrics).  Returns
    ``{"n_intervals", "coverage_ratio", "hit_rate"}`` (ratios are NaN with
    no recorded intervals).
    """
    total = _counter_by_fabric(snap, "predictor.intervals_total")
    covered = _counter_by_fabric(snap, "predictor.intervals_covered")
    hit = _counter_by_fabric(snap, "predictor.intervals_hit")
    if fabric is not None:
        n = total.get(fabric, 0.0)
        c = covered.get(fabric, 0.0)
        h = hit.get(fabric, 0.0)
    else:
        n, c, h = sum(total.values()), sum(covered.values()), sum(hit.values())
    return {
        "n_intervals": int(n),
        "coverage_ratio": (c / n) if n else float("nan"),
        "hit_rate": (h / n) if n else float("nan"),
    }
