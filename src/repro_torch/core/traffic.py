"""Traffic-matrix traces and the paper's §2 measurement statistics.

A *trace* is a dense ``(T, C)`` array: ``T`` measurement intervals (the paper
uses 5-minute SNMP averages) × ``C = V*(V-1)`` ordered pod-pair commodities,
in the enumeration of :mod:`repro.core.graph`.

Implements the paper's §2 fleet statistics used for both motivation figures
and the predictor's volatility classification:

* **DMR** (demand-to-max ratio, Fig. 6/7): next-day demand over the prior
  ``train_days`` maximum, per commodity.
* **well-bounded** pairs: p99 DMR ≤ 1; a fabric is *mostly-bounded* when the
  well-bounded fraction ``p > 0.9``.
* **skew** (Fig. 5): fraction of commodities carrying 80% of traffic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Trace",
    "dmr",
    "well_bounded_fraction",
    "skew_fraction_for_share",
    "sliding_windows",
]


@dataclasses.dataclass(frozen=True)
class Trace:
    """A (T, C) traffic-matrix trace with its measurement cadence."""

    name: str
    demand: np.ndarray  # (T, C) float64, same units as capacities (e.g. Gb/s)
    interval_minutes: float
    n_pods: int

    def __post_init__(self):
        d = np.asarray(self.demand, dtype=np.float64)
        object.__setattr__(self, "demand", d)
        c = self.n_pods * (self.n_pods - 1)
        if d.ndim != 2 or d.shape[1] != c:
            raise ValueError(f"demand must be (T, {c}); got {d.shape}")
        if (d < 0).any():
            raise ValueError("demand must be non-negative")

    @property
    def n_intervals(self) -> int:
        return int(self.demand.shape[0])

    @property
    def n_commodities(self) -> int:
        return int(self.demand.shape[1])

    def intervals_per_day(self) -> int:
        return int(round(24 * 60 / self.interval_minutes))

    def slice_days(self, start_day: float, n_days: float) -> "Trace":
        ipd = self.intervals_per_day()
        a = int(round(start_day * ipd))
        b = int(round((start_day + n_days) * ipd))
        return Trace(self.name, self.demand[a:b], self.interval_minutes, self.n_pods)

    def maximal_tm(self) -> np.ndarray:
        """Element-wise maximal TM over the whole trace (paper's Maximal-TM)."""
        return self.demand.max(axis=0)


def sliding_windows(trace: Trace, window_days: float, stride_days: float):
    """Yield ``(start_day, Trace)`` sliding windows over the trace."""
    ipd = trace.intervals_per_day()
    w = int(round(window_days * ipd))
    s = int(round(stride_days * ipd))
    t = trace.n_intervals
    for a in range(0, t - w + 1, max(s, 1)):
        yield a / ipd, Trace(trace.name, trace.demand[a : a + w], trace.interval_minutes, trace.n_pods)


def dmr(trace: Trace, train_days: int = 7) -> np.ndarray:
    """Demand-to-max ratios (paper §2): for each day ``d`` after the first
    ``train_days``, the ratio of each interval's demand to the prior
    ``train_days`` element-wise max.  Returns ``(T_test, C)``; rows for which
    the trailing max is zero produce DMR 0 (a pair with no history and no
    demand is trivially bounded; one with new demand gets +inf).
    """
    ipd = trace.intervals_per_day()
    warm = train_days * ipd
    if trace.n_intervals <= warm:
        raise ValueError("trace shorter than the training window")
    d = trace.demand
    out = np.zeros((trace.n_intervals - warm, trace.n_commodities), dtype=np.float64)
    # daily-refreshed trailing max (the paper slides the window per day)
    for day_start in range(warm, trace.n_intervals, ipd):
        hist_max = d[day_start - warm : day_start].max(axis=0)
        seg = d[day_start : day_start + ipd]
        with np.errstate(divide="ignore", invalid="ignore"):
            r = seg / hist_max[None, :]
        r = np.where(seg == 0.0, 0.0, r)
        r = np.where((hist_max[None, :] == 0.0) & (seg > 0.0), np.inf, r)
        out[day_start - warm : day_start - warm + seg.shape[0]] = r
    return out


def well_bounded_fraction(trace: Trace, train_days: int = 7, pct: float = 99.0) -> float:
    """Fraction ``p`` of commodities whose ``pct``-percentile DMR ≤ 1 (Fig. 6)."""
    r = dmr(trace, train_days)
    finite = np.where(np.isinf(r), 1e9, r)
    p = np.percentile(finite, pct, axis=0)
    active = trace.demand.max(axis=0) > 0
    if not active.any():
        return 1.0
    return float((p[active] <= 1.0).mean())


def skew_fraction_for_share(trace: Trace, share: float = 0.8) -> float:
    """Smallest fraction of commodities that carries ``share`` of the total
    time-averaged traffic (Fig. 5; lower = more skewed)."""
    mean = trace.demand.mean(axis=0)
    total = mean.sum()
    if total <= 0:
        return 1.0
    srt = np.sort(mean)[::-1]
    cum = np.cumsum(srt) / total
    k = int(np.searchsorted(cum, share) + 1)
    return k / mean.shape[0]
