"""Solver convergence telemetry: per-epoch PDHG effort, summarized.

:meth:`repro.core.jaxlp.JaxRoutingSolver.solve_routing_batch` /
:meth:`~repro.core.jaxlp.JaxRoutingSolver.solve_routing_fleet` return a raw
``stats`` block — per-element iteration counts, final certified relative
duality gaps, and Halpern-restart counts per stage, quantities the
``lax.while_loop`` always computed but used to discard on the device.
:class:`SolverStats` is the host-side summary the engines attach to
:class:`~repro.core.controller.ControllerResult`: it keeps the per-epoch
arrays (small — one scalar per routing epoch) plus the aggregates the bench
JSONs and the CI regression gate consume.

Interpretation (see README "Observability"):

* ``iters`` vs ``max_iters`` — an epoch at the cap exited by iteration
  budget, not by certificate; a growing ``frac_capped`` means the tolerance
  or the cap needs attention.
* ``gap`` vs ``tol`` — the final certified relative duality gap at exit.
  Stage 1 exits only when ``gap <= tol``; stages 2–3 may exit on an
  objective stall instead, so their recorded gap can sit above ``tol``
  while the realized objective error is far smaller.
* ``restarts`` — Halpern anchor restarts (= ``iters // restart_every``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StageStats", "SolverStats", "slice_raw_stats",
           "warm_start_savings"]


@dataclasses.dataclass(frozen=True)
class StageStats:
    """Per-stage telemetry across a sweep's routing solves."""

    iters: tuple  # per-solve PDHG iteration counts
    gaps: tuple  # per-solve final certified relative duality gaps
    restarts: tuple  # per-solve Halpern anchor-restart counts

    @property
    def n(self) -> int:
        return len(self.iters)

    def to_dict(self, max_iters: int, per_epoch: bool = True) -> dict:
        iters = np.asarray(self.iters, np.int64)
        gaps = np.asarray(self.gaps, np.float64)
        finite = gaps[np.isfinite(gaps)]
        out = {
            "n": int(iters.size),
            "iters_mean": float(iters.mean()) if iters.size else 0.0,
            "iters_max": int(iters.max()) if iters.size else 0,
            "n_capped": int((iters >= max_iters).sum()),
            "gap_mean": float(finite.mean()) if finite.size else None,
            "gap_max": float(finite.max()) if finite.size else None,
            "restarts_total": int(np.asarray(self.restarts, np.int64).sum()),
        }
        if per_epoch:
            out["iters"] = [int(i) for i in iters]
            out["gap"] = [None if not np.isfinite(g) else round(float(g), 6)
                          for g in gaps]
        return out


@dataclasses.dataclass(frozen=True)
class SolverStats:
    """Sweep-level solver telemetry attached to ``ControllerResult``."""

    backend: str
    max_iters: int
    tol: float
    stages: dict  # stage name ("stage1"/"stage2"/"stage3") -> StageStats
    anchor_seconds: float = 0.0
    # epochs whose PDHG output came back non-finite (NaN/Inf — e.g. vanishing
    # residual capacity under failure masks) and were re-solved via scipy
    n_fallbacks: int = 0

    @property
    def n_solves(self) -> int:
        return max((s.n for s in self.stages.values()), default=0)

    def frac_capped(self) -> float:
        """Fraction of (stage, epoch) solves that hit the iteration cap."""
        total = sum(s.n for s in self.stages.values())
        if not total:
            return 0.0
        capped = sum(int((np.asarray(s.iters) >= self.max_iters).sum())
                     for s in self.stages.values())
        return capped / total

    def to_dict(self, per_epoch: bool = True) -> dict:
        return {
            "backend": self.backend,
            "max_iters": int(self.max_iters),
            "tol": float(self.tol),
            "anchor_seconds": round(float(self.anchor_seconds), 6),
            "n_fallbacks": int(self.n_fallbacks),
            "frac_capped": round(self.frac_capped(), 6),
            "stages": {k: v.to_dict(self.max_iters, per_epoch)
                       for k, v in self.stages.items()},
        }

    @classmethod
    def from_pdhg(cls, raws: list, max_iters: int, tol: float,
                  n_fallbacks: int = 0) -> "SolverStats":
        """Build from one or more raw ``stats`` blocks returned by
        ``solve_routing_batch`` / ``solve_routing_fleet`` (concatenated in
        order — e.g. the sequential engine's one-epoch batches)."""
        stages: dict = {}
        anchor_s = 0.0
        for raw in raws:
            anchor_s += float(raw.get("anchor_seconds", 0.0))
            for name in ("stage1", "stage2", "stage3"):
                blk = raw.get(name)
                if blk is None:
                    continue
                iters = np.asarray(blk["iters"], np.int64)
                gaps = np.asarray(blk["gap"], np.float64)
                restarts = np.asarray(blk["restarts"], np.int64)
                active = blk.get("active")
                if active is not None:  # stage 2 ran only where delta > 0
                    mask = np.asarray(active, bool)
                    iters, gaps, restarts = (iters[mask], gaps[mask],
                                             restarts[mask])
                prev = stages.get(name)
                if prev is None:
                    stages[name] = StageStats(tuple(iters.tolist()),
                                              tuple(gaps.tolist()),
                                              tuple(restarts.tolist()))
                else:
                    stages[name] = StageStats(
                        prev.iters + tuple(iters.tolist()),
                        prev.gaps + tuple(gaps.tolist()),
                        prev.restarts + tuple(restarts.tolist()))
        return cls(backend="pdhg", max_iters=int(max_iters), tol=float(tol),
                   stages=stages, anchor_seconds=anchor_s,
                   n_fallbacks=int(n_fallbacks))

    @classmethod
    def merge(cls, parts: list) -> "SolverStats | None":
        """Concatenate several SolverStats (e.g. per-fabric bench rows)."""
        parts = [p for p in parts if p is not None]
        if not parts:
            return None
        stages: dict = {}
        for p in parts:
            for name, s in p.stages.items():
                prev = stages.get(name)
                stages[name] = (s if prev is None else StageStats(
                    prev.iters + s.iters, prev.gaps + s.gaps,
                    prev.restarts + s.restarts))
        return cls(backend=parts[0].backend,
                   max_iters=max(p.max_iters for p in parts),
                   tol=max(p.tol for p in parts), stages=stages,
                   anchor_seconds=sum(p.anchor_seconds for p in parts),
                   n_fallbacks=sum(p.n_fallbacks for p in parts))


def warm_start_savings(warm: SolverStats, cold: SolverStats) -> dict:
    """Per-stage PDHG iteration savings of a warm-started sweep vs a cold one.

    The streaming controller's headline solver win (carrying each epoch's
    primal/dual iterates into the next solve) shows up as a drop in median
    iterations per stage; this pairs the two :class:`SolverStats` into the
    dict the serve bench emits and the regression gate reads::

        {"stage1": {"warm_median_iters": ..., "cold_median_iters": ...,
                    "iters_ratio": warm/cold}, ..., "overall": {...}}

    Stages present in only one of the two runs are skipped (e.g. hedging
    active on one side only).  ``iters_ratio < 1`` means the warm start
    saved work.
    """
    out: dict = {}
    tw = tc = 0.0
    for name in sorted(set(warm.stages) & set(cold.stages)):
        w = float(np.median(np.asarray(warm.stages[name].iters, np.float64)))
        c = float(np.median(np.asarray(cold.stages[name].iters, np.float64)))
        out[name] = {"warm_median_iters": w, "cold_median_iters": c,
                     "iters_ratio": w / max(c, 1.0)}
        tw += w
        tc += c
    out["overall"] = {"warm_median_iters": tw, "cold_median_iters": tc,
                      "iters_ratio": tw / max(tc, 1.0)}
    return out


def slice_raw_stats(raw: dict, lo: int, hi: int,
                    anchor_share: float = 0.0) -> dict:
    """Per-job slice of a fleet-wide raw ``stats`` block (flattened batch
    axis ``[lo:hi]``); ``anchor_share`` apportions the bucket's anchor time."""
    out = {"anchor_seconds": anchor_share}
    for name in ("stage1", "stage2", "stage3"):
        blk = raw.get(name)
        if blk is None:
            continue
        sliced = {k: np.asarray(v)[lo:hi] for k, v in blk.items()}
        out[name] = sliced
    return out
