"""Transition scoring: per-stage routing re-solves + batched stage scoring —
the counterpart of ``repro/transition/score.py``, on the device.

A drain schedule (:mod:`repro_torch.transition.schedule`) yields one residual
capacity vector per stage.  Scoring a transition means (1) re-solving
routing on every stage's drained capacities — all stages (plus the old and
new steady topologies) go through **one batched PDHG call on the device**
(:meth:`repro_torch.core.pdhg.TorchRoutingSolver.solve_routing_batch`) or
the scipy/HiGHS fallback — and (2) evaluating realized per-interval metrics
with the stages mapped onto the leading batch axis of the epoch-batched
linkload and queueloss CUDA kernels
(:func:`repro_torch.core.simulator.route_metrics_batched`), exactly the shape
the batched engine scores routing epochs with.  Each stage block is one CTA
of each kernel, so adding stage blocks to a batch never moves the bits of
another block.

The resulting :class:`TransitionEval` carries everything the §4.6 decision
rule needs: predicted steady-state MLU on the old and new topologies, the
predicted worst-stage MLU, and the benefit/disruption aggregates consumed by
:func:`repro_torch.transition.config.should_reconfigure`.  The functions that
touch the device take ``device`` (``None`` = CUDA).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Fabric
from repro_torch.core.paths import build_paths, routing_weight_matrices
from repro_torch.device import resolve_device
from repro_torch.transition.config import TransitionConfig
from repro_torch.transition.diff import TopologyDiff, diff_topologies
from repro_torch.transition.schedule import (proxy_splits, schedule_drains,
                                             stage_trunks_for_order)

__all__ = ["TransitionEval", "score_stage_batch", "evaluate_transition",
           "stage_spans", "stage_partition", "stage_metrics"]


@dataclasses.dataclass(frozen=True)
class TransitionEval:
    """One evaluated (scheduled + scored) topology transition."""

    diff: TopologyDiff
    order: tuple  # drain order over panels with moves
    stage_trunks: np.ndarray  # (S, E_u) residual trunks per stage
    stage_caps: np.ndarray  # (S, E_d) residual directed capacities
    stage_w: np.ndarray  # (S, C, E_d) per-stage routing weights
    stage_u: np.ndarray  # (S,) predicted per-stage MLU (u*)
    u_old: float  # predicted MLU keeping the old topology
    u_new: float  # predicted steady-state MLU on the new topology
    proxy_worst: float  # scheduler's worst-stage proxy MLU (chosen order)
    proxy_worst_naive: float  # worst-stage proxy MLU of the naive order
    stage_intervals: int
    horizon_intervals: int
    # fixed-routing inputs of the failure-aware gate
    # (repro_torch.failures.policy.transition_worst_case, the reference's
    # repro.failures.policy's): the old/new steady weight matrices and the
    # capacities they were solved against, stacked [old, new].  None only on
    # hand-built evals.
    steady_w: np.ndarray | None = None  # (2, C, E_d)
    steady_caps: np.ndarray | None = None  # (2, E_d)

    @property
    def n_stages(self) -> int:
        return len(self.order)

    @property
    def transition_intervals(self) -> int:
        return self.n_stages * self.stage_intervals

    @property
    def worst_stage_u(self) -> float:
        return float(self.stage_u.max()) if self.stage_u.size else self.u_new

    @property
    def benefit(self) -> float:
        """Predicted MLU * intervals gained over the steady remainder of the
        decision horizon by switching to the new topology."""
        steady = max(self.horizon_intervals - self.transition_intervals, 0)
        return (self.u_old - self.u_new) * steady

    @property
    def disruption(self) -> float:
        """Predicted worst-stage MLU excess over staying put, integrated over
        the transition's staged intervals."""
        return max(self.worst_stage_u - self.u_old, 0.0) * self.transition_intervals

    def log_entry(self, start: int, applied: bool) -> dict:
        return {
            "start": int(start),
            "order": tuple(int(p) for p in self.order),
            "total_moves": self.diff.total_moves,
            "total_fiber_moves": self.diff.total_fiber_moves,
            "u_old": float(self.u_old),
            "u_new": float(self.u_new),
            "stage_u": tuple(float(u) for u in self.stage_u),
            "worst_stage_u": float(self.worst_stage_u),
            "proxy_worst": float(self.proxy_worst),
            "proxy_worst_naive": float(self.proxy_worst_naive),
            "benefit": float(self.benefit),
            "disruption": float(self.disruption),
            "applied": bool(applied),
        }


def score_stage_batch(fabric: Fabric, tms: np.ndarray, capacities: np.ndarray,
                      delta: float, hedging: bool, sc, cc, device=None) -> tuple:
    """Routing re-solves for a ``(B, E_d)`` batch of capacity vectors.

    ``cc.solver_backend == "pdhg"`` solves all elements in one batched PDHG
    call on ``device`` (``None`` = CUDA); ``"scipy"`` loops HiGHS LPs.  A
    *stranded* element — a drain stage leaving some commodity with zero
    capacity on every candidate path (exactly :func:`proxy_splits` returning
    None) — gets ``u = inf`` on both backends so the decision rule sees
    infinite disruption; neither solver reports this itself (scipy's LP turns
    infeasible, while the PDHG operators treat dead links as unconstrained
    and return a finite, even zero, ``u``).

    Returns ``(f, u)`` with shapes ``(B, P)`` and ``(B,)``.
    """
    from repro_torch import obs
    from repro_torch.core.engine import (_pad_tms, _solve_routing_scipy,
                                   routing_solver_for)

    tms = np.asarray(tms, dtype=np.float64)
    caps = np.asarray(capacities, dtype=np.float64)
    b = caps.shape[0]
    paths = build_paths(fabric.n_pods)
    with obs.span("transition.score_stage_batch", b=b,
                  backend=cc.solver_backend):
        stranded = np.asarray([proxy_splits(paths, caps[i]) is None
                               for i in range(b)])
        if cc.solver_backend == "pdhg":
            solver = routing_solver_for(fabric, cc.k_critical,
                                        cc.pdhg_max_iters, cc.pdhg_tol,
                                        cc.solver_precision,
                                        device=resolve_device(device))
            tms_b = np.broadcast_to(_pad_tms(tms, cc.k_critical),
                                    (b, cc.k_critical, tms.shape[1]))
            out = solver.solve_routing_batch(
                np.ascontiguousarray(tms_b), caps, hedging=hedging,
                deltas=np.full((b,), delta), skip_stage3=sc.skip_stage3)
            f_b = np.asarray(out["f"], np.float64)
            u_b = np.where(stranded, np.inf,
                           np.asarray(out["u_star"], np.float64))
            return f_b, u_b
        f_b = np.empty((b, paths.n_paths))
        u_b = np.empty((b,))
        for i in range(b):
            try:
                f, u, _ = _solve_routing_scipy(fabric, tms, sc, caps[i],
                                               delta)
            except RuntimeError:
                f = proxy_splits(paths, caps[i])
                if f is None:  # fully stranded: uniform spread, MLU inf anyway
                    f = np.full((paths.n_paths,), 1.0 / (fabric.n_pods - 1))
                u = float("inf")
            f_b[i], u_b[i] = f, (float("inf") if stranded[i] else u)
        return f_b, u_b


def evaluate_transition(fabric: Fabric, tms: np.ndarray, n_old: np.ndarray,
                        n_new: np.ndarray, tcfg: TransitionConfig, cc, sc,
                        delta: float = 0.0, hedging: bool = False,
                        horizon_intervals: int = 1,
                        device=None) -> TransitionEval | None:
    """Diff, schedule, and score an old -> new topology change.

    Returns None when the change needs no jumper moves (applying it is free
    — the controller treats that as an unconditional apply).
    ``horizon_intervals`` is the window the benefit amortizes over (the
    controller passes its topology reconfiguration period).

    The old/new steady solves here intentionally stay separate from the
    controller's own routing solves for the epoch (which re-solve the same
    problem on whichever topology the decision picks): topology epochs are
    rare, and reusing ``f_b[:2]`` would couple the decision path to each
    engine's batch/anchor structure, letting sequential and batched runs
    drift under the PDHG backend.
    """
    diff = diff_topologies(fabric.n_pods, n_old, n_new, tcfg.n_panels)
    if diff.total_moves == 0:
        return None
    order, proxy_worst, proxy_naive = schedule_drains(fabric, tms, diff)
    stage_trunks = stage_trunks_for_order(diff, order)
    stage_caps = np.stack([fabric.capacities(t) for t in stage_trunks])
    caps_b = np.concatenate([fabric.capacities(np.rint(n_old))[None],
                             fabric.capacities(np.rint(n_new))[None],
                             stage_caps])
    f_b, u_b = score_stage_batch(fabric, tms, caps_b, delta, hedging, sc, cc,
                                 device=device)
    paths = build_paths(fabric.n_pods)
    return TransitionEval(
        diff=diff,
        order=order,
        stage_trunks=stage_trunks,
        stage_caps=stage_caps,
        stage_w=routing_weight_matrices(paths, f_b[2:]),
        stage_u=u_b[2:],
        u_old=float(u_b[0]),
        u_new=float(u_b[1]),
        proxy_worst=proxy_worst,
        proxy_worst_naive=proxy_naive,
        stage_intervals=tcfg.stage_intervals,
        horizon_intervals=horizon_intervals,
        steady_w=routing_weight_matrices(paths, f_b[:2]),
        steady_caps=caps_b[:2],
    )


def stage_spans(n_stages: int, stage_intervals: int, length: int) -> list:
    """Split the first intervals of an epoch block into drain-stage spans.

    Returns ``[(stage, lo, hi), ...]`` with ``lo < hi`` (empty spans from
    clipping at the block end are dropped); the remainder ``[min(n_stages *
    stage_intervals, length), length)`` runs on the new steady topology.
    """
    spans = []
    for k in range(n_stages):
        lo = k * stage_intervals
        hi = min(lo + stage_intervals, length)
        if lo >= hi:
            break
        spans.append((k, lo, hi))
    return spans


def stage_partition(ev: TransitionEval, block_len: int, start: int,
                    loss_seed: int | None) -> tuple:
    """Partition a topology epoch's block for staged scoring.

    The single source of the span/seed arithmetic both engines score with
    (their outputs must stay bit-identical — parity is test-enforced); the
    stage width comes from ``ev.stage_intervals`` so spans and the remainder
    boundary can never disagree.  Returns ``(spans, seeds, rem_lo,
    rem_seed)``: the clipped :func:`stage_spans`, the per-span burst seeds
    (None without loss tracking; ``loss_seed + absolute interval index``
    otherwise, matching the legacy per-block seeding), the offset where the
    steady new topology takes over, and the remainder block's seed.
    """
    spans = stage_spans(ev.n_stages, ev.stage_intervals, block_len)
    rem_lo = min(ev.transition_intervals, block_len)
    if loss_seed is None:
        return spans, None, rem_lo, None
    return (spans, [loss_seed + start + lo for _, lo, _ in spans], rem_lo,
            loss_seed + start + rem_lo)


def stage_metrics(demand: np.ndarray, ev: TransitionEval,
                  overload_threshold: float = 0.8, backend: str = "numpy",
                  loss_cfg=None, loss_seeds=None,
                  interval_seconds: float | None = None, device=None):
    """Score one demand block under every stage in a single batched call.

    Maps the stages onto the leading batch axis of the epoch-batched
    linkload/queueloss kernels (``backend="torch"``: one launch each on
    ``device``, ``None`` = CUDA; ``"numpy"``: the float64 oracle): each stage
    scores the same ``(T, C)`` block under its own residual capacities and
    re-solved routing.  Returns a list of per-stage
    :class:`repro_torch.core.simulator.IntervalMetrics`.
    """
    from repro_torch.core.simulator import (IntervalMetrics,
                                            route_metrics_batched)

    demand = np.asarray(demand, dtype=np.float64)
    s = ev.n_stages
    m = route_metrics_batched(
        [demand] * s, ev.stage_w, ev.stage_caps, overload_threshold,
        backend=backend, loss_cfg=loss_cfg, loss_seeds=loss_seeds,
        interval_seconds=interval_seconds, device=device)
    t = demand.shape[0]
    return [IntervalMetrics(
        mlu=m.mlu[i * t:(i + 1) * t], alu=m.alu[i * t:(i + 1) * t],
        olr=m.olr[i * t:(i + 1) * t], stretch=m.stretch[i * t:(i + 1) * t],
        loss=None if m.loss is None else m.loss[i * t:(i + 1) * t])
        for i in range(s)]
