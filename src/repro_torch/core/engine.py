"""Plan → batch-execute controller engine (paper §4.6 at fleet scale) — the
counterpart of ``repro/core/engine.py``.

1. **Plan** (:func:`plan_artifacts`): walk the trace computing every routing
   epoch's window, critical TMs (k-means Lloyd iterations on the device),
   burst estimate δ and topology epochs.  Joint topology solves (the rare,
   daily events) run on the host through scipy/HiGHS and are realized before
   use.  With ``ControllerConfig.transition`` set, every topology update
   after the first goes through the §4.6 gate
   (:func:`repro_torch.core.controller._transition_gate`: one PDHG batch
   over the old, new and drain-stage capacities on the device).
2. **Solve**: every routing-only epoch shares shape ``(m, C)`` and a
   per-epoch capacity vector, so all epochs go through one batched PDHG call
   on the device (:meth:`repro_torch.core.pdhg.TorchRoutingSolver.solve_routing_batch`)
   — or through scipy/HiGHS one by one with ``solver_backend="scipy"``.
3. **Score**: one :func:`repro_torch.core.simulator.route_metrics_batched`
   call scores the whole sweep — one launch each of the epoch-batched
   linkload and queueloss CUDA kernels, burst loss included; drain stages
   slot in as extra blocks on the same batch axis.
4. **Contingencies** (``ControllerConfig.failures`` set): the same scoring
   blocks under sampled failure masks, one launch of the fleet kernels over
   (scenario × block) rows (:func:`repro_torch.failures.evaluate_plan`).

The device is explicit: :func:`run_controller_batched` threads it into the
k-means, the solver and the scoring calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import clustering
from repro_torch.core.graph import Fabric, uniform_topology
from repro_torch.core.lp import estimate_delta
from repro_torch.core.paths import build_paths, routing_weight_matrices
from repro_torch.core.rounding import realize
from repro_torch.core.simulator import route_metrics_batched, summarize
from repro_torch.core.solver import SolverConfig, Strategy, solve
from repro_torch.core.traffic import Trace
from repro_torch.device import resolve_device

__all__ = ["EpochPlan", "ControllerPlan", "PlanArtifacts", "plan_controller",
           "plan_artifacts", "plan_score_blocks", "execute_plan",
           "pdhg_finite_fallback", "run_controller_batched",
           "routing_solver_for"]


@dataclasses.dataclass(frozen=True)
class EpochPlan:
    """One routing epoch of the sweep."""

    index: int  # routing-update index (also the critical-TM k-means seed)
    start: int  # first scored interval (window is demand[start-agg : start])
    stop: int  # one past the last scored interval
    topo_solve: bool  # a joint topology re-solve fires at this epoch


@dataclasses.dataclass(frozen=True)
class ControllerPlan:
    """Static structure of a controller sweep over one trace."""

    agg: int  # aggregation window, in intervals
    route_step: int  # routing reconfiguration period, in intervals
    topo_step: int  # topology reconfiguration period, in intervals
    epochs: tuple  # tuple[EpochPlan]

    @property
    def n_routing(self) -> int:
        return len(self.epochs)

    @property
    def n_topology(self) -> int:
        return sum(e.topo_solve for e in self.epochs)


def plan_controller(trace: Trace, cc, nonuniform: bool) -> ControllerPlan:
    """Walk the trace computing epoch boundaries (no solving): the first
    aggregation window is warm-up, topology re-solves (nonuniform strategies
    only) fire at warm-up end and then whenever a routing step reaches
    ``next_topo``."""
    ipd = trace.intervals_per_day()
    agg = max(1, int(round(cc.aggregation_days * ipd)))
    route_step = max(1, int(round(cc.routing_interval_hours * ipd / 24.0)))
    topo_step = max(route_step, int(round(cc.topology_interval_days * ipd)))
    if trace.n_intervals <= agg:
        raise ValueError("trace shorter than the aggregation window")
    epochs = []
    next_topo = agg
    first = True
    for i, start in enumerate(range(agg, trace.n_intervals, route_step)):
        topo = nonuniform and (first or start >= next_topo)
        if topo:
            next_topo = start + topo_step
        epochs.append(EpochPlan(index=i, start=start,
                                stop=min(start + route_step, trace.n_intervals),
                                topo_solve=topo))
        first = False
    return ControllerPlan(agg=agg, route_step=route_step, topo_step=topo_step,
                          epochs=tuple(epochs))


# one PDHG solver per (pods, m, knobs, device): building one walks the path
# set and copies its masks to the device, which the streaming and sequential
# controllers would otherwise repeat on every epoch
_SOLVER_CACHE: dict = {}


def routing_solver_for(fabric: Fabric, m: int, max_iters: int, tol: float,
                       precision: str = "f32", device=None):
    """The shared PDHG solver for ``fabric``'s shape on ``device``; a
    same-shape fabric reuses it (``.fabric`` is set to the caller's).  Its
    ``dual_topk`` is the autotune table's for the shape, looked up on every
    call, so a re-tuned table or ``REPRO_AUTOTUNE=0`` reaches the next
    solve."""
    from repro_torch.core.pdhg import TorchRoutingSolver
    from repro_torch.kernels.autotune import solver_knobs

    dev = resolve_device(device)
    dual_topk = solver_knobs(fabric.n_pods, m, dev)["dual_topk"]
    key = (fabric.n_pods, m, max_iters, tol, precision, dev, dual_topk)
    if key not in _SOLVER_CACHE:
        _SOLVER_CACHE[key] = TorchRoutingSolver(
            fabric, m, max_iters=max_iters, tol=tol, dual_topk=dual_topk,
            precision=precision, device=dev)
    sol = _SOLVER_CACHE[key]
    sol.fabric = fabric  # same-shape fabrics share the solver
    return sol


def _pad_tms(tms: np.ndarray, k: int) -> np.ndarray:
    """Zero-pad critical TMs to the static ``k`` rows (zero rows are exactly
    vacuous in all three routing stages)."""
    if tms.shape[0] >= k:
        return tms[:k]
    pad = np.zeros((k - tms.shape[0], tms.shape[1]), tms.dtype)
    return np.concatenate([tms, pad], axis=0)


def _solve_routing_scipy(fabric, tms, sc, capacities, delta):
    """One fixed-capacity routing re-solve via scipy/HiGHS (stages 1→[2]→3)."""
    from repro_torch.core.lp import LpBuilder

    paths = build_paths(fabric.n_pods)
    b = LpBuilder(fabric, paths, tms, delta=delta)
    res1 = b.solve_stage1_fixed_topology(capacities)
    if not res1.ok:
        raise RuntimeError(f"routing stage 1 failed on {fabric.name}")
    u_star, f = float(res1.scalar), res1.f
    r_star = None
    if delta > 0:
        res2 = b.solve_stage2_fixed_topology(capacities, u_star * 1.005 + 1e-9)
        if res2.ok:
            r_star, f = float(res2.scalar), res2.f
    if not sc.skip_stage3:
        res3 = b.solve_stage3(u_star * 1.005 + 1e-9,
                              None if r_star is None else r_star * 1.005 + 1e-12,
                              capacities)
        if res3.ok:
            f = res3.f
    return f, u_star, r_star


def pdhg_finite_fallback(fabric, tms_seq, caps_b, deltas_b, sc,
                         f_b: np.ndarray, u_b: np.ndarray):
    """Replace non-finite PDHG batch elements with scipy re-solves.

    Under near-zero residual capacity the first-order iterations can
    overflow to NaN/Inf; scoring such splits would poison a whole sweep's
    metrics.  Each bad element — any non-finite entry in its splits or its
    ``u*`` — is re-solved through scipy/HiGHS on its own TMs/capacities; an
    element whose LP is infeasible keeps uniform splits with ``u = inf``.
    Returns ``(f_b, u_b, n_fallbacks)`` with the bad rows replaced.
    """
    f_b = np.array(f_b, np.float64, copy=True)
    u_b = np.array(u_b, np.float64, copy=True)
    bad = ~(np.isfinite(f_b).all(axis=tuple(range(1, f_b.ndim)))
            & np.isfinite(u_b))
    n_bad = int(bad.sum())
    if not n_bad:
        return f_b, u_b, 0
    for i in np.nonzero(bad)[0]:
        try:
            f_i, u_i, _ = _solve_routing_scipy(
                fabric, np.asarray(tms_seq[i], np.float64), sc,
                np.asarray(caps_b[i], np.float64), float(deltas_b[i]))
        except RuntimeError:
            f_i = np.full(f_b.shape[1], 1.0 / (fabric.n_pods - 1))
            u_i = np.inf
        f_b[i], u_b[i] = f_i, u_i
    obs.event("solver.nonfinite_fallback", fabric=fabric.name, n=n_bad)
    obs.metrics.inc("solver.nonfinite_fallbacks", float(n_bad),
                    fabric=fabric.name)
    return f_b, u_b, n_bad


@dataclasses.dataclass
class PlanArtifacts:
    """Output of the controller's plan walk (phase 1): per-epoch critical
    TMs, burst sizes, realized capacities and staged transitions, plus the
    topology-update bookkeeping the final result reports."""

    plan: ControllerPlan
    tms: tuple  # per-epoch (m_i, C) critical TMs (unpadded — scipy path)
    deltas: np.ndarray  # (B,) burst sizes (0 without hedging)
    caps: np.ndarray  # (B, E) realized directed capacities per epoch
    staging: tuple  # per-epoch TransitionEval | None (drain-staged epochs)
    n_topology: int
    n_skipped: int
    transition_log: tuple
    n_realized: np.ndarray  # final realized topology (trunk counts)
    solver_seconds: float  # topology-solve + transition-eval wall clock
    plan_seconds: float = 0.0  # whole plan-walk wall clock (phase "plan")
    transition_seconds: float = 0.0  # gate-evaluation share of the plan walk

    def tms_padded(self, k: int) -> np.ndarray:
        """Critical TMs zero-padded to the static ``k`` rows, stacked (B, m, C)."""
        return np.stack([_pad_tms(t, k) for t in self.tms])


def plan_artifacts(fabric: Fabric, trace: Trace, strategy: Strategy,
                   cc, sc: SolverConfig, device=None) -> PlanArtifacts:
    """Phase 1: walk the trace computing windows, critical TMs, and topology
    epochs (joint topology solves run sequentially through scipy/HiGHS)."""
    from repro_torch.core.controller import (_count_topology_update,
                                             _transition_gate)

    dev = resolve_device(device)
    kmeans_dtype = getattr(torch, cc.kmeans_dtype)
    plan = plan_controller(trace, cc, strategy.nonuniform)
    solver_s, transition_s = 0.0, 0.0
    tc = cc.transition
    tms_list, deltas, caps_list, staging = [], [], [], []
    n_topology, n_skipped, transition_log = 0, 0, []
    cap: np.ndarray | None = None
    n_realized: np.ndarray | None = None
    with obs.timed("engine.plan", fabric=fabric.name) as t_plan:
        for ep in plan.epochs:
            window = trace.demand[max(0, ep.start - plan.agg): ep.start]
            tms = clustering.critical_tms(window, k=cc.k_critical,
                                          seed=ep.index, dtype=kmeans_dtype,
                                          device=dev)
            delta = 0.0
            if strategy.hedging:
                delta = (sc.delta if sc.delta is not None
                         else estimate_delta(window, sc.delta_quantile))
            staged = None  # TransitionEval whose drain stages score this epoch
            if ep.topo_solve:
                sol = solve(fabric, tms, strategy, sc, window_demand=window)
                solver_s += sol.solve_seconds
                cand = (realize(fabric, sol.n_e)[0]
                        if cc.realize_topology else sol.n_e)
                cand_cap = fabric.capacities(cand)
                apply = True
                if tc is not None and n_realized is not None:
                    apply, staged, ev, ev_s = _transition_gate(
                        fabric, tms, n_realized, cand, tc, cc, sc,
                        delta=delta, hedging=strategy.hedging,
                        horizon_intervals=plan.topo_step, device=dev)
                    solver_s += ev_s
                    transition_s += ev_s
                    if ev is not None:
                        transition_log.append(ev.log_entry(ep.start, apply))
                if apply:
                    n_realized, cap = cand, cand_cap
                    n_topology += 1
                else:
                    n_skipped += 1
                _count_topology_update(fabric, ep.start, apply)
            elif cap is None:
                n0 = uniform_topology(fabric)
                n_realized = (realize(fabric, n0)[0]
                              if cc.realize_topology else n0)
                cap = fabric.capacities(n_realized)
            tms_list.append(tms)
            deltas.append(delta)
            caps_list.append(cap)
            staging.append(staged)
    return PlanArtifacts(
        plan=plan, tms=tuple(tms_list), deltas=np.asarray(deltas),
        caps=np.stack(caps_list), staging=tuple(staging),
        n_topology=n_topology, n_skipped=n_skipped,
        transition_log=tuple(transition_log),
        n_realized=np.asarray(n_realized), solver_seconds=solver_s,
        plan_seconds=t_plan.seconds, transition_seconds=transition_s)


def plan_score_blocks(trace: Trace, art: PlanArtifacts, w_b: np.ndarray,
                      caps: np.ndarray, cc):
    """Assemble one sweep's scoring blocks in trace order.

    Drain stages slot in as extra blocks on the same leading batch axis, so a
    transition-heavy sweep still scores in one launch of each epoch-batched
    kernel.  ``w_b``/``caps`` may live in a padded commodity layout (fleet
    engine) — staged epochs' ``stage_w``/``stage_caps`` are taken from
    ``art.staging`` as-is, so callers in a padded layout must pad those too.

    Returns ``(blocks, block_w, block_caps, loss_seeds, block_epoch)``;
    ``blocks`` are (T_b, C) demand slices of ``trace``, each block's burst
    seed is ``cc.loss.seed`` plus its first interval (paired with the
    reference controller), and ``block_epoch`` maps each block to its
    routing epoch (the contingency re-solve needs each block's critical TMs
    and burst size)."""
    from repro_torch.transition import stage_partition

    blocks, block_w, block_caps, loss_seeds, block_epoch = [], [], [], [], []
    for i, ep in enumerate(art.plan.epochs):
        block = trace.demand[ep.start: ep.stop]
        rem_lo, rem_seed = 0, (cc.loss.seed + ep.start
                               if cc.loss is not None else None)
        ev = art.staging[i]
        if ev is not None:
            spans, seeds, rem_lo, rem_seed = stage_partition(
                ev, block.shape[0], ep.start,
                cc.loss.seed if cc.loss is not None else None)
            for s, (k, lo, hi) in enumerate(spans):
                blocks.append(block[lo:hi])
                block_w.append(ev.stage_w[k])
                block_caps.append(ev.stage_caps[k])
                loss_seeds.append(seeds[s] if seeds is not None else 0)
                block_epoch.append(i)
        if block.shape[0] - rem_lo > 0:
            blocks.append(block[rem_lo:])
            block_w.append(w_b[i])
            block_caps.append(caps[i])
            loss_seeds.append(rem_seed if rem_seed is not None else 0)
            block_epoch.append(i)
    return blocks, block_w, block_caps, loss_seeds, block_epoch


def transit_fraction_of(paths, f_b: np.ndarray) -> float:
    """Mean (over epochs) fraction of split mass on 2-hop transit paths."""
    two = paths.path_n_edges == 2
    return float(np.mean(
        f_b[:, two].sum(axis=1) / np.maximum(f_b.sum(axis=1), 1e-12)))


def execute_plan(fabric: Fabric, trace: Trace, strategy: Strategy,
                 cc, sc: SolverConfig, art: PlanArtifacts, device=None):
    """Phases 2–3: batched routing-only solves + single-pass batched scoring
    for one planned sweep, then the contingency analysis when
    ``cc.failures`` is set."""
    from repro_torch.core.controller import ControllerResult

    dev = resolve_device(device)
    paths = build_paths(fabric.n_pods)
    fixed = Strategy(nonuniform=False, hedging=strategy.hedging)
    caps = art.caps
    solver_s = art.solver_seconds
    phases = obs.PhaseTimes()
    phases.add("plan", art.plan_seconds)
    if art.transition_seconds:
        phases.add("transition", art.transition_seconds)
    solver_stats = None

    # ---- phase 2: batched routing-only solves -------------------------------
    with phases("solve", "engine.solve") as t_solve:
        if cc.solver_backend == "pdhg":
            solver = routing_solver_for(fabric, cc.k_critical,
                                        cc.pdhg_max_iters, cc.pdhg_tol,
                                        cc.solver_precision, device=dev)
            out = solver.solve_routing_batch(
                art.tms_padded(cc.k_critical), caps, hedging=fixed.hedging,
                deltas=art.deltas, skip_stage3=sc.skip_stage3)
            f_b, u_b, n_fb = pdhg_finite_fallback(
                fabric, art.tms, caps, art.deltas, sc,
                out["f"], out["u_star"])
            phases.add("anchor", out["stats"].get("anchor_seconds", 0.0))
            solver_stats = obs.SolverStats.from_pdhg(
                [out["stats"]], cc.pdhg_max_iters, cc.pdhg_tol,
                n_fallbacks=n_fb)
        elif cc.solver_backend == "scipy":
            solved = [_solve_routing_scipy(fabric, tms, sc, c, d)
                      for tms, c, d in zip(art.tms, caps, art.deltas)]
            f_b = np.stack([f for f, _, _ in solved])
            u_b = np.asarray([u for _, u, _ in solved], np.float64)
        else:
            raise ValueError(f"unknown solver_backend {cc.solver_backend!r}")
    solver_s += t_solve.seconds

    # ---- phase 3: single-pass batched scoring -------------------------------
    with phases("score", "engine.score"):
        w_b = routing_weight_matrices(paths, f_b)
        blocks, block_w, block_caps, loss_seeds, block_epoch = \
            plan_score_blocks(trace, art, w_b, caps, cc)
        metrics = route_metrics_batched(
            blocks, np.stack(block_w), np.stack(block_caps),
            cc.overload_threshold,
            backend=cc.backend, loss_cfg=cc.loss,
            loss_seeds=loss_seeds if cc.loss is not None else None,
            interval_seconds=trace.interval_minutes * 60.0, device=dev)

    summary = summarize(metrics)
    if obs.metrics.enabled():
        obs.quality.record_interval_metrics(fabric.name, metrics)
        for ep, tms in zip(art.plan.epochs, art.tms):
            obs.quality.record_epoch_quality(
                fabric.name, tms, trace.demand[ep.start: ep.stop])

    # ---- contingency analysis (optional; cc.failures=None skips) ------------
    contingency = None
    if cc.failures is not None:
        from repro_torch.failures import evaluate_plan

        with phases("failures", "engine.failures"):
            ep_idx = np.asarray(block_epoch)
            resolve = cc.failures.resolve
            contingency = evaluate_plan(
                fabric, cc, sc, blocks, np.stack(block_w),
                np.stack(block_caps),
                loss_seeds if cc.loss is not None else None,
                trace.interval_minutes * 60.0,
                tms_blocks=(art.tms_padded(cc.k_critical)[ep_idx]
                            if resolve else None),
                deltas=art.deltas[ep_idx] if resolve else None, device=dev)
            summary.update(contingency.summary_update())

    return ControllerResult(
        strategy=strategy,
        metrics=metrics,
        summary=summary,
        n_routing_updates=art.plan.n_routing,
        n_topology_updates=art.n_topology,
        final_topology=np.asarray(art.n_realized),
        transit_fraction=transit_fraction_of(paths, f_b),
        solver_seconds=solver_s,
        n_skipped_topology=art.n_skipped,
        transition_log=art.transition_log,
        stage_times=phases.times,
        solver_stats=solver_stats,
        contingency=contingency,
        splits=f_b,
        capacities=caps,
        u_star=u_b,
    )


def run_controller_batched(
    fabric: Fabric,
    trace: Trace,
    strategy: Strategy,
    cc=None,
    sc: SolverConfig | None = None,
    device=None,
):
    """Plan → batch-execute controller sweep on ``device`` (``None`` = CUDA).

    Returns a :class:`~repro_torch.core.controller.ControllerResult` with the
    reference engine's fields and semantics.
    """
    from repro_torch.core.controller import ControllerConfig

    dev = resolve_device(device)
    cc = cc or ControllerConfig()
    sc = sc or SolverConfig()
    art = plan_artifacts(fabric, trace, strategy, cc, sc, device=dev)
    return execute_plan(fabric, trace, strategy, cc, sc, art, device=dev)
