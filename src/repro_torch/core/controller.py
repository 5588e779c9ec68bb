"""Online Controller (paper §4.6, Fig. 10) — the counterpart of
``repro/core/controller.py``.

Periodic routing reconfiguration every ``routing_interval``, topology
reconfiguration every ``topology_interval``, both computed from a sliding
``aggregation_window`` of recent TMs abstracted into ``k`` critical TMs.  The
first aggregation window is warm-up; topologies are physically realized
(rounded, paper Algorithm 1) before they are scored.

Two engines run on the device.  ``engine="batched"`` (the default) is the
plan → batch-execute engine (:mod:`repro_torch.core.engine`): batched PDHG
routing solves and one launch each of the epoch-batched linkload and
queueloss CUDA kernels per sweep.  ``engine="sequential"`` walks the trace
epoch by epoch (:func:`run_controller` below): one routing solve and one
:func:`repro_torch.core.simulator.route_metrics` call — one launch each of
the single-block kernels — per epoch.

With ``ControllerConfig.transition`` set (a
:class:`repro_torch.transition.TransitionConfig`), topology updates stop being
instantaneous and free: each one is diffed onto patch panels (§A, Thm. 4),
executed as a scheduled sequence of panel drain stages whose residual
capacities the first intervals of the topology epoch are scored under (one
more batch of the epoch-batched kernels), and gated by the §4.6
benefit-vs-disruption :func:`repro_torch.transition.should_reconfigure` rule
(skipped updates count in ``ControllerResult.n_skipped_topology``).  Unset
(the default), controller output is bit-identical to the instantaneous
behavior.

With ``ControllerConfig.failures`` set (a
:class:`repro_torch.failures.FailureConfig`), the sweep's scored plan is
additionally evaluated under sampled failure contingencies
(:func:`repro_torch.failures.evaluate_plan`: one launch of the fleet kernels
over (scenario × block) rows), the summary gains ``cont_*`` keys and
``ControllerResult.contingency`` its report; with ``contingency_weight`` set
the transition gate blends in the worst-contingency benefit and disruption.
Unset, the output is bit-identical to the controller without the subsystem.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.burst import LossConfig
from repro_torch.core import clustering
from repro_torch.core.graph import Fabric, uniform_topology
from repro_torch.core.paths import build_paths, routing_weight_matrix
from repro_torch.core.rounding import realize
from repro_torch.core.simulator import IntervalMetrics, route_metrics, summarize
from repro_torch.core.solver import GeminiSolution, SolverConfig, Strategy, solve
from repro_torch.core.traffic import Trace
from repro_torch.device import resolve_device
from repro_torch.failures.config import FailureConfig
from repro_torch.transition.config import TransitionConfig

__all__ = ["ControllerConfig", "ControllerResult", "run_controller"]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """The reference's ``ControllerConfig`` fields, with the port's backends.

    ``backend`` is ``"torch"`` (scoring on the CUDA kernels) or ``"numpy"``
    (the float64 oracle); ``solver_backend`` is ``"pdhg"`` (batched PDHG on
    the device) or ``"scipy"`` (HiGHS on the host).  ``kmeans_dtype`` is the
    float type of the critical-TM k-means: the reference runs it in JAX's
    default type, ``"float32"`` unless JAX's x64 mode is on.
    """

    routing_interval_hours: float = 0.25  # paper default: 15 minutes
    topology_interval_days: float = 1.0  # paper default: 1 day
    aggregation_days: float = 7.0  # paper default: one week
    k_critical: int = 12
    realize_topology: bool = True
    overload_threshold: float = 0.8
    backend: str = "torch"  # metrics backend: torch | numpy
    # burst-level loss tracking; None = off.  The loss seed is shared across
    # strategies, so comparisons are paired under identical burst realizations.
    loss: LossConfig | None = None
    engine: str = "batched"  # batched | sequential
    solver_backend: str = "pdhg"  # routing-only solves: pdhg | scipy
    pdhg_max_iters: int = 3000  # PDHG iteration cap per stage
    pdhg_tol: float = 1e-2  # PDHG certified-gap / objective-stall tolerance
    # PDHG arithmetic: "f32" (exact) or "bf16" — the hot loop's load
    # operator and its adjoint take bf16 operands with f32 accumulation;
    # projections, step sizes and the duality-gap certificate stay f32
    solver_precision: str = "f32"
    # reconfiguration-transition modeling (repro_torch.transition): None (the
    # default) keeps topology updates instantaneous and free, bit-identical
    # to the controller without transitions
    transition: TransitionConfig | None = None
    # contingency analysis (repro_torch.failures): None (the default) skips
    # it — output bit-identical to the controller without it
    failures: FailureConfig | None = None
    kmeans_dtype: str = "float32"

    def __post_init__(self):
        if self.transition is not None and not self.realize_topology:
            # panel decomposition (Thm. 4) needs integer, even-degree topologies
            raise ValueError(
                "ControllerConfig.transition requires realize_topology")
        if self.engine not in ("batched", "sequential"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.solver_precision not in ("f32", "bf16"):
            raise ValueError(
                f"unknown solver_precision {self.solver_precision!r}")
        if self.backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.solver_backend not in ("pdhg", "scipy"):
            raise ValueError(f"unknown solver_backend {self.solver_backend!r}")
        if self.kmeans_dtype not in ("float32", "float64"):
            raise ValueError(f"unknown kmeans_dtype {self.kmeans_dtype!r}")


@dataclasses.dataclass
class ControllerResult:
    strategy: Strategy
    metrics: IntervalMetrics
    summary: dict
    n_routing_updates: int
    n_topology_updates: int
    final_topology: np.ndarray  # integer trunks if realized
    transit_fraction: float
    solver_seconds: float
    # topology updates vetoed by the §4.6 benefit-vs-disruption rule
    n_skipped_topology: int = 0
    # one dict per evaluated transition (see TransitionEval.log_entry)
    transition_log: tuple = ()
    # wall-time breakdown by controller phase: plan / anchor / solve / score
    # / transition ("anchor" is the anchor-solve share of "solve",
    # "transition", the gate's evaluation, part of "plan"); each phase ends
    # in a host read of its results, so device work is inside its time
    stage_times: dict = dataclasses.field(default_factory=dict)
    # repro_torch.obs.SolverStats (per-epoch PDHG iterations / certified
    # gaps / restarts); None on the scipy backend
    solver_stats: object = None
    # repro_torch.failures.ContingencyReport (per-scenario worst/mean MLU
    # and loss under the sampled failure set); None unless cc.failures
    contingency: object = None
    # what the sweep scored, per routing epoch: path splits (B, P) and
    # realized directed capacities (B, E) — enough to re-score it outside
    # drain stages, which score under their own TransitionEval — and the
    # stage-1 MLU bound u* (B,) each routing solve certified
    splits: np.ndarray | None = None
    capacities: np.ndarray | None = None
    u_star: np.ndarray | None = None


def _window(trace: Trace, end: int, n: int) -> np.ndarray:
    return trace.demand[max(0, end - n): end]


def run_controller(
    fabric: Fabric,
    trace: Trace,
    strategy: Strategy,
    cc: ControllerConfig | None = None,
    sc: SolverConfig | None = None,
    device=None,
) -> ControllerResult:
    """Run the controller over ``trace`` and score it.

    ``device=None`` means the CUDA device; without a card the call raises
    ``RuntimeError`` unless the caller passes ``device="cpu"``.
    ``cc.engine`` picks the batched engine or the sequential walk; both give
    the reference's fields and semantics.
    """
    dev = resolve_device(device)
    cc = cc or ControllerConfig()
    sc = sc or SolverConfig()
    if cc.engine == "batched":
        from repro_torch.core.engine import run_controller_batched

        return run_controller_batched(fabric, trace, strategy, cc, sc,
                                      device=dev)
    paths = build_paths(fabric.n_pods)
    kmeans_dtype = getattr(torch, cc.kmeans_dtype)
    ipd = trace.intervals_per_day()
    agg = max(1, int(round(cc.aggregation_days * ipd)))
    route_step = max(1, int(round(cc.routing_interval_hours * ipd / 24.0)))
    topo_step = max(route_step, int(round(cc.topology_interval_days * ipd)))
    if trace.n_intervals <= agg:
        raise ValueError("trace shorter than the aggregation window")

    metrics = IntervalMetrics.empty()
    n_routing, n_topology, solver_s = 0, 0, 0.0
    n_skipped, transition_log = 0, []
    transit_mass, transit_n = 0.0, 0
    tc = cc.transition
    phases = obs.PhaseTimes()
    pdhg_raws: list = []
    n_fallbacks = 0
    f_epochs, cap_epochs, u_epochs = [], [], []
    # scoring inputs kept for the contingency evaluation after the walk (in
    # the block order of the batched engine's plan_score_blocks)
    c_blocks, c_w, c_caps, c_seeds, c_tms, c_deltas = [], [], [], [], [], []

    sol: GeminiSolution | None = None
    n_realized: np.ndarray | None = None
    cap: np.ndarray | None = None
    next_topo = agg  # reconfigure topology at warm-up end, then every topo_step

    fixed = Strategy(nonuniform=False, hedging=strategy.hedging)
    for start in range(agg, trace.n_intervals, route_step):
        with phases("plan"):
            window = _window(trace, start, agg)
            tms = clustering.critical_tms(window, k=cc.k_critical,
                                          seed=n_routing, dtype=kmeans_dtype,
                                          device=dev)
        staged = None  # TransitionEval whose drain stages score this epoch
        if strategy.nonuniform and (sol is None or start >= next_topo):
            with phases("plan"):
                # full joint solve: new topology + routing
                sol = solve(fabric, tms, strategy, sc, window_demand=window)
                solver_s += sol.solve_seconds
                cand = (realize(fabric, sol.n_e)[0]
                        if cc.realize_topology else sol.n_e)
                cand_cap = fabric.capacities(cand)
            apply = True
            if tc is not None and n_realized is not None:
                apply, staged, ev, ev_s = _transition_gate(
                    fabric, tms, n_realized, cand, tc, cc, sc,
                    delta=sol.delta, hedging=strategy.hedging,
                    horizon_intervals=topo_step, device=dev)
                solver_s += ev_s
                phases.add("transition", ev_s)
                phases.add("plan", ev_s)  # transition ⊆ plan (shared schema)
                if ev is not None:
                    transition_log.append(ev.log_entry(start, apply))
            if apply:
                n_realized, cap = cand, cand_cap
                n_topology += 1
            else:
                n_skipped += 1
            _count_topology_update(fabric, start, apply)
            next_topo = start + topo_step
        elif cap is None:
            # uniform strategies: fix the (realized) uniform topology once
            n0 = uniform_topology(fabric)
            n_realized = realize(fabric, n0)[0] if cc.realize_topology else n0
            cap = fabric.capacities(n_realized)
        # routing must target the *realized* (integer) capacities
        with phases("solve"):
            sol = _solve_routing_only(fabric, tms, fixed, sc, window, cap, cc,
                                      device=dev)
        solver_s += sol.solve_seconds
        if sol.pdhg_stats is not None:
            pdhg_raws.append(sol.pdhg_stats)
            phases.add("anchor", sol.pdhg_stats.get("anchor_seconds", 0.0))
            n_fallbacks += int(sol.pdhg_stats.get("n_fallbacks", 0))
        n_routing += 1
        transit_mass += sol.transit_fraction(paths)
        transit_n += 1
        f_epochs.append(sol.f)
        cap_epochs.append(cap)
        u_epochs.append(sol.u_star)

        with phases("score"):
            w = routing_weight_matrix(paths, sol.f)
            block = trace.demand[start: start + route_step]
            obs.quality.record_epoch_quality(fabric.name, tms, block)
            # the burst seed is a pure function of (cc.loss.seed, start), so
            # strategies walking the same starts stay paired
            rem_lo, rem_seed = 0, (cc.loss.seed + start if cc.loss is not None
                                   else None)
            if staged is not None:
                stage_m, spans, seeds, rem_lo, rem_seed = _score_stages(
                    block, staged, cc, trace, start, device=dev)
                metrics = metrics.concat(stage_m)
                if cc.failures is not None:
                    for s, (k, lo, hi) in enumerate(spans):
                        c_blocks.append(block[lo:hi])
                        c_w.append(staged.stage_w[k])
                        c_caps.append(staged.stage_caps[k])
                        c_seeds.append(seeds[s] if seeds is not None else 0)
                        c_tms.append(tms)
                        c_deltas.append(sol.delta)
            loss_cfg = (dataclasses.replace(cc.loss, seed=rem_seed)
                        if cc.loss is not None else None)
            if block.shape[0] - rem_lo > 0:
                metrics = metrics.concat(route_metrics(
                    block[rem_lo:], w, cap, cc.overload_threshold,
                    backend=cc.backend, loss_cfg=loss_cfg,
                    interval_seconds=trace.interval_minutes * 60.0,
                    device=dev))
                if cc.failures is not None:
                    c_blocks.append(block[rem_lo:])
                    c_w.append(w)
                    c_caps.append(cap)
                    c_seeds.append(rem_seed if rem_seed is not None else 0)
                    c_tms.append(tms)
                    c_deltas.append(sol.delta)

    summary = summarize(metrics)
    contingency = None
    if cc.failures is not None and c_blocks:
        from repro_torch.core.engine import _pad_tms
        from repro_torch.failures import evaluate_plan

        with phases("failures"):
            contingency = evaluate_plan(
                fabric, cc, sc, c_blocks, np.stack(c_w), np.stack(c_caps),
                c_seeds if cc.loss is not None else None,
                trace.interval_minutes * 60.0,
                tms_blocks=(np.stack([_pad_tms(np.asarray(t, float),
                                               cc.k_critical)
                                      for t in c_tms])
                            if cc.failures.resolve else None),
                deltas=(np.asarray(c_deltas)
                        if cc.failures.resolve else None),
                device=dev)
            summary.update(contingency.summary_update())

    obs.quality.record_interval_metrics(fabric.name, metrics)
    solver_stats = None
    if pdhg_raws:
        solver_stats = obs.SolverStats.from_pdhg(
            pdhg_raws, cc.pdhg_max_iters, cc.pdhg_tol,
            n_fallbacks=n_fallbacks)
    return ControllerResult(
        strategy=strategy,
        metrics=metrics,
        summary=summary,
        n_routing_updates=n_routing,
        n_topology_updates=n_topology,
        final_topology=np.asarray(n_realized),
        transit_fraction=transit_mass / max(transit_n, 1),
        solver_seconds=solver_s,
        n_skipped_topology=n_skipped,
        transition_log=tuple(transition_log),
        stage_times=phases.times,
        solver_stats=solver_stats,
        contingency=contingency,
        splits=np.stack(f_epochs),
        capacities=np.stack(cap_epochs),
        u_star=np.asarray(u_epochs, np.float64),
    )


def _count_topology_update(fabric, start: int, applied: bool) -> None:
    """The trace event and the metrics counter of one topology update,
    applied or vetoed by the gate (every engine records them alike)."""
    outcome = "applied" if applied else "skipped"
    obs.event(f"controller.topology_{outcome}", start=start, fabric=fabric.name)
    obs.metrics.inc("controller.topology_updates", fabric=fabric.name,
                    outcome=outcome)


def _transition_gate(fabric, tms, n_old, n_new, tc, cc, sc, *,
                     delta, hedging, horizon_intervals, device=None):
    """Evaluate a topology change and decide whether to apply it.

    The single gating implementation shared by the sequential walk, the
    batched engine and the streaming controller (their decision semantics
    must never drift — parity is test-enforced).  The evaluation's routing
    re-solves run as one PDHG batch on ``device``.  Returns ``(apply,
    staged, ev, seconds)``: the decision, the :class:`TransitionEval` whose
    drain stages the epoch scores under (None when skipping or modeling
    instantaneously), the evaluation for transition-log bookkeeping (None
    when the change needs no jumper moves and is applied for free), and the
    evaluation wall-clock (ending in a host read of the solves).
    """
    from repro_torch.transition import evaluate_transition, should_reconfigure

    with obs.timed("transition.evaluate") as t:
        ev = evaluate_transition(fabric, tms, n_old, n_new, tc, cc, sc,
                                 delta=delta, hedging=hedging,
                                 horizon_intervals=horizon_intervals,
                                 device=device)
    if ev is None:
        return True, None, None, t.seconds
    if tc.decide:
        fcfg = cc.failures
        if fcfg is not None and fcfg.contingency_weight is not None:
            # failure-aware gate: blend in the worst-contingency benefit /
            # disruption pair (fixed-routing re-scores under sampled masks)
            from repro_torch.failures import transition_worst_case

            b_w, d_w = transition_worst_case(fabric, tms, ev, fcfg)
            apply = should_reconfigure(
                ev.benefit, ev.disruption, tc.hysteresis,
                contingency_weight=fcfg.contingency_weight,
                benefit_worst=b_w, disruption_worst=d_w, fabric=fabric.name)
        else:
            apply = should_reconfigure(ev.benefit, ev.disruption,
                                       tc.hysteresis, fabric=fabric.name)
    else:
        apply = True
    staged = ev if apply and not tc.instantaneous else None
    if staged is not None:
        obs.event("transition.staged", n_stages=ev.n_stages,
                  moves=ev.diff.total_moves)
    return apply, staged, ev, t.seconds


def _score_stages(block, ev, cc, trace, start, device=None):
    """Score a topology epoch's leading drain stages in one batched call.

    The stages map onto the leading batch axis of
    :func:`repro_torch.core.simulator.route_metrics_batched` (one launch each
    of the epoch-batched linkload and queueloss kernels on ``device``); span
    and burst-seed arithmetic comes from the engine-shared
    :func:`repro_torch.transition.stage_partition`.  Returns ``(metrics,
    spans, seeds, rem_lo, rem_seed)``: the concatenated staged metrics, the
    scored stage spans and their burst seeds (the contingency collector
    replays them), the offset at which the steady new topology takes over,
    and its burst seed.
    """
    from repro_torch.core.simulator import route_metrics_batched
    from repro_torch.transition import stage_partition

    spans, seeds, rem_lo, rem_seed = stage_partition(
        ev, block.shape[0], start,
        cc.loss.seed if cc.loss is not None else None)
    idx = [k for k, _, _ in spans]
    stage_m = route_metrics_batched(
        [block[lo:hi] for _, lo, hi in spans],
        ev.stage_w[idx], ev.stage_caps[idx], cc.overload_threshold,
        backend=cc.backend, loss_cfg=cc.loss, loss_seeds=seeds,
        interval_seconds=trace.interval_minutes * 60.0, device=device)
    return stage_m, spans, seeds, rem_lo, rem_seed


def _solve_routing_only(fabric, tms, strategy, sc, window, capacities,
                        cc: ControllerConfig, device=None) -> GeminiSolution:
    """Fixed-capacity routing re-solve (stages 1 → [2] → 3 with C given).

    ``cc.solver_backend`` selects PDHG on ``device`` (the batched solver at
    B = 1, as the reference's sequential walk runs it) or scipy/HiGHS.
    """
    from repro_torch.core.engine import (_pad_tms, _solve_routing_scipy,
                                         pdhg_finite_fallback,
                                         routing_solver_for)
    from repro_torch.core.lp import estimate_delta

    pdhg_stats = None
    with obs.timed("controller.solve_routing",
                   backend=cc.solver_backend) as t:
        delta = 0.0
        if strategy.hedging:
            delta = (sc.delta if sc.delta is not None
                     else estimate_delta(window, sc.delta_quantile))
        if cc.solver_backend == "pdhg":
            solver = routing_solver_for(fabric, cc.k_critical,
                                        cc.pdhg_max_iters, cc.pdhg_tol,
                                        cc.solver_precision, device=device)
            caps = np.asarray(capacities, float)[None]
            out = solver.solve_routing_batch(
                _pad_tms(np.asarray(tms, float), cc.k_critical)[None], caps,
                hedging=strategy.hedging, deltas=np.asarray([delta]),
                skip_stage3=sc.skip_stage3)
            f_g, u_g, n_fb = pdhg_finite_fallback(
                fabric, [tms], caps, np.asarray([delta]), sc, out["f"],
                out["u_star"])
            f, u_star = f_g[0], float(u_g[0])
            r_star = (None if out["r_star"] is None
                      or not np.isfinite(out["r_star"][0])
                      else float(out["r_star"][0]))
            pdhg_stats = dict(out["stats"])
            if n_fb:
                pdhg_stats["n_fallbacks"] = n_fb
        else:
            f, u_star, r_star = _solve_routing_scipy(fabric, tms, sc,
                                                     capacities, delta)
    return GeminiSolution(
        strategy=strategy, fabric=fabric, n_e=np.zeros(fabric.n_trunks), f=f,
        u_star=u_star, r_star=r_star, delta=delta,
        solve_seconds=t.seconds, pdhg_stats=pdhg_stats)
