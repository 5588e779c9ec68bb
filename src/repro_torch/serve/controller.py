"""Long-lived streaming controller: §4.6 as an online service — the
counterpart of ``repro/serve/controller.py``, on the device.

The offline engines (:mod:`repro_torch.core.controller`,
:mod:`repro_torch.core.engine`) see a whole trace up front, plan every epoch,
and batch the solves.  A deployed controller cannot: intervals arrive one at
a time, and the metric that matters is *reaction latency* — the time from a
demand shift landing in the measurement stream to new routing weights being
installed.

:class:`StreamingController` is the same control loop restructured around a
stream:

* every ingested interval is buffered and pushed into the
  O(C)-per-interval :class:`~repro_torch.serve.window.RollingWindow`; a
  finished epoch's intervals are scored under the weights that served them
  (one launch each of the single-block linkload and queueloss kernels);
* at each routing-epoch boundary it re-plans — critical TMs from the window
  (k-means on the device), the joint topology solve when one is due, gated
  by :func:`repro_torch.transition.should_reconfigure` when
  ``ControllerConfig.transition`` is set, then a routing-only PDHG solve on
  the device **warm-started from the previous epoch's primal/dual iterates**
  (:meth:`repro_torch.core.pdhg.TorchRoutingSolver.solve_routing_warm`);
* per-epoch *time-to-new-weights* is measured (TM arrival → installed weight
  matrix, the splits read back to the host, so device work is inside it) and
  exported through :mod:`repro_torch.obs` as ``serve.*`` spans plus a
  ``serve.time_to_new_weights_s`` histogram.  Scoring the finished epoch
  runs before the clock starts.

Replay parity is the correctness contract (test-enforced against the
reference): run over a recorded trace, the streaming walk makes the same
epoch boundaries, topology updates and routing solves as the offline
engines — identical on the scipy backend, within solver tolerance on PDHG —
the same topology-update decisions included.  A staged epoch's drain stages
score in one launch each of the epoch-batched kernels, the rest of the epoch
on the single-block kernels.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

import torch

from repro_torch import obs
from repro_torch.core import clustering
from repro_torch.core.engine import (_pad_tms, _solve_routing_scipy,
                                     pdhg_finite_fallback, routing_solver_for,
                                     transit_fraction_of)
from repro_torch.core.graph import Fabric, uniform_topology
from repro_torch.core.lp import estimate_delta
from repro_torch.core.paths import build_paths, routing_weight_matrix
from repro_torch.core.rounding import realize
from repro_torch.core.simulator import IntervalMetrics, route_metrics, summarize
from repro_torch.core.solver import SolverConfig, Strategy, solve
from repro_torch.device import resolve_device
from repro_torch.serve.stream import TMStream
from repro_torch.serve.window import RollingWindow

__all__ = ["ServeConfig", "Decision", "ServeResult", "StreamingController"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Online-mode knobs layered over :class:`ControllerConfig`."""

    # seed each epoch's PDHG from the previous epoch's converged iterates;
    # False = cold-start every epoch (the ablation the serve bench measures)
    warm_start: bool = True
    # pick the strategy from the warm-up window via the §4.6 predictor
    # (repro_torch.core.predictor.predict_from_window) when the controller is
    # constructed without an explicit strategy
    auto_strategy: bool = True
    # advisory p99 target for time-to-new-weights, recorded into the result
    # (the serve.latency_slo_burn gauge reports the share above it)
    latency_slo_s: float | None = None


@dataclasses.dataclass(frozen=True)
class Decision:
    """One routing-epoch decision the controller emitted."""

    epoch: int  # routing-update index
    start: int  # first interval the new weights apply to
    topology_solved: bool  # a joint topology re-solve ran this epoch
    topology_applied: bool  # ... and its candidate was installed
    u_star: float  # certified stage-1 MLU bound of the routing solve
    latency_s: float  # time-to-new-weights for this epoch


@dataclasses.dataclass
class ServeResult:
    """Streaming-run output: the offline-schema result + latency telemetry."""

    result: object  # repro_torch.core.controller.ControllerResult
    decisions: tuple  # tuple[Decision]
    latencies_s: np.ndarray  # per-epoch time-to-new-weights
    n_intervals: int  # intervals ingested (warm-up included)
    wall_s: float  # ingest-loop wall clock
    latency_slo_s: float | None = None

    @property
    def intervals_per_s(self) -> float:
        return self.n_intervals / max(self.wall_s, 1e-9)

    def latency_quantiles(self) -> dict:
        """p50/p99/max time-to-new-weights (the SLO surface)."""
        lat = np.asarray(self.latencies_s)
        if not lat.size:
            return {"p50_s": float("nan"), "p99_s": float("nan"),
                    "max_s": float("nan")}
        return {"p50_s": float(np.percentile(lat, 50)),
                "p99_s": float(np.percentile(lat, 99)),
                "max_s": float(lat.max())}


class StreamingController:
    """Consume a :class:`TMStream`, emit decisions, keep offline parity.

    ``device=None`` means the CUDA device (raising without a card); the CPU
    runs only when the caller passes ``device="cpu"``.
    """

    def __init__(self, fabric: Fabric, stream: TMStream,
                 strategy: Strategy | None = None, cc=None,
                 sc: SolverConfig | None = None,
                 serve: ServeConfig | None = None, device=None):
        from repro_torch.core.controller import ControllerConfig

        self.device = resolve_device(device)
        self.fabric = fabric
        self.stream = stream
        self.cc = cc or ControllerConfig()
        self.sc = sc or SolverConfig()
        self.serve = serve or ServeConfig()
        self._kmeans_dtype = getattr(torch, self.cc.kmeans_dtype)
        if stream.n_pods != fabric.n_pods:
            raise ValueError("stream/fabric pod counts differ")
        if self.cc.failures is not None:
            raise ValueError("contingency analysis (ControllerConfig.failures)"
                             " is offline-only; unset it for streaming")
        if strategy is None and not self.serve.auto_strategy:
            raise ValueError("pass a strategy or enable serve.auto_strategy")
        self.strategy = strategy

        ipd = stream.intervals_per_day()
        self.agg = max(1, int(round(self.cc.aggregation_days * ipd)))
        self.route_step = max(1, int(round(
            self.cc.routing_interval_hours * ipd / 24.0)))
        self.topo_step = max(self.route_step,
                             int(round(self.cc.topology_interval_days * ipd)))
        self.window = RollingWindow(self.agg, stream.n_commodities)

        self.paths = build_paths(fabric.n_pods)
        # mutable sweep state (mirrors the offline walks field-for-field)
        self._t = 0  # next interval index to ingest
        self._epoch = 0  # routing-update counter (critical-TM kmeans seed)
        self._next_topo = self.agg
        self._first_epoch = True
        self._n_topology = 0
        self._n_skipped = 0
        self._transition_log: list = []
        self._n_realized: np.ndarray | None = None
        self._cap: np.ndarray | None = None
        self._w: np.ndarray | None = None
        self._warm_state = None  # RoutingWarmState carried epoch -> epoch
        self._f_epochs: list = []  # per-epoch splits (transit fraction)
        self._cap_epochs: list = []  # per-epoch capacities the splits target
        self._staged = None  # TransitionEval draining the current epoch
        self._tms_prev = None  # critical TMs of the epoch being scored
        self._block: list = []  # current epoch's scored-interval buffer
        self._block_start = 0
        self._metrics = IntervalMetrics.empty()
        self._decisions: list = []
        self._latencies: list = []
        self._solver_s = 0.0
        self._pdhg_raws: list = []
        self._n_fallbacks = 0
        self._phases = obs.PhaseTimes()

    # ---- ingest --------------------------------------------------------------

    def ingest(self, row: np.ndarray) -> Decision | None:
        """Feed one TM interval; returns the epoch decision when this interval
        opened a routing epoch (None otherwise — warm-up or mid-epoch)."""
        t = self._t
        decision = None
        with obs.span("serve.interval", t=t):
            if t >= self.agg and (t - self.agg) % self.route_step == 0:
                decision = self._replan(start=t)
            if t >= self.agg:
                self._block.append(np.asarray(row, np.float64))
            self.window.push(row)
        self._t = t + 1
        if decision is not None:
            self._decisions.append(decision)
        return decision

    def run(self, max_intervals: int | None = None) -> ServeResult:
        """Drain the stream (or ``max_intervals`` of it) and summarize."""
        t0 = time.perf_counter()
        for i, row in enumerate(self.stream):
            self.ingest(row)
            if max_intervals is not None and i + 1 >= max_intervals:
                break
        wall = time.perf_counter() - t0
        return self._finalize(wall)

    # ---- re-plan (the decision hot path) -------------------------------------

    def _replan(self, start: int) -> Decision:
        self._score_block()  # close the finished epoch before re-planning
        t_arrival = time.perf_counter()
        with obs.span("serve.replan", start=start, epoch=self._epoch):
            with self._phases("plan", "serve.plan"):
                window = self.window.view()
                if self.strategy is None:  # warm-up ended: pick the strategy
                    self._pick_strategy(window)
                tms = clustering.critical_tms(window, k=self.cc.k_critical,
                                              seed=self._epoch,
                                              dtype=self._kmeans_dtype,
                                              device=self.device)
                self._tms_prev = tms  # quality scoring pairs tms with block
                delta = 0.0
                if self.strategy.hedging:
                    delta = (self.sc.delta if self.sc.delta is not None
                             else estimate_delta(window,
                                                 self.sc.delta_quantile))
                topo_solved, topo_applied = self._maybe_topology(
                    start, window, tms, delta)
            with self._phases("solve", "serve.solve"):
                u_star = self._solve_routing(tms, delta)
        latency = time.perf_counter() - t_arrival
        self._latencies.append(latency)
        obs.metrics.observe("serve.time_to_new_weights_s", latency,
                            fabric=self.fabric.name)
        obs.metrics.inc("serve.decisions", fabric=self.fabric.name,
                        topology="applied" if topo_applied else
                        ("solved" if topo_solved else "routing_only"))
        obs.event("serve.decision", start=start, epoch=self._epoch,
                  latency_s=latency, topology_applied=topo_applied)
        decision = Decision(epoch=self._epoch, start=start,
                            topology_solved=topo_solved,
                            topology_applied=topo_applied,
                            u_star=u_star, latency_s=latency)
        self._epoch += 1
        self._block_start = start
        return decision

    def _pick_strategy(self, window: np.ndarray) -> None:
        from repro_torch.core.predictor import predict_from_window

        pred = predict_from_window(self.fabric, window,
                                   self.stream.interval_minutes,
                                   self.cc, self.sc, device=self.device)
        self.strategy = pred.strategy
        obs.event("serve.strategy_choice", fabric=self.fabric.name,
                  strategy=self.strategy.name)

    def _maybe_topology(self, start, window, tms, delta):
        """Joint topology solve when one is due, and the §4.6 gate; mirrors
        the offline plan walk.  Returns (solved, installed)."""
        from repro_torch.core.controller import (_count_topology_update,
                                                 _transition_gate)

        cc, sc, tc = self.cc, self.sc, self.cc.transition
        self._staged = None
        if self.strategy.nonuniform and (self._first_epoch
                                         or start >= self._next_topo):
            sol = solve(self.fabric, tms, self.strategy, sc,
                        window_demand=window)
            self._solver_s += sol.solve_seconds
            cand = (realize(self.fabric, sol.n_e)[0]
                    if cc.realize_topology else sol.n_e)
            apply = True
            if tc is not None and self._n_realized is not None:
                apply, staged, ev, ev_s = _transition_gate(
                    self.fabric, tms, self._n_realized, cand, tc, cc, sc,
                    delta=delta, hedging=self.strategy.hedging,
                    horizon_intervals=self.topo_step, device=self.device)
                self._solver_s += ev_s
                self._phases.add("transition", ev_s)
                self._staged = staged
                if ev is not None:
                    self._transition_log.append(ev.log_entry(start, apply))
            if apply:
                self._n_realized = cand
                self._cap = self.fabric.capacities(cand)
                self._n_topology += 1
            else:
                self._n_skipped += 1
            _count_topology_update(self.fabric, start, apply)
            self._next_topo = start + self.topo_step
            self._first_epoch = False
            return True, apply
        if self._cap is None:  # uniform strategies: realize uniform once
            n0 = uniform_topology(self.fabric)
            self._n_realized = (realize(self.fabric, n0)[0]
                                if cc.realize_topology else n0)
            self._cap = self.fabric.capacities(self._n_realized)
        self._first_epoch = False
        return False, False

    def _solve_routing(self, tms, delta) -> float:
        """Routing-only re-solve on the installed capacities; installs the
        new weight matrix (the moment time-to-new-weights clocks)."""
        cc, sc = self.cc, self.sc
        hedging = self.strategy.hedging
        if cc.solver_backend == "pdhg":
            solver = routing_solver_for(self.fabric, cc.k_critical,
                                        cc.pdhg_max_iters, cc.pdhg_tol,
                                        cc.solver_precision,
                                        device=self.device)
            out, state = solver.solve_routing_warm(
                _pad_tms(np.asarray(tms, float), cc.k_critical),
                np.asarray(self._cap, float), hedging=hedging, delta=delta,
                skip_stage3=sc.skip_stage3,
                anchor_state=self._warm_state if self.serve.warm_start
                else None)
            self._warm_state = state
            f_b, u_b, n_fb = pdhg_finite_fallback(
                self.fabric, [tms], np.asarray(self._cap, float)[None],
                np.asarray([delta]), sc, out["f"][None],
                np.asarray([out["u_star"]]))
            f, u_star = f_b[0], float(u_b[0])
            self._n_fallbacks += n_fb
            if n_fb:  # the carried iterates diverged — don't reuse them
                self._warm_state = None
            self._pdhg_raws.append(out["stats"])
        elif cc.solver_backend == "scipy":
            f, u_star, _ = _solve_routing_scipy(self.fabric, tms, sc,
                                                self._cap, delta)
        else:
            raise ValueError(f"unknown solver_backend {cc.solver_backend!r}")
        self._f_epochs.append(f)
        self._cap_epochs.append(self._cap)
        self._w = routing_weight_matrix(self.paths, f)
        return u_star

    # ---- scoring -------------------------------------------------------------

    def _score_block(self) -> None:
        """Score the just-finished epoch's buffered intervals under the
        weights that served them (drain stages included) — the offline
        walks' arithmetic, deferred off the decision path."""
        if not self._block:
            return
        cc = self.cc
        block = np.stack(self._block)
        start = self._block_start
        self._block = []
        with self._phases("score", "serve.score"):
            if self._tms_prev is not None:
                obs.quality.record_epoch_quality(self.fabric.name,
                                                 self._tms_prev, block)
            # the burst seed is a pure function of (cc.loss.seed, start), as
            # in the offline walks, so comparisons stay paired
            rem_lo, rem_seed = 0, (cc.loss.seed + start
                                   if cc.loss is not None else None)
            if self._staged is not None:
                from repro_torch.core.controller import _score_stages

                stage_m, _, _, rem_lo, rem_seed = _score_stages(
                    block, self._staged, cc, self.stream, start,
                    device=self.device)
                self._metrics = self._metrics.concat(stage_m)
                self._staged = None
            if block.shape[0] - rem_lo > 0:
                loss_cfg = (dataclasses.replace(cc.loss, seed=rem_seed)
                            if cc.loss is not None else None)
                self._metrics = self._metrics.concat(route_metrics(
                    block[rem_lo:], self._w, self._cap, cc.overload_threshold,
                    backend=cc.backend, loss_cfg=loss_cfg,
                    interval_seconds=self.stream.interval_minutes * 60.0,
                    device=self.device))

    # ---- finalize ------------------------------------------------------------

    def _finalize(self, wall_s: float) -> ServeResult:
        from repro_torch.core.controller import ControllerResult

        self._score_block()  # trailing partial epoch
        solver_stats = None
        if self._pdhg_raws:
            solver_stats = obs.SolverStats.from_pdhg(
                self._pdhg_raws, self.cc.pdhg_max_iters, self.cc.pdhg_tol,
                n_fallbacks=self._n_fallbacks)
        self._solver_s += self._phases.times.get("solve", 0.0)
        if obs.metrics.enabled() and self._metrics.mlu.size:
            obs.quality.record_interval_metrics(self.fabric.name,
                                                self._metrics)
        f_b = np.stack(self._f_epochs) if self._f_epochs else np.zeros(
            (0, self.paths.n_paths))
        result = ControllerResult(
            strategy=self.strategy,
            metrics=self._metrics,
            summary=summarize(self._metrics),
            n_routing_updates=self._epoch,
            n_topology_updates=self._n_topology,
            final_topology=np.asarray(self._n_realized)
            if self._n_realized is not None else np.zeros(0),
            transit_fraction=(transit_fraction_of(self.paths, f_b)
                              if len(f_b) else 0.0),
            solver_seconds=self._solver_s,
            n_skipped_topology=self._n_skipped,
            transition_log=tuple(self._transition_log),
            stage_times=self._phases.times,
            solver_stats=solver_stats,
            splits=f_b,
            capacities=(np.stack(self._cap_epochs) if self._cap_epochs
                        else None),
            u_star=np.asarray([d.u_star for d in self._decisions], np.float64),
        )
        lat = np.asarray(self._latencies)
        if self.serve.latency_slo_s is not None and obs.metrics.enabled():
            burn = float((lat > self.serve.latency_slo_s).mean()) if lat.size \
                else 0.0
            obs.metrics.set_gauge("serve.latency_slo_burn", burn,
                                  fabric=self.fabric.name)
        return ServeResult(result=result, decisions=tuple(self._decisions),
                           latencies_s=lat, n_intervals=self._t,
                           wall_s=wall_s,
                           latency_slo_s=self.serve.latency_slo_s)
