"""Fleet-scale execution layer: a whole fleet sweep in a few device calls —
the counterpart of ``repro/core/fleet_engine.py``.

Gemini's headline results are fleet-level: tens of fabrics, each
re-optimized on rolling windows (paper §5).  :func:`run_fleet` runs every
job's controller sweep in three fleet-wide phases:

1. **Plan** — :func:`repro_torch.core.engine.plan_artifacts` per (fabric,
   trace, strategy) job: windows, critical TMs (k-means on the device), the
   rare joint topology solves (host scipy/HiGHS) and, with
   ``ControllerConfig.transition`` set, the §4.6 gate of each update.
2. **Bucket + solve** — jobs are bucketed by padded shape
   (:func:`repro_torch.core.fleet.fleet_bucket_key`: pods rounded up to a
   quantum, critical-TM count, PDHG settings, scoring config).  Within a
   bucket every job's epochs are zero-padded into one commodity layout
   (:func:`repro_torch.core.fleet.scatter_pad`) and flattened onto one batch
   axis; :meth:`repro_torch.core.pdhg.TorchRoutingSolver.solve_routing_fleet`
   solves all of them, warm-started from one anchor solve per fabric, with
   per-element pod masks keeping padded pods out of routing.
3. **Fused scoring** — every job's scoring blocks stack onto a leading
   fabric axis, and one :func:`repro_torch.core.simulator.route_metrics_fleet`
   call — one launch each of the fleet linkload and queueloss CUDA kernels —
   scores the whole bucket, drain stages (padded into the bucket's layout)
   included.
4. **Contingencies** (jobs with ``ControllerConfig.failures`` set) — the
   fixed-routing jobs of a bucket stay in its padded layout and every (job,
   scenario) pair becomes one more row of ONE
   :func:`repro_torch.failures.evaluate.contingency_metrics_jobs` call;
   re-solve jobs drop to their native layout and go through
   :func:`repro_torch.failures.evaluate_plan`.

Jobs whose ``solver_backend`` is not ``"pdhg"`` go through the per-fabric
:func:`repro_torch.core.engine.execute_plan`.  When more than one card is
visible (or a mesh is passed) the bucket's warm PDHG stages are dealt
round-robin over :func:`repro_torch.parallel.sharding.fleet_mesh`, one host
thread per card; the anchors and the scoring stay on the first card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import (execute_plan, pdhg_finite_fallback,
                                     plan_artifacts, plan_score_blocks,
                                     routing_solver_for, transit_fraction_of)
from repro_torch.core.fleet import (commodity_slots, fleet_bucket_key,
                                    scatter_pad)
from repro_torch.core.graph import Fabric
from repro_torch.core.paths import build_paths, routing_weight_matrices
from repro_torch.core.simulator import route_metrics_fleet, summarize
from repro_torch.core.solver import STRATEGIES, SolverConfig, Strategy
from repro_torch.core.traffic import Trace
from repro_torch.device import resolve_device

__all__ = ["FleetJob", "run_fleet", "predict_fleet"]


@dataclasses.dataclass(frozen=True)
class FleetJob:
    """One controller sweep: a fabric, its trace, and a strategy.

    ``cc``/``sc`` default to ``ControllerConfig()``/``SolverConfig()``;
    sweeps with different configs may coexist in one fleet (they bucket
    separately when their solve/scoring shapes differ).
    """

    fabric: Fabric
    trace: Trace
    strategy: Strategy
    cc: object = None
    sc: SolverConfig | None = None


def _resolve_mesh(mesh, dev: torch.device):
    """``None`` never shards; ``"auto"`` shards over :func:`fleet_mesh` when
    ``dev`` is CUDA and more than one card is visible; a mesh is used as
    given."""
    if mesh is not None and mesh != "auto" and getattr(mesh, "devices", None) is None:
        raise TypeError(f"run_fleet(mesh={mesh!r}): pass None, 'auto' or a mesh "
                        "of devices (repro_torch.parallel.sharding.fleet_mesh)")
    if mesh != "auto":
        return mesh  # None (unsharded) or an explicit Mesh
    if dev.type != "cuda" or torch.cuda.device_count() <= 1:
        return None
    from repro_torch.parallel.sharding import fleet_mesh

    return fleet_mesh()


def _bucket_fabric(vp: int) -> Fabric:
    """Template fabric hosting a bucket's shared solver (only its pod count
    matters — capacities are per-element solve inputs)."""
    return Fabric(name=f"bucket-V{vp}", radix=np.full(vp, 2),
                  speed=np.ones(vp))


def _native_splits(f_p: np.ndarray, n_pods: int, vp: int,
                   slots: np.ndarray) -> np.ndarray:
    """(B, P_vp) splits in the padded layout → (B, P_n) in the fabric's own.
    Padded pods carry no mass (the pod mask), and a native commodity's paths
    come first, in order, among its padded ones."""
    paths_n, paths_p = build_paths(n_pods), build_paths(vp)
    out = np.empty((f_p.shape[0], paths_n.n_paths), np.float64)
    out[:, paths_n.commodity_paths] = \
        f_p[:, paths_p.commodity_paths[slots][:, : n_pods - 1]]
    return out


def run_fleet(jobs, *, pod_quantum: int = 4, mesh="auto", device=None) -> list:
    """Run every job's controller sweep, batching routing solves and scoring
    fleet-wide per bucket, on ``device`` (``None`` = CUDA).

    Args:
      jobs: iterable of :class:`FleetJob` (or ``(fabric, trace, strategy)`` /
        ``(fabric, trace, strategy, cc, sc)`` tuples).
      pod_quantum: bucket quantum for :func:`repro_torch.core.fleet.pad_pods`
        — larger values mean fewer buckets but more V³ padding waste.
      mesh: ``"auto"`` (shard over :func:`fleet_mesh` when ``device`` is
        CUDA and more than one card is visible), ``None`` (never shard), or
        an explicit 1-D mesh (``fleet_mesh(devices)``; ``[dev] * D`` deals
        D shards on one card).  Each element's PDHG result is the unsharded
        call's.
      device: where the plan's k-means, the PDHG solves and the scoring run.

    Returns a list of :class:`~repro_torch.core.controller.ControllerResult`,
    one per job, in job order — the fields of
    :func:`repro_torch.core.controller.run_controller`, with ``splits`` in
    each fabric's own path layout.
    """
    from repro_torch.core.controller import ControllerConfig

    dev = resolve_device(device)
    mesh = _resolve_mesh(mesh, dev)
    resolved = []
    for j in jobs:
        if not isinstance(j, FleetJob):
            j = FleetJob(*j)
        cc = j.cc if j.cc is not None else ControllerConfig()
        sc = j.sc if j.sc is not None else SolverConfig()
        resolved.append((j, cc, sc))

    # ---- phase 1: per-fabric plan walks (sequential topology solves) --------
    arts = [plan_artifacts(j.fabric, j.trace, j.strategy, cc, sc, device=dev)
            for j, cc, sc in resolved]

    results: list = [None] * len(resolved)
    buckets: dict = {}
    for i, (j, cc, sc) in enumerate(resolved):
        if cc.solver_backend == "pdhg":
            key = fleet_bucket_key(j.fabric, cc, sc, j.trace, pod_quantum)
            buckets.setdefault(key, []).append(i)
        else:
            results[i] = execute_plan(j.fabric, j.trace, j.strategy, cc, sc,
                                      arts[i], device=dev)
    for key, idxs in buckets.items():
        _run_bucket(key, idxs, resolved, arts, results, dev, mesh)
    return results


def _run_bucket(key, idxs, resolved, arts, results, dev, mesh=None):
    """Phases 2–3 for one bucket: fleet-wide PDHG batch + fused scoring."""
    from repro_torch.core.controller import ControllerResult

    vp, m, max_iters, tol, skip_stage3 = key[:5]
    cp = vp * (vp - 1)
    # every job in the bucket shares the key, hence the precision
    precision = resolved[idxs[0]][1].solver_precision
    solver = routing_solver_for(_bucket_fabric(vp), m, max_iters, tol,
                                precision, device=dev)
    paths_p = build_paths(vp)

    # ---- phase 2: stack plan artifacts onto the flattened batch axis --------
    with obs.timed("fleet.solve", bucket_pods=vp, n_jobs=len(idxs)) as t_solve:
        tms_n, caps_n, valid_n, deltas_n = [], [], [], []
        anchor_elems, anchor_of, spans = [], [], []
        slots_of, caps_p_of = {}, {}  # per-job embeddings, reused by scoring
        hedging = False
        n = 0
        for i in idxs:
            j, cc, sc = resolved[i]
            art = arts[i]
            slots = commodity_slots(j.fabric.n_pods, vp)
            caps_p = scatter_pad(art.caps, slots, cp, axis=1)
            slots_of[i], caps_p_of[i] = slots, caps_p
            b = art.plan.n_routing
            tms_n.append(scatter_pad(art.tms_padded(m), slots, cp, axis=2))
            caps_n.append(caps_p)
            valid = solver.valid_for_pods(j.fabric.n_pods)
            valid_n.append(np.broadcast_to(valid, (b,) + valid.shape))
            deltas_n.append(art.deltas)
            anchor_of.extend([len(anchor_elems)] * b)
            anchor_elems.append(n + b // 2)  # the per-fabric anchor epoch
            hedging = hedging or bool(j.strategy.hedging)
            spans.append((n, n + b))
            n += b
        tms_all = np.concatenate(tms_n)
        caps_all = np.concatenate(caps_n)
        deltas_all = np.concatenate(deltas_n)
        out = solver.solve_routing_fleet(
            tms_all, caps_all, np.concatenate(valid_n),
            np.asarray(anchor_elems), np.asarray(anchor_of), hedging=hedging,
            deltas=deltas_all, skip_stage3=skip_stage3, mesh=mesh)
    solve_s = t_solve.seconds
    # non-finite guard: any element whose PDHG output came back NaN/Inf is
    # re-solved via scipy directly in the padded layout (padded commodities
    # carry zero demand, padded edges zero capacity — both exactly vacuous)
    f_n, u_n = out["f"], out["u_star"]
    bad = ~(np.isfinite(f_n).all(axis=1) & np.isfinite(u_n))
    if bad.any():
        sc0 = resolved[idxs[0]][2]  # skip_stage3 is part of the bucket key
        f_n, u_n, _ = pdhg_finite_fallback(
            _bucket_fabric(vp), tms_all, caps_all, deltas_all, sc0, f_n, u_n)
    fb_of = {i: int(bad[lo:hi].sum()) for i, (lo, hi) in zip(idxs, spans)}
    # per-job telemetry: slice the fleet-wide stats along the flattened batch
    # axis; the bucket's anchor time and solve wall clock are shared costs,
    # apportioned evenly across jobs
    anchor_share = out["stats"].get("anchor_seconds", 0.0) / len(idxs)
    stats_of = {
        i: obs.SolverStats.from_pdhg(
            [obs.slice_raw_stats(out["stats"], lo, hi, anchor_share)],
            max_iters, tol, n_fallbacks=fb_of[i])
        for i, (lo, hi) in zip(idxs, spans)}

    # ---- phase 3: one fused scoring pass over the whole bucket --------------
    with obs.timed("fleet.score", bucket_pods=vp, n_jobs=len(idxs)) as t_score:
        cc0 = resolved[idxs[0]][1]  # scoring config is part of the bucket key
        blocks_fleet, w_fleet, caps_fleet, seeds_fleet = [], [], [], []
        native_blocks_fleet, slots_fleet = [], []  # burst expansion needs these
        w_items = []
        for i, (lo, hi) in zip(idxs, spans):
            j, cc, sc = resolved[i]
            slots, caps_p = slots_of[i], caps_p_of[i]
            w_b = routing_weight_matrices(paths_p, f_n[lo:hi])  # (B, Cp, Ep)
            art = arts[i]
            if any(ev is not None for ev in art.staging):
                # staged epochs score under padded stage weights/capacities too
                art = dataclasses.replace(art, staging=tuple(
                    None if ev is None else dataclasses.replace(
                        ev,
                        stage_w=scatter_pad(scatter_pad(ev.stage_w, slots, cp,
                                                        axis=1),
                                            slots, cp, axis=2),
                        stage_caps=scatter_pad(ev.stage_caps, slots, cp,
                                               axis=1))
                    for ev in art.staging))
            blocks, block_w, block_caps, loss_seeds, _ = plan_score_blocks(
                j.trace, art, w_b, caps_p, cc)
            blocks_fleet.append([scatter_pad(np.asarray(bl, np.float64), slots,
                                             cp, axis=1) for bl in blocks])
            native_blocks_fleet.append(blocks)
            slots_fleet.append(slots)
            w_fleet.append(np.stack(block_w))
            caps_fleet.append(np.stack(block_caps))
            seeds_fleet.append(loss_seeds)
            w_items.append(w_b)
        metrics_fleet = route_metrics_fleet(
            blocks_fleet, w_fleet, caps_fleet, cc0.overload_threshold,
            backend=cc0.backend, loss_cfg=cc0.loss,
            loss_seeds_fleet=seeds_fleet if cc0.loss is not None else None,
            interval_seconds=key[-1] * 60.0,
            loss_blocks_fleet=native_blocks_fleet, loss_slots_fleet=slots_fleet,
            device=dev)

    cont_of, fail_share = _bucket_contingencies(
        key, idxs, resolved, arts, dev, blocks_fleet, w_fleet, caps_fleet,
        seeds_fleet, native_blocks_fleet, slots_fleet, w_items)

    for pos, (i, (lo, hi)) in enumerate(zip(idxs, spans)):
        j, cc, sc = resolved[i]
        art = arts[i]
        metrics = metrics_fleet[pos]
        summary = summarize(metrics)
        if obs.metrics.enabled():
            obs.quality.record_interval_metrics(j.fabric.name, metrics)
            for ep, tms in zip(art.plan.epochs, art.tms):
                obs.quality.record_epoch_quality(
                    j.fabric.name, tms, j.trace.demand[ep.start: ep.stop])
        if i in cont_of:
            summary.update(cont_of[i].summary_update())
        phases = obs.PhaseTimes()
        phases.add("plan", art.plan_seconds)
        if art.transition_seconds:
            phases.add("transition", art.transition_seconds)
        phases.add("solve", solve_s / len(idxs))
        phases.add("anchor", anchor_share)
        phases.add("score", t_score.seconds / len(idxs))
        if i in cont_of:
            phases.add("failures", fail_share)
        results[i] = ControllerResult(
            strategy=j.strategy,
            metrics=metrics,
            summary=summary,
            n_routing_updates=art.plan.n_routing,
            n_topology_updates=art.n_topology,
            final_topology=np.asarray(art.n_realized),
            transit_fraction=transit_fraction_of(paths_p, f_n[lo:hi]),
            solver_seconds=art.solver_seconds + solve_s / len(idxs),
            n_skipped_topology=art.n_skipped,
            transition_log=art.transition_log,
            stage_times=phases.times,
            solver_stats=stats_of[i],
            contingency=cont_of.get(i),
            splits=_native_splits(f_n[lo:hi], j.fabric.n_pods, vp,
                                  slots_of[i]),
            capacities=art.caps,
            u_star=u_n[lo:hi],
        )


def _bucket_contingencies(key, idxs, resolved, arts, dev, blocks_fleet,
                          w_fleet, caps_fleet, seeds_fleet,
                          native_blocks_fleet, slots_fleet, w_items):
    """Contingency analysis of a bucket's jobs with ``cc.failures`` set.

    Fixed-routing jobs stay in the padded bucket layout (their native masks
    embedded by ``scatter_pad`` over the job's commodity slots): every (job,
    scenario) pair is one more row of a single fused
    :func:`contingency_metrics_jobs` call.  Re-solve jobs drop to their
    fabric's native layout (routing is re-solved per scenario in its own
    flattened PDHG batch).  Returns ``(reports by job index, seconds per
    evaluated job)``.
    """
    cont_of: dict = {}
    if all(resolved[i][1].failures is None for i in idxs):
        return cont_of, 0.0
    from repro_torch.failures import (evaluate_plan, report_from_metrics,
                                      sample_masks)
    from repro_torch.failures.evaluate import (EvalJob,
                                               contingency_metrics_jobs,
                                               record_contingency_gauges)

    vp, m = key[0], key[1]
    cp = vp * (vp - 1)
    cc0 = resolved[idxs[0]][1]  # scoring config is part of the bucket key
    with obs.timed("fleet.failures", bucket_pods=vp) as t_fail:
        fixed_pos = [pos for pos, i in enumerate(idxs)
                     if resolved[i][1].failures is not None
                     and not resolved[i][1].failures.resolve]
        scen_of, ejobs = {}, []
        for pos in fixed_pos:
            i = idxs[pos]
            j, cc, sc = resolved[i]
            scen, masks = sample_masks(j.fabric, cc.failures)
            scen_of[i] = scen
            ejobs.append(EvalJob(
                blocks=blocks_fleet[pos], weights=w_fleet[pos],
                caps=caps_fleet[pos],
                masks=scatter_pad(masks, slots_fleet[pos], cp, axis=1),
                loss_seeds=seeds_fleet[pos],
                native_blocks=native_blocks_fleet[pos],
                slots=slots_fleet[pos]))
        if ejobs:
            per_job = contingency_metrics_jobs(
                ejobs, cc0.overload_threshold, backend=cc0.backend,
                loss_cfg=cc0.loss, interval_seconds=key[-1] * 60.0,
                device=dev)
            for pos, ms in zip(fixed_pos, per_job):
                i = idxs[pos]
                j = resolved[i][0]
                rep = report_from_metrics(scen_of[i], ms, resolve=False)
                cont_of[i] = rep
                obs.event("failures.evaluated", fabric=j.fabric.name,
                          n_scenarios=rep.n_scenarios, resolve=False,
                          worst_p999_mlu=rep.worst_p999_mlu,
                          worst_p999_loss=rep.worst_p999_loss)
                record_contingency_gauges(j.fabric.name, rep)
        for pos, i in enumerate(idxs):
            j, cc, sc = resolved[i]
            if cc.failures is None or not cc.failures.resolve:
                continue
            art = arts[i]
            slots = slots_fleet[pos]
            w_nat = w_items[pos][:, slots][:, :, slots]
            (blocks, block_w, block_caps, loss_seeds,
             block_epoch) = plan_score_blocks(j.trace, art, w_nat, art.caps,
                                              cc)
            ep_idx = np.asarray(block_epoch)
            cont_of[i] = evaluate_plan(
                j.fabric, cc, sc, blocks, np.stack(block_w),
                np.stack(block_caps),
                loss_seeds if cc.loss is not None else None, key[-1] * 60.0,
                tms_blocks=art.tms_padded(m)[ep_idx],
                deltas=art.deltas[ep_idx], device=dev)
    return cont_of, t_fail.seconds / max(len(cont_of), 1)


def predict_fleet(fleet, cc=None, sc=None, cushion: float = 0.05,
                  strategies: tuple = STRATEGIES, objective: str = "mlu",
                  mesh="auto", pod_quantum: int = 4,
                  contingency_weight: float | None = None,
                  device=None) -> list:
    """Fleet-batched :func:`repro_torch.core.predictor.predict`: simulate
    every strategy on every fabric's training window in one :func:`run_fleet`
    call on ``device`` (``None`` = CUDA) and apply the operator objective
    per fabric.

    Args:
      fleet: list of ``(fabric, training_trace)`` pairs.
      contingency_weight: with ``cc.failures`` set, blend each strategy's
        expected-case and worst-contingency objective through
        :func:`repro_torch.failures.policy.pick_best_contingency`; ``None``
        (default) keeps the expected-case selection.

    Returns a list of :class:`~repro_torch.core.predictor.Prediction`, in
    order.
    """
    from repro_torch.core.predictor import Prediction, pick_best

    jobs = [FleetJob(fabric, trace, strat, cc, sc)
            for fabric, trace in fleet for strat in strategies]
    res = run_fleet(jobs, mesh=mesh, pod_quantum=pod_quantum, device=device)
    k = len(strategies)
    by_name = {s.name: s for s in strategies}
    preds = []
    for fi, (fabric, trace) in enumerate(fleet):
        per = {strategies[si].name: res[fi * k + si].summary
               for si in range(k)}
        choice = pick_best(per, cushion, objective=objective,
                           contingency_weight=contingency_weight,
                           fabric=fabric.name)
        obs.event("predictor.strategy_choice", fabric=fabric.name,
                  strategy=choice, hedging=by_name[choice].hedging)
        preds.append(Prediction(fabric=fabric.name, strategy=by_name[choice],
                                per_strategy=per, cushion=cushion))
    return preds
