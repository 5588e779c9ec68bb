"""Contingency-batched plan evaluation: K scenarios as more rows of one
fused scoring launch — the counterpart of ``repro/failures/evaluate.py``.

Evaluating "this plan under K contingencies" reuses the fleet-scale scoring
stack unchanged: :func:`repro_torch.core.simulator.route_metrics_fleet`
already scores an arbitrary list of (blocks, weights, capacities) rows in one
launch of the fleet linkload kernel (and one of the fleet queueloss kernel
with burst loss on), so contingencies simply become rows — the same demand
blocks and routing weights against ``caps × mask_k``.  The reference repeats
the plan's weights K times on the host; here every plan goes to the device
once and its K rows are gathered there (``route_metrics_fleet(rows=...)``),
which gives the kernels the same float32 operands.  Parity with the
per-scenario loop is test-enforced at ≤1e-5.

Two evaluation modes (``FailureConfig.resolve``):

* **fixed-routing** (default): the plan's realized weights are held fixed —
  failures happen *faster* than the TE control loop, so traffic keeps
  following the pre-failure splits.  Demand aimed at a dead link is dropped
  by the burst-loss queue model (zero buffer drain), which is exactly what
  makes hedged plans degrade gracefully: stage-2 hedging bounds the split
  mass any single link carries.
* **re-solve**: routing is re-solved per (scenario, epoch) on the masked
  capacities — the what-if where TE *does* respond before the next scoring
  interval.  MLU-only (the re-solve skips stage 3); one flattened ``(K·B)``
  PDHG batch on the device, guarded by the engine's non-finite scipy
  fallback.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.failures.mask import sample_masks
from repro_torch.failures.scenarios import ScenarioSet

__all__ = ["EvalJob", "ContingencyReport", "contingency_metrics",
           "contingency_metrics_jobs", "report_from_metrics",
           "record_contingency_gauges", "resolve_weights", "evaluate_plan"]


@dataclasses.dataclass(frozen=True)
class EvalJob:
    """One plan's contingency-evaluation inputs (any consistent layout —
    native or fleet-padded, as long as ``weights``/``caps``/``masks`` agree).

    ``native_blocks``/``slots`` carry the burst-loss layout contract of
    :func:`repro_torch.core.simulator.route_metrics_fleet`: burst expansion
    is deterministic per (seed, block shape), so padded-layout blocks need
    their native twins for losses to match the per-fabric controller.
    ``weights_k`` (``(K, B, C, E)``) switches the job to per-scenario
    re-solved routing.
    """

    blocks: list  # B demand blocks (T_b, C)
    weights: np.ndarray  # (B, C, E) plan routing weights
    caps: np.ndarray  # (B, E) plan capacities (drain residuals included)
    masks: np.ndarray  # (K, E) scenario retention factors
    loss_seeds: list | None = None
    native_blocks: list | None = None
    slots: np.ndarray | None = None
    weights_k: np.ndarray | None = None


def contingency_metrics_jobs(jobs: list, overload_threshold: float = 0.8,
                             backend: str = "torch", loss_cfg=None,
                             interval_seconds: float | None = None,
                             device=None) -> list:
    """Score every job under every one of its scenarios in ONE fused call.

    Rows of the underlying :func:`route_metrics_fleet` launch are
    (job, scenario) pairs — the contingency axis is just more rows on the
    kernel's leading fabric axis, so a whole bucket's contingency analysis
    is a single launch of each fleet kernel on ``device`` (``None`` = CUDA).
    A fixed-routing job enters the call once and its K rows share it; a
    re-solve job enters once per scenario.  All jobs must share a
    commodity/edge layout (true within a fleet bucket by construction).

    Returns a list (per job) of lists (per scenario) of
    :class:`repro_torch.core.simulator.IntervalMetrics`.
    """
    from repro_torch.core.simulator import route_metrics_fleet

    src_blocks, src_w, src_seeds, src_native, src_slots = [], [], [], [], []
    rows, rows_caps = [], []
    for j in jobs:
        caps = np.asarray(j.caps, np.float64)
        masks = np.asarray(j.masks, np.float64)
        per_scenario = j.weights_k is not None
        first = len(src_w)
        for k in range(masks.shape[0] if per_scenario else 1):
            src_blocks.append(j.blocks)
            src_w.append(np.asarray(j.weights_k[k] if per_scenario
                                    else j.weights, np.float64))
            src_seeds.append(j.loss_seeds)
            src_native.append(j.native_blocks
                              if j.native_blocks is not None else j.blocks)
            src_slots.append(j.slots)
        for k in range(masks.shape[0]):
            rows.append(first + k if per_scenario else first)
            rows_caps.append(caps * masks[k][None, :])
    ms = route_metrics_fleet(
        src_blocks, src_w, rows_caps, overload_threshold, backend=backend,
        loss_cfg=loss_cfg,
        loss_seeds_fleet=src_seeds if loss_cfg is not None else None,
        interval_seconds=interval_seconds,
        loss_blocks_fleet=src_native if loss_cfg is not None else None,
        loss_slots_fleet=src_slots if loss_cfg is not None else None,
        rows=np.asarray(rows, np.int64), device=device)
    out, pos = [], 0
    for j in jobs:
        k = np.asarray(j.masks).shape[0]
        out.append(ms[pos:pos + k])
        pos += k
    return out


def contingency_metrics(blocks, weights, caps, masks,
                        overload_threshold: float = 0.8,
                        backend: str = "torch", loss_cfg=None,
                        loss_seeds=None,
                        interval_seconds: float | None = None,
                        native_blocks=None, slots=None,
                        weights_k=None, device=None) -> list:
    """Single-job :func:`contingency_metrics_jobs`: one plan, K scenarios,
    one fused kernel launch.  Returns K ``IntervalMetrics``."""
    job = EvalJob(blocks=blocks, weights=weights, caps=caps, masks=masks,
                  loss_seeds=loss_seeds, native_blocks=native_blocks,
                  slots=slots, weights_k=weights_k)
    return contingency_metrics_jobs(
        [job], overload_threshold, backend=backend, loss_cfg=loss_cfg,
        interval_seconds=interval_seconds, device=device)[0]


@dataclasses.dataclass
class ContingencyReport:
    """Per-scenario outcomes of one plan's contingency analysis."""

    n_scenarios: int
    resolve: bool  # per-scenario re-solved routing (vs the plan's fixed)
    n_failed_links: np.ndarray  # (K,) physical links lost per scenario
    p999_mlu: np.ndarray  # (K,) per-scenario p99.9 MLU
    mean_mlu: np.ndarray  # (K,) per-scenario mean MLU
    p999_loss: np.ndarray | None = None  # (K,) when loss tracking is on
    mean_loss: np.ndarray | None = None
    n_fallbacks: int = 0  # scipy re-solves the re-solve mode needed

    @property
    def worst_p999_mlu(self) -> float:
        return float(self.p999_mlu.max())

    @property
    def worst_p999_loss(self) -> float | None:
        return None if self.p999_loss is None else float(self.p999_loss.max())

    def summary_update(self) -> dict:
        """The ``cont_*`` keys merged into ``ControllerResult.summary`` —
        what :func:`repro_torch.failures.policy.pick_best_contingency`
        consumes."""
        out = {
            "cont_n_scenarios": int(self.n_scenarios),
            "cont_worst_p999_mlu": self.worst_p999_mlu,
            "cont_mean_p999_mlu": float(self.p999_mlu.mean()),
        }
        if self.p999_loss is not None:
            out["cont_worst_p999_loss"] = float(self.p999_loss.max())
            out["cont_mean_p999_loss"] = float(self.p999_loss.mean())
        return out

    def to_dict(self) -> dict:
        out = {
            "n_scenarios": int(self.n_scenarios),
            "resolve": bool(self.resolve),
            "n_fallbacks": int(self.n_fallbacks),
            "n_failed_links": [int(x) for x in self.n_failed_links],
            "p999_mlu": [round(float(x), 6) for x in self.p999_mlu],
            "mean_mlu": [round(float(x), 6) for x in self.mean_mlu],
        }
        out.update({k: v for k, v in self.summary_update().items()
                    if k != "cont_n_scenarios"})
        if self.p999_loss is not None:
            out["p999_loss"] = [round(float(x), 6) for x in self.p999_loss]
        return out


def report_from_metrics(scen: ScenarioSet, metrics: list, resolve: bool,
                        n_fallbacks: int = 0) -> ContingencyReport:
    """Summarize K per-scenario ``IntervalMetrics`` into a report."""
    from repro_torch.core.simulator import p999

    has_loss = metrics and metrics[0].loss is not None
    return ContingencyReport(
        n_scenarios=scen.n_scenarios,
        resolve=bool(resolve),
        n_failed_links=np.asarray(scen.n_failed_links),
        p999_mlu=np.asarray([p999(m.mlu) for m in metrics]),
        mean_mlu=np.asarray([float(m.mlu.mean()) if m.mlu.size else np.nan
                             for m in metrics]),
        p999_loss=(np.asarray([p999(m.loss) for m in metrics])
                   if has_loss else None),
        mean_loss=(np.asarray([float(m.loss.mean()) if m.loss.size else np.nan
                               for m in metrics]) if has_loss else None),
        n_fallbacks=int(n_fallbacks))


def record_contingency_gauges(fabric: str, rep: ContingencyReport) -> None:
    """Fold a contingency report's worst-case headline numbers into the
    fleet-metrics registry as per-fabric gauges (last evaluation wins — these
    are "current survivability posture" signals, not distributions).  No-op
    when metrics are disabled."""
    from repro_torch.obs import metrics as obs_metrics

    if not obs_metrics.enabled():
        return
    obs_metrics.set_gauge("failures.cont_worst_p999_mlu",
                          rep.worst_p999_mlu, fabric=fabric)
    if rep.worst_p999_loss is not None:
        obs_metrics.set_gauge("failures.cont_worst_p999_loss",
                              rep.worst_p999_loss, fabric=fabric)
    obs_metrics.inc("failures.evaluations", fabric=fabric)


def resolve_weights(fabric, tms_blocks: np.ndarray, caps: np.ndarray,
                    masks: np.ndarray, deltas: np.ndarray, cc, sc,
                    device=None) -> tuple:
    """Re-solve routing per (scenario, block) on the masked capacities.

    One flattened ``(K·B)`` PDHG batch on ``device`` (``None`` = CUDA;
    MLU-only: stage 3 skipped — the what-if asks how well TE *could* spread
    load, not for its exact hot-path splits), followed by the engine's
    per-element non-finite scipy fallback.  Returns ``(weights_k (K, B, C,
    E), n_fallbacks)``.
    """
    from repro_torch.core.engine import (pdhg_finite_fallback,
                                         routing_solver_for)
    from repro_torch.core.paths import build_paths, routing_weight_matrices

    tms_blocks = np.asarray(tms_blocks, np.float64)
    caps = np.asarray(caps, np.float64)
    k, b = masks.shape[0], caps.shape[0]
    caps_kb = (caps[None, :, :] * masks[:, None, :]).reshape(k * b, -1)
    tms_kb = np.ascontiguousarray(
        np.broadcast_to(tms_blocks, (k,) + tms_blocks.shape)
        .reshape((k * b,) + tms_blocks.shape[1:]))
    deltas_kb = np.ascontiguousarray(
        np.broadcast_to(np.asarray(deltas, np.float64), (k, b)).reshape(-1))
    solver = routing_solver_for(fabric, tms_blocks.shape[1],
                                cc.pdhg_max_iters, cc.pdhg_tol,
                                cc.solver_precision, device=device)
    out = solver.solve_routing_batch(
        tms_kb, caps_kb, hedging=bool((deltas_kb > 0).any()),
        deltas=deltas_kb, skip_stage3=True)
    f_kb, _, n_fb = pdhg_finite_fallback(
        fabric, tms_kb, caps_kb, deltas_kb, sc,
        np.asarray(out["f"], np.float64),
        np.asarray(out["u_star"], np.float64))
    paths = build_paths(fabric.n_pods)
    w_kb = routing_weight_matrices(paths, f_kb)
    return w_kb.reshape(k, b, w_kb.shape[1], w_kb.shape[2]), n_fb


def evaluate_plan(fabric, cc, sc, blocks, weights, caps, loss_seeds,
                  interval_seconds: float, *, tms_blocks=None, deltas=None,
                  scen: ScenarioSet | None = None,
                  masks: np.ndarray | None = None,
                  device=None) -> ContingencyReport:
    """Contingency analysis of one executed plan (``cc.failures`` is set).

    ``blocks``/``weights``/``caps``/``loss_seeds`` are exactly the scoring
    inputs the engines already assembled (drain-stage blocks included), in
    the fabric's native layout.  ``tms_blocks``/``deltas`` (per block) are
    required only in re-solve mode.  ``scen``/``masks`` let callers reuse a
    sampled scenario set; by default both derive deterministically from
    ``(fabric.name, cc.failures.seed)``.  The scoring (and the re-solve) run
    on ``device`` (``None`` = CUDA).
    """
    from repro_torch import obs

    fcfg = cc.failures
    if scen is None:
        scen, masks = sample_masks(fabric, fcfg)
    elif masks is None:
        from repro_torch.failures.mask import directed_masks

        masks = directed_masks(fabric, scen)
    weights = np.asarray(weights, np.float64)
    caps = np.asarray(caps, np.float64)
    weights_k, n_fb = None, 0
    if fcfg.resolve:
        if tms_blocks is None or deltas is None:
            raise ValueError("resolve mode needs per-block tms and deltas")
        weights_k, n_fb = resolve_weights(fabric, tms_blocks, caps, masks,
                                          deltas, cc, sc, device=device)
    metrics = contingency_metrics(
        blocks, weights, caps, masks, cc.overload_threshold,
        backend=cc.backend, loss_cfg=cc.loss,
        loss_seeds=loss_seeds if cc.loss is not None else None,
        interval_seconds=interval_seconds, weights_k=weights_k,
        device=device)
    rep = report_from_metrics(scen, metrics, fcfg.resolve, n_fb)
    obs.event("failures.evaluated", fabric=fabric.name,
              n_scenarios=rep.n_scenarios, resolve=rep.resolve,
              worst_p999_mlu=rep.worst_p999_mlu,
              worst_p999_loss=rep.worst_p999_loss)
    record_contingency_gauges(fabric.name, rep)
    return rep
