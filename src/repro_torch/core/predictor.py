"""Predictor (paper §4.6): choose the best reconfiguration strategy for the
next predicted interval by *simulating* all four strategies on the training
window and applying the operator objective:

    prefer the strategy whose p99.9 MLU is within ``cushion`` (5%) of the
    best p99.9 MLU; break ties by p99.9 ALU.

With burst-level loss tracking enabled (``ControllerConfig.loss``, see
:mod:`repro_torch.burst`), ``objective="loss"`` applies the paper's loss-aware
variant instead: prefer the strategy whose p99.9 *loss fraction* is within
the cushion of the best, breaking ties by p99.9 MLU then ALU — this is the
objective under which hedging pays off on volatile fabrics (§5).

The counterpart of ``repro/core/predictor.py``: the strategy sweeps run the
port's controller on ``device``.  A ``contingency_weight`` selects through
the failure-aware :func:`repro_torch.failures.policy.pick_best_contingency`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.controller import (ControllerConfig, ControllerResult,
                                         run_controller)
from repro_torch.core.graph import Fabric
from repro_torch.core.solver import STRATEGIES, SolverConfig, Strategy
from repro_torch.core.traffic import Trace
from repro_torch.device import resolve_device
from repro_torch.obs import audit, metrics

__all__ = ["Prediction", "predict", "predict_from_window", "pick_best"]

# summary keys the operator objective can consume — the audit record keeps
# exactly these per strategy, which makes the record replayable on its own
_OBJECTIVE_KEYS = ("p999_mlu", "p999_alu", "p999_loss",
                   "cont_worst_p999_mlu", "cont_worst_p999_loss")


@dataclasses.dataclass
class Prediction:
    fabric: str
    strategy: Strategy
    per_strategy: dict  # name -> summary dict
    cushion: float


def _select(per_strategy: dict, cushion: float, objective: str,
            contingency_weight: float | None) -> str:
    """The pure selection rule (no recording) — see :func:`pick_best`."""
    if contingency_weight is not None:
        from repro_torch.failures.policy import pick_best_contingency

        return pick_best_contingency(per_strategy, cushion, objective,
                                     contingency_weight)
    if objective == "loss":
        if any("p999_loss" not in v for v in per_strategy.values()):
            raise ValueError(
                "objective='loss' needs summaries produced with loss tracking "
                "on (set ControllerConfig.loss to a repro_torch.burst.LossConfig)")
        losses = {k: v["p999_loss"] for k, v in per_strategy.items()}
        best = min(losses.values())
        slack = max(best * cushion, 1e-6)
        eligible = {k for k, v in losses.items() if v <= best + slack}
        return min(eligible, key=lambda k: (per_strategy[k]["p999_mlu"],
                                            per_strategy[k]["p999_alu"], k))
    if objective != "mlu":
        raise ValueError(f"unknown objective {objective!r}")
    mlus = {k: v["p999_mlu"] for k, v in per_strategy.items()}
    best = min(mlus.values())
    eligible = {k for k, v in mlus.items() if v <= best * (1 + cushion) + 1e-12}
    return min(eligible, key=lambda k: (per_strategy[k]["p999_alu"], k))


def _objective_value(summary: dict, objective: str,
                     contingency_weight: float | None) -> float:
    """The ranked metric a strategy was scored by (blended when weighted)."""
    exp_key = "p999_loss" if objective == "loss" else "p999_mlu"
    val = float(summary[exp_key])
    if contingency_weight is not None:
        worst_key = ("cont_worst_p999_loss" if objective == "loss"
                     else "cont_worst_p999_mlu")
        w = float(contingency_weight)
        val = (1.0 - w) * val + w * float(summary[worst_key])
    return val


def _record_choice(per_strategy: dict, cushion: float, objective: str,
                   contingency_weight: float | None, fabric: str | None,
                   choice: str) -> None:
    if metrics.enabled():
        metrics.inc("predictor.choices", fabric=fabric or "", strategy=choice)
    if not audit.enabled():
        return
    runner_up = None
    if len(per_strategy) > 1:
        rest = {k: v for k, v in per_strategy.items() if k != choice}
        runner_up = _select(rest, cushion, objective, contingency_weight)
    audit.record(
        "pick_best", fabric=fabric, objective=objective,
        cushion=float(cushion),
        contingency_weight=(None if contingency_weight is None
                            else float(contingency_weight)),
        per_strategy={k: {key: float(v[key]) for key in _OBJECTIVE_KEYS
                          if key in v}
                      for k, v in per_strategy.items()},
        chosen=choice,
        chosen_objective=_objective_value(per_strategy[choice], objective,
                                          contingency_weight),
        runner_up=runner_up,
        runner_up_objective=(None if runner_up is None else _objective_value(
            per_strategy[runner_up], objective, contingency_weight)))


def pick_best(per_strategy: dict, cushion: float = 0.05,
              objective: str = "mlu",
              contingency_weight: float | None = None, *,
              fabric: str | None = None) -> str:
    """Operator objective (paper §4.6).

    ``objective="mlu"``: among strategies with p99.9 MLU within ``cushion``
    of the minimum, pick the lowest p99.9 ALU.

    ``objective="loss"``: among strategies with p99.9 loss fraction within
    ``cushion`` of the minimum (relative, with a 1e-6 absolute floor so an
    all-zero-loss tie falls through cleanly), pick the lowest p99.9 MLU,
    breaking remaining ties by p99.9 ALU.  Requires summaries produced with
    loss tracking on (``p999_loss`` present).

    ``contingency_weight`` (failure-aware extension): rank by the blended
    ``(1-w)·p999 + w·cont_worst_p999`` score instead
    (:func:`repro_torch.failures.policy.pick_best_contingency`); needs
    summaries from a controller run with ``ControllerConfig.failures`` set.
    ``None`` (default) is the expected-case selection.

    ``fabric`` labels the decision-audit record and ``predictor.choices``
    counter (:mod:`repro_torch.obs`); it never affects the selection.  The audit
    entry carries the objective values consumed (:data:`_OBJECTIVE_KEYS`
    subset of each summary), the chosen strategy and its score, and the
    runner-up — the selection re-run with the winner removed — so a recorded
    decision replays from the entry alone.
    """
    choice = _select(per_strategy, cushion, objective, contingency_weight)
    if audit.enabled() or metrics.enabled():
        _record_choice(per_strategy, cushion, objective, contingency_weight,
                       fabric, choice)
    return choice


def predict(
    fabric: Fabric,
    training: Trace,
    cc: ControllerConfig | None = None,
    sc: SolverConfig | None = None,
    cushion: float = 0.05,
    strategies: tuple = STRATEGIES,
    objective: str = "mlu",
    contingency_weight: float | None = None,
    device=None,
) -> Prediction:
    """Simulate each strategy over the training window and pick the winner.

    The sweeps run the port's controller on ``device`` (``None`` = CUDA)."""
    from repro_torch import obs

    dev = resolve_device(device)
    per: dict = {}
    by_name: dict = {}
    for strat in strategies:
        res: ControllerResult = run_controller(fabric, training, strat, cc, sc,
                                               device=dev)
        per[strat.name] = res.summary
        by_name[strat.name] = strat
    choice = pick_best(per, cushion, objective=objective,
                       contingency_weight=contingency_weight,
                       fabric=fabric.name)
    obs.event("predictor.strategy_choice", fabric=fabric.name,
              strategy=choice, hedging=by_name[choice].hedging)
    return Prediction(fabric=fabric.name, strategy=by_name[choice],
                      per_strategy=per, cushion=cushion)


def predict_from_window(
    fabric: Fabric,
    window,
    interval_minutes: float,
    cc: ControllerConfig | None = None,
    sc: SolverConfig | None = None,
    cushion: float = 0.05,
    strategies: tuple = STRATEGIES,
    objective: str = "mlu",
    contingency_weight: float | None = None,
    min_epochs: int = 2,
    device=None,
) -> Prediction:
    """:func:`predict` over a raw demand window instead of a full trace.

    The streaming controller's warm-up buffer is exactly one aggregation
    window of intervals — too short to replay under the production
    ``aggregation_days`` (the inner simulation would have no scored epochs).
    The window is wrapped into a :class:`Trace` and replayed with the
    aggregation shrunk so at least ``min_epochs`` routing epochs survive
    warm-up; every other knob of ``cc`` is inherited unchanged.
    """
    import numpy as np

    window = np.asarray(window)
    cc = cc or ControllerConfig()
    ipd = int(round(24 * 60 / interval_minutes))
    route_step = max(1, int(round(cc.routing_interval_hours * ipd / 24.0)))
    # largest inner warm-up leaving >= min_epochs scored routing epochs
    inner_agg = max(route_step, window.shape[0] - min_epochs * route_step)
    if inner_agg >= window.shape[0]:
        raise ValueError(
            f"window of {window.shape[0]} intervals is too short to simulate "
            f"even one routing epoch (route_step={route_step})")
    cc_inner = dataclasses.replace(cc, aggregation_days=inner_agg / ipd)
    training = Trace(name=f"{fabric.name}-warmup", demand=window,
                     interval_minutes=interval_minutes, n_pods=fabric.n_pods)
    return predict(fabric, training, cc_inner, sc, cushion=cushion,
                   strategies=strategies, objective=objective,
                   contingency_weight=contingency_weight, device=device)
