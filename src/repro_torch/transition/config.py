"""Transition knobs and the §4.6 "when to reconfigure" decision rule — a copy
of ``repro/transition/config.py`` with its imports rewritten.

Kept free of solver-facing dependencies (dataclasses + :mod:`repro_torch.obs`
only) so :mod:`repro_torch.core.controller` can import the config without
pulling the transition machinery into its import graph.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs import audit, metrics

__all__ = ["TransitionConfig", "should_reconfigure"]


@dataclasses.dataclass(frozen=True)
class TransitionConfig:
    """Reconfiguration-transition modeling (paper §A / Thm. 4 + §4.6).

    ``ControllerConfig.transition = None`` (the default) is the legacy
    instantaneous-and-free model — controller output is bit-identical to the
    pre-transition behavior.  With a config set, every topology update after
    the first is executed as a sequence of patch-panel drain stages and is
    gated by :func:`should_reconfigure`.

    Attributes:
      n_panels: patch panels the fabric's fibers are spread over (Thm. 4's
        ``2^p``; any positive count is accepted — see
        :mod:`repro_torch.core.patch_panels` for the generalization).
      stage_intervals: trace intervals each panel drain occupies.  The first
        ``n_stages * stage_intervals`` intervals of a topology epoch are
        scored under the staged residual capacities (clipped to the epoch —
        stages that do not fit before the next routing update are applied
        but not scored).
      decide: gate topology updates on :func:`should_reconfigure`; with
        ``False`` every update is applied (isolates the staging cost).
      hysteresis: decision margin — reconfigure only when the predicted
        benefit exceeds ``(1 + hysteresis) *`` the predicted disruption.
      instantaneous: model the capacity change as instantaneous (legacy
        scoring) while still evaluating stages for the decision rule —
        isolates the decision from the staged-scoring model.
    """

    n_panels: int = 4
    stage_intervals: int = 1
    decide: bool = True
    hysteresis: float = 0.0
    instantaneous: bool = False

    def __post_init__(self):
        if self.n_panels < 1:
            raise ValueError("n_panels must be >= 1")
        if self.stage_intervals < 1:
            raise ValueError("stage_intervals must be >= 1")


def should_reconfigure(benefit: float, disruption: float,
                       hysteresis: float = 0.0, *,
                       contingency_weight: float | None = None,
                       benefit_worst: float | None = None,
                       disruption_worst: float | None = None,
                       fabric: str | None = None) -> bool:
    """The §4.6 robust decision: apply a topology update iff its predicted
    steady-state gain beats the transition's predicted disruption.

    Args:
      benefit: predicted MLU reduction of the new topology over keeping the
        old one, integrated over the steady intervals until the next topology
        decision (MLU * intervals; see
        :meth:`repro_torch.transition.score.TransitionEval`).
      disruption: predicted worst-stage MLU excess over the old topology,
        integrated over the transition's staged intervals (same units).
      hysteresis: extra margin the benefit must clear, as a fraction of the
        disruption (0 = break even).
      contingency_weight / benefit_worst / disruption_worst: failure-aware
        extension (the reference's ``repro.failures.policy``; the port's
        :mod:`repro_torch.failures.policy` computes the worst-contingency
        pair, the blend itself is plain arithmetic and runs here).  With a
        weight ``w`` and
        the worst-contingency pair (min-over-scenarios benefit,
        max-over-scenarios disruption), the rule is applied to the blends
        ``(1-w)·expected + w·worst``.  ``contingency_weight=None`` (default)
        ignores the worst-case pair entirely — bit-identical legacy
        arithmetic, and ``w=0`` agrees with it exactly since
        ``(1-0)·x + 0·y == x``.
      fabric: label for the decision-audit record and metrics series
        (:mod:`repro_torch.obs`); never affects the decision.

    A non-positive benefit never reconfigures; a zero-disruption transition
    (e.g. no jumper moves) reconfigures whenever the benefit is positive.

    When :mod:`repro_torch.obs.audit` / :mod:`repro_torch.obs.metrics` are
    enabled, every evaluation is recorded with its full input vector
    (pre-blend values plus the contingency terms — enough to
    :func:`repro_torch.obs.audit.replay` it) and counted under
    ``reconfigure.decisions{outcome, reason}``.
    """
    b, d = float(benefit), float(disruption)
    if contingency_weight is not None:
        if benefit_worst is None or disruption_worst is None:
            raise ValueError(
                "contingency_weight needs benefit_worst and disruption_worst")
        w = float(contingency_weight)
        b = (1.0 - w) * b + w * benefit_worst
        d = (1.0 - w) * d + w * disruption_worst
    if not b > 0.0:
        decision, reason = False, "non_positive_benefit"
    elif b > (1.0 + hysteresis) * d:
        decision, reason = True, "benefit_clears_disruption"
    else:
        decision, reason = False, "benefit_below_disruption"
    if audit.enabled():
        audit.record(
            "should_reconfigure", fabric=fabric, benefit=float(benefit),
            disruption=float(disruption), hysteresis=float(hysteresis),
            contingency_weight=(None if contingency_weight is None
                                else float(contingency_weight)),
            benefit_worst=(None if benefit_worst is None
                           else float(benefit_worst)),
            disruption_worst=(None if disruption_worst is None
                              else float(disruption_worst)),
            decision=decision, reason=reason)
    if metrics.enabled():
        metrics.inc("reconfigure.decisions", fabric=fabric or "",
                    outcome="applied" if decision else "vetoed", reason=reason)
    return decision
