"""Failure-aware decision policies: expected-case vs worst-contingency — a
copy of ``repro/failures/policy.py`` with its imports rewritten.

Two decision points consume contingency outcomes:

* :func:`pick_best_contingency` — the operator objective
  (:func:`repro_torch.core.predictor.pick_best`) with the ranked metric blended as
  ``(1-w)·p99.9 + w·worst-contingency p99.9``.  ``w = 0`` reduces exactly to
  the legacy arithmetic (``(1-0)·x + 0·y == x`` bit-for-bit), which is why
  ``contingency_weight=None`` (don't call here at all) and ``0.0`` agree.
* :func:`transition_worst_case` — the §4.6 reconfigure gate's benefit and
  disruption re-derived per scenario under fixed stage routing, feeding the
  extended :func:`repro_torch.transition.config.should_reconfigure` blend: a
  transition whose drain stages look harmless in expectation can strand a
  commodity once a contingency takes the remaining parallel trunk down.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pick_best_contingency", "fixed_mlu_under_masks",
           "transition_worst_case"]

_NEEDED = {"mlu": ("p999_mlu", "cont_worst_p999_mlu"),
           "loss": ("p999_loss", "cont_worst_p999_loss")}


def pick_best_contingency(per_strategy: dict, cushion: float = 0.05,
                          objective: str = "mlu",
                          contingency_weight: float = 0.5) -> str:
    """Failure-aware operator objective.

    Ranks strategies by the blended score ``(1-w)·p999_<metric> +
    w·cont_worst_p999_<metric>`` and then applies the legacy cushion and
    tie-break structure on that score (relative cushion for ``"mlu"``,
    floored-relative for ``"loss"``).  Requires summaries produced with
    contingency analysis on (``ControllerConfig.failures`` set).
    """
    w = float(contingency_weight)
    if not 0.0 <= w <= 1.0:
        raise ValueError("contingency_weight must be in [0, 1]")
    if objective not in _NEEDED:
        raise ValueError(f"unknown objective {objective!r}")
    exp_key, worst_key = _NEEDED[objective]
    missing = [k for k, v in per_strategy.items()
               if exp_key not in v or worst_key not in v]
    if missing:
        raise ValueError(
            f"contingency-aware objective {objective!r} needs {exp_key} and "
            f"{worst_key} in every summary (missing for {sorted(missing)}; "
            "set ControllerConfig.failures — and .loss for objective='loss')")
    score = {k: (1.0 - w) * float(v[exp_key]) + w * float(v[worst_key])
             for k, v in per_strategy.items()}
    best = min(score.values())
    if objective == "loss":
        slack = max(best * cushion, 1e-6)
        eligible = {k for k, v in score.items() if v <= best + slack}
        return min(eligible, key=lambda k: (per_strategy[k]["p999_mlu"],
                                            per_strategy[k]["p999_alu"], k))
    eligible = {k for k, v in score.items()
                if v <= best * (1 + cushion) + 1e-12}
    return min(eligible, key=lambda k: (per_strategy[k]["p999_alu"], k))


def fixed_mlu_under_masks(tms: np.ndarray, weights: np.ndarray,
                          caps: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Worst-TM MLU of fixed routings under every scenario mask.

    Args:
      tms: ``(m, C)`` critical traffic matrices.
      weights: ``(B, C, E)`` fixed routing weights (e.g. old/new/stages).
      caps: ``(B, E)`` capacities each routing was solved against.
      masks: ``(K, E)`` scenario retention factors.

    Returns ``(K, B)`` — ``max_m max_e load / (caps·mask)`` with dead links
    (zero surviving capacity) excluded, matching the scoring semantics: a
    fully-failed link carries no utilization; its stranded demand shows up
    as loss, not as an infinite MLU.
    """
    tms = np.asarray(tms, np.float64)
    load = np.einsum("mc,bce->bme", tms, np.asarray(weights, np.float64))
    cap_kb = np.asarray(caps, np.float64)[None, :, :] * \
        np.asarray(masks, np.float64)[:, None, :]  # (K, B, E)
    live = cap_kb > 1e-9
    util = np.where(live[:, :, None, :],
                    load[None] / np.where(live, cap_kb, 1.0)[:, :, None, :],
                    0.0)
    return util.max(axis=(2, 3))


def transition_worst_case(fabric, tms: np.ndarray, ev, fcfg) -> tuple:
    """Per-scenario benefit/disruption extremes for the reconfigure gate.

    Re-derives the §4.6 quantities under each contingency with the already
    re-solved stage/steady routings held fixed (a drain stage is too short
    for another TE pass), then returns the robust pair
    ``(min_k benefit_k, max_k disruption_k)`` the blended
    :func:`repro_torch.transition.config.should_reconfigure` consumes.
    """
    from repro_torch.failures.mask import sample_masks

    _, masks = sample_masks(fabric, fcfg)
    w_all = np.concatenate([ev.steady_w, ev.stage_w]) \
        if ev.stage_w.size else ev.steady_w
    caps_all = np.concatenate([ev.steady_caps, ev.stage_caps]) \
        if ev.stage_caps.size else ev.steady_caps
    u = fixed_mlu_under_masks(tms, w_all, caps_all, masks)  # (K, 2 + S)
    steady = max(ev.horizon_intervals - ev.transition_intervals, 0)
    benefit_k = (u[:, 0] - u[:, 1]) * steady
    worst_stage = u[:, 2:].max(axis=1) if u.shape[1] > 2 else u[:, 1]
    disruption_k = np.maximum(worst_stage - u[:, 0], 0.0) \
        * ev.transition_intervals
    return float(benefit_k.min()), float(disruption_k.max())
