"""Failure-scenario subsystem — the counterpart of ``repro.failures``:
sampled contingencies as capacity masks, evaluated through the fleet scoring
stack as more rows of one fused launch of the fleet kernels, with
failure-aware reconfiguration and strategy-selection policies.

Entry points: set :class:`FailureConfig` on ``ControllerConfig.failures``
(the sequential, batched and fleet engines attach a
:class:`ContingencyReport`), or drive the pieces directly —
:func:`sample_scenarios` → :func:`directed_masks` → :func:`evaluate_plan`.
Sampling and masks are the reference's numpy streams, bit for bit.
"""

# repro_torch.core re-exports FailureConfig and ContingencyReport from the
# submodules below; initializing it first keeps either import order working
import repro_torch.core  # noqa: F401

from repro_torch.failures.config import FailureConfig
from repro_torch.failures.evaluate import (ContingencyReport, EvalJob,
                                           contingency_metrics,
                                           contingency_metrics_jobs,
                                           evaluate_plan, report_from_metrics,
                                           resolve_weights)
from repro_torch.failures.mask import directed_masks, sample_masks
from repro_torch.failures.policy import (fixed_mlu_under_masks,
                                         pick_best_contingency,
                                         transition_worst_case)
from repro_torch.failures.scenarios import (ScenarioSet, panel_fractions,
                                            sample_scenarios, scenario_seed)

__all__ = [
    "FailureConfig", "ScenarioSet", "scenario_seed", "sample_scenarios",
    "panel_fractions", "directed_masks", "sample_masks", "EvalJob",
    "ContingencyReport", "contingency_metrics", "contingency_metrics_jobs",
    "report_from_metrics", "resolve_weights", "evaluate_plan",
    "pick_best_contingency", "fixed_mlu_under_masks", "transition_worst_case",
]
