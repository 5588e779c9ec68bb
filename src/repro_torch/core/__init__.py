"""Gemini core on PyTorch — the counterpart of ``repro.core``: the batched
controller engine, the sequential walk and the fleet engine, their PDHG
routing solver and scoring on the device, the predictor and the baselines, and
copies of the reference's framework-free modules (fabric graph, paths,
traffic, synthetic fleet, scipy LPs, rounding, patch panels, joint
solver).  The failure contingencies' config and report are re-exported from
:mod:`repro_torch.failures`."""

from repro_torch.core.graph import Fabric, uniform_topology
from repro_torch.core.paths import PathSet, build_paths, routing_weight_matrix
from repro_torch.core.traffic import Trace
from repro_torch.core.clustering import critical_tms
from repro_torch.core.solver import (STRATEGIES, GeminiSolution, SolverConfig,
                                     Strategy, solve)
from repro_torch.core.simulator import (IntervalMetrics, route_metrics,
                                        route_metrics_batched, summarize)
from repro_torch.core.controller import (ControllerConfig, ControllerResult,
                                         run_controller)
from repro_torch.core.engine import (ControllerPlan, PlanArtifacts,
                                     plan_artifacts, plan_controller,
                                     run_controller_batched)
from repro_torch.core.fleet_engine import FleetJob, predict_fleet, run_fleet
from repro_torch.core.predictor import Prediction, pick_best, predict
from repro_torch.burst import BurstParams, LossConfig
from repro_torch.failures.config import FailureConfig
from repro_torch.failures.evaluate import ContingencyReport
from repro_torch.transition import TransitionConfig, should_reconfigure

__all__ = [
    "Fabric", "uniform_topology", "PathSet", "build_paths",
    "routing_weight_matrix", "Trace", "critical_tms", "STRATEGIES",
    "GeminiSolution", "SolverConfig", "Strategy", "solve", "IntervalMetrics",
    "route_metrics", "route_metrics_batched", "summarize", "ControllerConfig",
    "ControllerResult", "run_controller", "ControllerPlan", "PlanArtifacts",
    "plan_artifacts", "plan_controller", "run_controller_batched",
    "FleetJob", "run_fleet", "predict_fleet", "Prediction", "pick_best",
    "predict",
    "BurstParams", "LossConfig", "ContingencyReport", "FailureConfig",
    "TransitionConfig", "should_reconfigure",
]
