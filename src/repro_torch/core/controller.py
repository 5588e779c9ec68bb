"""Online Controller (paper §4.6, Fig. 10) — the counterpart of
``repro/core/controller.py``.

Periodic routing reconfiguration every ``routing_interval``, topology
reconfiguration every ``topology_interval``, both computed from a sliding
``aggregation_window`` of recent TMs abstracted into ``k`` critical TMs.  The
first aggregation window is warm-up; topologies are physically realized
(rounded, paper Algorithm 1) before they are scored.

This slice of the port runs the plan → batch-execute engine
(:mod:`repro_torch.core.engine`) on the device: batched PDHG routing solves
and one launch each of the linkload and queueloss CUDA kernels per sweep.
The sequential walk, reconfiguration transitions and failure contingencies
come with later slices; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.burst import LossConfig
from repro_torch.core.graph import Fabric
from repro_torch.core.simulator import IntervalMetrics
from repro_torch.core.solver import SolverConfig, Strategy
from repro_torch.core.traffic import Trace
from repro_torch.device import resolve_device

__all__ = ["ControllerConfig", "ControllerResult", "run_controller"]


def _later_slice(what: str):
    return NotImplementedError(f"{what} lands in a later slice of the port")


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
    engine: str = "batched"  # "sequential" lands in a later slice
    solver_backend: str = "pdhg"  # routing-only solves: pdhg | scipy
    pdhg_max_iters: int = 3000  # PDHG iteration cap per stage
    pdhg_tol: float = 1e-2  # PDHG certified-gap / objective-stall tolerance
    solver_precision: str = "f32"  # "bf16" lands in a later slice
    transition: object = None  # reconfiguration transitions: a later slice
    failures: object = None  # failure contingencies: a later slice
    kmeans_dtype: str = "float32"

    def __post_init__(self):
        if self.transition is not None:
            raise _later_slice("ControllerConfig.transition")
        if self.failures is not None:
            raise _later_slice("ControllerConfig.failures")
        if self.engine == "sequential":
            raise _later_slice("the sequential controller (engine='sequential')")
        if self.engine != "batched":
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.solver_precision != "f32":
            raise _later_slice(f"solver_precision={self.solver_precision!r}")
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
    n_skipped_topology: int = 0
    transition_log: tuple = ()
    # wall-time breakdown by controller phase: plan / anchor / solve / score
    # ("anchor" is the anchor-solve share of "solve"); each phase ends in a
    # host read of its results, so device work is inside its time
    stage_times: dict = dataclasses.field(default_factory=dict)
    # repro_torch.obs.SolverStats (per-epoch PDHG iterations / certified
    # gaps / restarts); None on the scipy backend
    solver_stats: object = None
    contingency: object = None
    # what the sweep scored, per routing epoch: path splits (B, P) and
    # realized directed capacities (B, E) — enough to re-score it
    splits: np.ndarray | None = None
    capacities: np.ndarray | None = None


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
    """
    dev = resolve_device(device)
    from repro_torch.core.engine import run_controller_batched

    return run_controller_batched(fabric, trace, strategy, cc, sc, device=dev)
