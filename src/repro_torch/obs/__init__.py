"""repro_torch.obs — tracing, solver telemetry, fleet metrics, the decision
audit and their CLIs (copies of the reference's ``repro.obs`` modules):
``python -m repro_torch.obs.report <trace.jsonl>`` summarizes a trace and
``python -m repro_torch.obs.health <snapshot.json>`` renders the fleet health
table.

All layers are off by default and free when off:

* **Tracing** (:mod:`.trace`): spans / instant events / counters into an
  in-process ring buffer, exported as JSONL or Chrome ``trace_event`` JSON.
* **Solver telemetry** (:mod:`.stats`): per-epoch PDHG convergence effort
  attached to ``ControllerResult.solver_stats``.
* **Fleet metrics** (:mod:`.metrics` + :mod:`.quality`): labeled counters /
  gauges / histograms of per-fabric MLU, loss and stretch series.
* **Decision audit** (:mod:`.audit`): every ``should_reconfigure`` and
  ``pick_best`` with its full input vector, replayable from the record
  alone.
"""

from . import audit, metrics, quality
from .stats import (SolverStats, StageStats, slice_raw_stats,
                    warm_start_savings)
from .trace import (PhaseTimes, capacity, chrome_trace_events, clear, counter,
                    disable, dropped, enable, enabled, event, events,
                    export_chrome_trace, export_jsonl, read_jsonl, span,
                    timed)

__all__ = [
    "enable", "disable", "enabled", "clear", "capacity", "dropped", "span",
    "timed", "event", "counter", "events", "PhaseTimes", "export_jsonl",
    "export_chrome_trace", "read_jsonl", "chrome_trace_events",
    "SolverStats", "StageStats", "slice_raw_stats", "warm_start_savings",
    "audit", "metrics", "quality",
]
