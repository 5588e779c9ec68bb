"""Reconfiguration-transition subsystem (paper §A / Thm. 4 + §4.6) — the
counterpart of ``repro.transition``.

Gemini's blocking fabrics are practical because reconfiguration is
*infrequent* and physically executed on patch panels that never move fibers
between panels (Thm. 4).  This package makes the controller's topology
updates cost something real:

* :mod:`.diff` — old -> new integer topologies diffed into per-panel jumper
  moves (both endpoints panel-decomposed via
  :func:`repro_torch.core.patch_panels.assign_panels`);
* :mod:`.schedule` — drain-stage ordering (exact subset DP for small panel
  counts, greedy beyond) minimizing the worst-stage proxy MLU, with
  per-stage residual capacity matrices;
* :mod:`.score` — per-stage routing re-solves in one batched PDHG call on
  the device and one-shot stage scoring through the epoch-batched linkload
  and queueloss CUDA kernels;
* :mod:`.config` — ``ControllerConfig.transition`` knobs and the §4.6
  benefit-vs-disruption :func:`should_reconfigure` rule.

With ``ControllerConfig.transition`` unset the controller is bit-identical
to the legacy instantaneous-and-free behavior.
"""

from repro_torch.transition.config import TransitionConfig, should_reconfigure
from repro_torch.transition.diff import (TopologyDiff, diff_topologies,
                                         panel_trunk_counts)
from repro_torch.transition.schedule import (proxy_mlu, proxy_splits,
                                             residual_trunks, schedule_drains,
                                             stage_trunks_for_order)
from repro_torch.transition.score import (TransitionEval, evaluate_transition,
                                          score_stage_batch, stage_metrics,
                                          stage_partition, stage_spans)

__all__ = [
    "TransitionConfig", "should_reconfigure",
    "TopologyDiff", "diff_topologies", "panel_trunk_counts",
    "proxy_mlu", "proxy_splits", "residual_trunks", "schedule_drains",
    "stage_trunks_for_order",
    "TransitionEval", "evaluate_transition", "score_stage_batch",
    "stage_metrics", "stage_partition", "stage_spans",
]
