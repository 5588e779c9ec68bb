"""Scenario → directed capacity-mask tensors — a copy of
``repro/failures/mask.py`` with its imports rewritten.

A mask is a ``(K, E_d)`` array of multiplicative capacity retention factors
in the fabric's directed-edge enumeration — the same layout every capacity
vector in the repo uses (:meth:`repro_torch.core.graph.Fabric.capacities`,
transition ``stage_caps``, the engines' per-epoch ``caps``).  Composition is
plain elementwise multiplication:

    caps_under_scenario_k = caps * masks[k]

which makes failure masks stack with transition drain residuals for free —
a drained trunk that also loses links keeps ``residual × keep`` capacity.
Fully-failed links end at exactly 0 capacity; the scoring stack defines dead
links as carrying no load and never contributing to MLU/ALU/OLR, while any
demand their routing weights still point at is dropped by the burst-loss
queue model (see README "Failure model").

For the fleet engine's padded commodity layout, embed a native mask with
:func:`repro_torch.core.fleet.scatter_pad` over the job's commodity slots — padded
edges carry zero capacity already, so their mask value is irrelevant.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Fabric

from repro_torch.failures.scenarios import ScenarioSet, sample_scenarios

__all__ = ["directed_masks", "sample_masks"]


def directed_masks(fabric: Fabric, scen: ScenarioSet) -> np.ndarray:
    """``(K, E_d)`` directed capacity retention factors for a scenario set.

    Both directions of a trunk share its keep fraction (a physical link is
    full-duplex); a directed edge additionally keeps at most the retention
    of either endpoint pod (a degraded pod throttles all its incident
    capacity, both ingress and egress).
    """
    e_map = fabric.directed_trunk_of_edge()  # (E_d,)
    d = fabric.directed  # (E_d, 2)
    pod_factor = np.minimum(scen.pod_keep[:, d[:, 0]],
                            scen.pod_keep[:, d[:, 1]])
    return scen.trunk_keep[:, e_map] * pod_factor


def sample_masks(fabric: Fabric, fcfg) -> tuple:
    """Convenience: sample scenarios and build their directed masks.

    Returns ``(scen, masks)`` with ``masks`` of shape ``(K, E_d)``.
    """
    scen = sample_scenarios(fabric, fcfg)
    return scen, directed_masks(fabric, scen)
