"""Topology diffing onto patch panels (paper §A, Thm. 4) — a copy of
``repro/transition/diff.py`` with its imports rewritten.

A reconfiguration never moves fibers between panels: every pod keeps a fixed
set of ports wired into each panel, and a topology change only re-targets
*jumpers* inside panels.  This module expresses an old -> new integer trunk
topology change in those terms: both endpoints are decomposed with
:func:`repro_torch.core.patch_panels.assign_panels` and the per-panel jumper
moves are the multiset difference of each panel's old and new link sets.

In Theorem 4's exact regime (power-of-two degrees, a power-of-two panel
count) every decomposition gives each pod the same per-panel port count, so
the two sides line up fiber-stably by construction.  Outside it the two
independent decompositions may place a pod's ports across panels differently
— some ports would have to be re-homed, which Thm. 4 forbids.  That
deviation is *measured*, not assumed away: :attr:`TopologyDiff.
fiber_moves_per_panel` counts the ports each panel would need beyond the
pod's old port count there (zero iff the diff is jumper-only realizable),
and the controller surfaces the total in its transition log.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import trunk_index
from repro_torch.core.patch_panels import PanelAssignment, assign_panels

__all__ = ["TopologyDiff", "panel_trunk_counts", "diff_topologies"]


def panel_trunk_counts(n_pods: int, assignment: PanelAssignment) -> np.ndarray:
    """``(n_panels, E_u)`` integer trunk counts carried by each panel."""
    trunks = trunk_index(n_pods)
    lut = {(int(i), int(j)): e for e, (i, j) in enumerate(trunks)}
    out = np.zeros((assignment.n_panels, trunks.shape[0]), dtype=np.int64)
    for p, edges in enumerate(assignment.panel_edges):
        for i, j in edges:
            out[p, lut[(min(int(i), int(j)), max(int(i), int(j)))]] += 1
    return out


@dataclasses.dataclass(frozen=True)
class TopologyDiff:
    """Old -> new topology change expressed as per-panel jumper moves."""

    n_pods: int
    n_panels: int
    old_counts: np.ndarray  # (n_panels, E_u) trunk links per panel, old
    new_counts: np.ndarray  # (n_panels, E_u) trunk links per panel, new
    moves_per_panel: np.ndarray  # (n_panels,) jumpers to re-target per panel
    # (n_panels,) pod ports the new decomposition needs in a panel beyond the
    # pod's old port count there — 0 everywhere iff jumper-only realizable
    # (always, in the exact Thm. 4 regime; see module doc)
    fiber_moves_per_panel: np.ndarray

    @property
    def total_moves(self) -> int:
        return int(self.moves_per_panel.sum())

    @property
    def total_fiber_moves(self) -> int:
        return int(self.fiber_moves_per_panel.sum())

    @property
    def panels_with_moves(self) -> np.ndarray:
        """Panels that actually need a drain stage (>= 1 jumper move)."""
        return np.flatnonzero(self.moves_per_panel > 0)


def diff_topologies(n_pods: int, n_old: np.ndarray, n_new: np.ndarray,
                    n_panels: int) -> TopologyDiff:
    """Diff two integer trunk topologies into per-panel jumper moves.

    Both topologies must have even node degrees (the realization contract);
    each is decomposed into panels independently.  Within panel ``p`` the
    jumper moves are ``max(|old_p \\ new_p|, |new_p \\ old_p|)`` — every move
    disconnects one pod pair and connects another, so the larger side of the
    multiset difference bounds the rewiring work.  Panels whose link multiset
    is unchanged need no drain at all.
    """
    n_old = np.asarray(np.rint(n_old), dtype=np.int64)
    n_new = np.asarray(np.rint(n_new), dtype=np.int64)
    if n_old.shape != n_new.shape:
        raise ValueError("old/new topologies must have the same trunk shape")
    pa_old = assign_panels(n_pods, n_old, n_panels)
    pa_new = assign_panels(n_pods, n_new, n_panels)
    old_counts = panel_trunk_counts(n_pods, pa_old)
    new_counts = panel_trunk_counts(n_pods, pa_new)
    removed = np.maximum(old_counts - new_counts, 0).sum(axis=1)
    added = np.maximum(new_counts - old_counts, 0).sum(axis=1)
    port_deficit = np.maximum(pa_new.links_per_pod_per_panel(n_pods)
                              - pa_old.links_per_pod_per_panel(n_pods), 0)
    return TopologyDiff(
        n_pods=n_pods,
        n_panels=n_panels,
        old_counts=old_counts,
        new_counts=new_counts,
        moves_per_panel=np.maximum(removed, added),
        fiber_moves_per_panel=port_deficit.sum(axis=1),
    )
