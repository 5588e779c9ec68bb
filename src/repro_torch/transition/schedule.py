"""Drain-stage scheduling: order the panels to minimize worst-stage load — a
copy of ``repro/transition/schedule.py`` with its imports rewritten.

During a transition each panel with jumper moves is drained in turn: its
links carry no traffic while jumpers are re-targeted, panels already drained
carry their *new* link sets, and panels not yet drained still carry their
*old* sets.  The per-stage residual trunk topology is therefore a pure
function of the drain order, and the schedule is chosen to minimize the
worst stage's predicted MLU.

The scheduler optimizes a cheap, solver-free MLU proxy (capacity-
proportional 1-/2-hop path splits — exactly the path set the LP optimizes
over, so a stranded stage shows up as an infinite proxy cost):

* **exact** for small panel counts via a Held–Karp-style subset DP — the
  optimal order under the proxy, ``O(P * 2^P)`` stage evaluations;
* **greedy** beyond ``max_exact`` panels — each position takes the remaining
  panel whose drain stage costs least.

The chosen order is then scored exactly (routing re-solved per stage) by
:mod:`repro_torch.transition.score`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Fabric
from repro_torch.core.paths import build_paths, routing_weight_matrix
from repro_torch.transition.diff import TopologyDiff

__all__ = ["residual_trunks", "stage_trunks_for_order", "proxy_splits",
           "proxy_mlu", "schedule_drains"]


def residual_trunks(diff: TopologyDiff, drained, draining: int) -> np.ndarray:
    """``(E_u,)`` trunk counts live while ``draining`` is down.

    ``drained`` panels already carry their new link sets; everything else
    (except the draining panel) still carries its old set.
    """
    drained = set(int(p) for p in drained)
    counts = np.zeros(diff.old_counts.shape[1], dtype=np.int64)
    for p in range(diff.n_panels):
        if p == int(draining):
            continue
        counts += diff.new_counts[p] if p in drained else diff.old_counts[p]
    return counts


def stage_trunks_for_order(diff: TopologyDiff, order) -> np.ndarray:
    """``(S, E_u)`` per-stage residual trunk counts for a drain order."""
    return np.stack([residual_trunks(diff, order[:s], p)
                     for s, p in enumerate(order)]) if len(order) else \
        np.zeros((0, diff.old_counts.shape[1]), dtype=np.int64)


def proxy_splits(paths, capacities: np.ndarray) -> np.ndarray | None:
    """Capacity-proportional path splits ``(P,)`` on ``capacities``: each
    commodity spreads over its 1-/2-hop paths proportionally to the path's
    bottleneck capacity.  Returns None when some commodity is stranded
    (every candidate path crosses a dead link)."""
    cap = np.asarray(capacities, dtype=np.float64)
    e0 = paths.path_edges[:, 0]
    e1 = paths.path_edges[:, 1]
    bottleneck = np.where(e1 >= 0, np.minimum(cap[e0], cap[np.maximum(e1, 0)]),
                          cap[e0])
    per_comm = np.zeros(paths.n_commodities)
    np.add.at(per_comm, paths.path_commodity, bottleneck)
    if (per_comm <= 1e-12).any():
        return None
    return bottleneck / per_comm[paths.path_commodity]


def proxy_mlu(fabric: Fabric, tms: np.ndarray, capacities: np.ndarray) -> float:
    """Solver-free MLU estimate on ``capacities`` via :func:`proxy_splits`.

    Returns ``inf`` when some commodity is stranded — such stages are never
    schedulable ahead of a better alternative.
    """
    paths = build_paths(fabric.n_pods)
    cap = np.asarray(capacities, dtype=np.float64)
    f = proxy_splits(paths, cap)
    if f is None:
        return float("inf")
    w = routing_weight_matrix(paths, f)
    load = np.asarray(tms, dtype=np.float64) @ w  # (m, E_d)
    live = cap > 1e-9
    return float((load[:, live] / cap[None, live]).max()) if live.any() else 0.0


def _stage_cost_fn(fabric: Fabric, tms: np.ndarray, diff: TopologyDiff):
    cache: dict = {}

    def cost(drained_mask: int, draining: int, panels) -> float:
        key = (drained_mask, draining)
        if key not in cache:
            drained = [panels[i] for i in range(len(panels))
                       if drained_mask >> i & 1]
            trunks = residual_trunks(diff, drained, panels[draining])
            cache[key] = proxy_mlu(fabric, tms, fabric.capacities(trunks))
        return cache[key]

    return cost


def schedule_drains(fabric: Fabric, tms: np.ndarray, diff: TopologyDiff,
                    max_exact: int = 8) -> tuple:
    """Choose the drain order minimizing the worst-stage proxy MLU.

    Only panels with jumper moves are drained.  Returns ``(order, cost,
    naive_cost)`` — the panel order (tuple of panel indices), its worst-stage
    proxy MLU, and the worst-stage proxy MLU of the naive ascending-index
    order for comparison.
    """
    panels = tuple(int(p) for p in diff.panels_with_moves)
    n = len(panels)
    if n == 0:
        return (), 0.0, 0.0
    cost = _stage_cost_fn(fabric, tms, diff)
    naive_cost = max(cost(_mask(range(s)), s, panels) for s in range(n))
    if n <= max_exact:
        # subset DP: best[mask] = minimal worst-stage cost draining `mask`
        best = {0: 0.0}
        parent: dict = {}
        for mask in sorted(range(1, 1 << n), key=_popcount):
            cands = []
            for i in range(n):
                if not mask >> i & 1:
                    continue
                prev = mask ^ (1 << i)
                if prev in best:
                    cands.append((max(best[prev], cost(prev, i, panels)), i))
            c, i = min(cands)
            best[mask] = c
            parent[mask] = i
        order_idx, mask = [], (1 << n) - 1
        while mask:
            i = parent[mask]
            order_idx.append(i)
            mask ^= 1 << i
        order_idx.reverse()
        return (tuple(panels[i] for i in order_idx), best[(1 << n) - 1],
                naive_cost)
    # greedy: each position takes the cheapest remaining drain
    remaining = list(range(n))
    mask, order_idx, worst = 0, [], 0.0
    while remaining:
        c, i = min((cost(mask, i, panels), i) for i in remaining)
        worst = max(worst, c)
        order_idx.append(i)
        remaining.remove(i)
        mask |= 1 << i
    return tuple(panels[i] for i in order_idx), worst, naive_cost


def _mask(indices) -> int:
    m = 0
    for i in indices:
        m |= 1 << int(i)
    return m


def _popcount(mask: int) -> int:
    return bin(mask).count("1")
