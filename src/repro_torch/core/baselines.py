"""Demand-oblivious baselines (paper §5.2): (Uniform, VLB), Same-cost Clos,
Full Clos — the counterpart of ``repro/core/baselines.py``.  Each returns
per-interval :class:`IntervalMetrics` so benches can compare them to Gemini
with identical machinery.

* **(Uniform, VLB)** — uniform direct topology, Valiant load balancing:
  every commodity splits equally over its one direct + ``V-2`` transit paths.
  Same DCNI cost as Gemini (same pod ports, no spines).
* **Same-cost Clos** — 2:1 oversubscribed spine DCNI with ECMP: each pod
  exposes ``R_i/2`` uplinks (pod- plus spine-side optics = same transceiver
  count as Gemini's ``R_i`` direct links).  Pod *i*'s uplink direction carries
  its egress, downlink its ingress; spine layer is ideal (non-blocking).
* **Full Clos** — all ``R_i`` ports face spines: twice Gemini's DCNI cost
  (paper's upper baseline).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Fabric, uniform_topology
from repro_torch.core.paths import build_paths, routing_weight_matrix
from repro_torch.core.simulator import IntervalMetrics, route_metrics
from repro_torch.core.traffic import Trace

__all__ = ["vlb_weights", "uniform_vlb_metrics", "clos_metrics"]


def vlb_weights(n_pods: int) -> np.ndarray:
    """VLB path splits: equal over all V-1 paths of each commodity. Returns W."""
    paths = build_paths(n_pods)
    f = np.full((paths.n_paths,), 1.0 / (n_pods - 1), dtype=np.float64)
    return routing_weight_matrix(paths, f)


def uniform_vlb_metrics(fabric: Fabric, trace: Trace, realize_topology: bool = True,
                        backend: str = "torch", device=None) -> IntervalMetrics:
    """Score the whole trace under VLB on the realized uniform topology: one
    :func:`route_metrics` call, so one launch of the linkload kernel over all
    T intervals on ``backend="torch"`` (``device=None`` = CUDA)."""
    from repro_torch.core.rounding import realize

    n_uni = uniform_topology(fabric)
    if realize_topology:
        n_int, _ = realize(fabric, n_uni)
        cap = fabric.capacities(n_int)
    else:
        cap = fabric.capacities(n_uni)
    w = vlb_weights(fabric.n_pods)
    return route_metrics(trace.demand, w, cap, backend=backend, device=device)


def _pod_in_out(demand: np.ndarray, v: int) -> tuple[np.ndarray, np.ndarray]:
    """(T, V) egress and ingress aggregates from a (T, C) commodity trace."""
    t = demand.shape[0]
    egress = np.zeros((t, v))
    ingress = np.zeros((t, v))
    idx = 0
    for i in range(v):
        for j in range(v):
            if i == j:
                continue
            egress[:, i] += demand[:, idx]
            ingress[:, j] += demand[:, idx]
            idx += 1
    return egress, ingress


def clos_metrics(fabric: Fabric, trace: Trace, oversubscription: float = 2.0,
                 overload_threshold: float = 0.8) -> IntervalMetrics:
    """Spine-based Clos with ideal ECMP at ``oversubscription``:1 (2.0 =
    Same-cost Clos, 1.0 = Full Clos).  Links modeled: per-pod uplink and
    downlink trunk directions (the DCNI links of a spine design)."""
    v = fabric.n_pods
    egress, ingress = _pod_in_out(trace.demand, v)
    cap = fabric.pod_capacity() / oversubscription  # (V,)
    util = np.concatenate([egress / cap[None, :], ingress / cap[None, :]], axis=1)
    mlu = util.max(axis=1)
    alu = util.mean(axis=1)
    olr = (util > overload_threshold).mean(axis=1)
    stretch = np.full_like(mlu, 2.0)  # pod -> spine -> pod is always 2 hops
    return IntervalMetrics(mlu=mlu, alu=alu, olr=olr, stretch=stretch)
