"""Three-stage joint topology + routing solver (paper §4.5) and strategies.

Stages (run over the ``m`` critical TMs of the traffic model):

1. **Minimize MLU** ``u`` — jointly over path splits ``f`` and trunk counts
   ``n`` (ToE) or over ``f`` alone (topology fixed / Uniform strategy).
   Topology-variable mode is bilinear; the paper binary-searches ``u`` with a
   feasibility LP inside.  We implement that (``stage1_method="bisect"``) and
   an exact single-LP scaling reformulation (``"scaled"``, beyond-paper; see
   :meth:`repro.core.lp.LpBuilder.solve_stage1_joint_scaled`) — both validated
   against each other in tests.
2. **Hedging** — minimize the max *risk* ``r = f δ / C_e`` at ``u ≤ u*`` so a
   burst δ on any commodity spreads over many paths (binary search on ``r``
   when topology is variable; exact LP otherwise).  Skipped when the strategy
   disables hedging.
3. **Minimize path stretch** — minimize total load (≡ ALU) holding ``u*``
   (and ``r*``) — always a pure LP.

The four §4.6 strategies are (topology ∈ {uniform, nonuniform}) ×
(hedging ∈ {on, off}).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.graph import Fabric, uniform_topology
from repro_torch.core.lp import LpBuilder, estimate_delta
from repro_torch.core.paths import PathSet, build_paths, routing_weight_matrix

__all__ = ["SolverConfig", "GeminiSolution", "solve", "STRATEGIES", "Strategy"]

_EPS_U = 1.005  # slack multiplier on u* carried into stages 2/3 (solver tolerance)
_EPS_R = 1.005


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One of the predictor's four reconfiguration strategies (§4.6)."""

    nonuniform: bool  # ToE on (topology is an optimization variable)?
    hedging: bool

    @property
    def name(self) -> str:
        t = "nonuniform" if self.nonuniform else "uniform"
        h = "hedge" if self.hedging else "nohedge"
        return f"({t},{h})"


STRATEGIES = (
    Strategy(nonuniform=False, hedging=False),
    Strategy(nonuniform=False, hedging=True),
    Strategy(nonuniform=True, hedging=False),
    Strategy(nonuniform=True, hedging=True),
)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    k_critical: int = 12
    delta: float | None = None  # explicit burst size; None = estimate from data
    delta_quantile: float = 95.0
    stage1_method: str = "bisect"  # "bisect" (paper-faithful) | "scaled" (exact LP)
    bisect_tol: float = 1e-3  # relative gap for binary searches
    bisect_max_iters: int = 40
    skip_stage3: bool = False
    min_trunk: float = 1.0  # anti-stranding floor (0 disables); see DESIGN.md §5


@dataclasses.dataclass
class GeminiSolution:
    strategy: Strategy
    fabric: Fabric
    n_e: np.ndarray  # (E_u,) fractional trunk counts
    f: np.ndarray  # (P,) path splits
    u_star: float
    r_star: float | None
    delta: float
    solve_seconds: float
    stage_times: dict = dataclasses.field(default_factory=dict)
    # raw per-epoch PDHG telemetry (iters/gap/restarts per stage; see
    # repro.obs.SolverStats.from_pdhg) — None on the scipy backend
    pdhg_stats: dict | None = None

    @property
    def capacities(self) -> np.ndarray:
        return self.fabric.capacities(self.n_e)

    def routing_weights(self, paths: PathSet | None = None) -> np.ndarray:
        paths = paths or build_paths(self.fabric.n_pods)
        return routing_weight_matrix(paths, self.f)

    def transit_fraction(self, paths: PathSet | None = None) -> float:
        """Fraction of split mass on 2-hop paths (uniform over commodities)."""
        paths = paths or build_paths(self.fabric.n_pods)
        two = paths.path_n_edges == 2
        return float(self.f[two].sum() / max(self.f.sum(), 1e-12))


def _mlu_lower_bound(fabric: Fabric, tms: np.ndarray) -> float:
    """Paper's stage-1 lower bound: max over pods and TMs of aggregate pod
    demand (egress or ingress) over the pod's total DCNI capacity."""
    v = fabric.n_pods
    cap = fabric.pod_capacity()
    d = tms.reshape(tms.shape[0], v, v - 1)
    # egress: sum of row i; ingress: rebuild dense (V, V) per TM
    lb = 0.0
    for t in range(tms.shape[0]):
        dense = np.zeros((v, v))
        idx = 0
        for i in range(v):
            for j in range(v):
                if i != j:
                    dense[i, j] = tms[t, idx]
                    idx += 1
        egress = dense.sum(axis=1) / cap
        ingress = dense.sum(axis=0) / cap
        lb = max(lb, float(egress.max()), float(ingress.max()))
    return lb


def _mlu_upper_bound(builder: LpBuilder, fabric: Fabric) -> float:
    """Valid upper bound: direct-only routing on the uniform topology."""
    n_uni = uniform_topology(fabric)
    cap = fabric.capacities(n_uni)
    return float((builder.tms / cap[None, :]).max()) + 1e-9


def solve(
    fabric: Fabric,
    critical_tms: np.ndarray,
    strategy: Strategy,
    config: SolverConfig | None = None,
    window_demand: np.ndarray | None = None,
) -> GeminiSolution:
    """Run the (up to) three stages for a strategy over the critical TMs.

    ``window_demand`` (T, C), when given, is used to estimate δ for hedging;
    otherwise δ must come from ``config.delta`` (or hedging is skipped).
    """
    config = config or SolverConfig()
    t0 = time.perf_counter()
    paths = build_paths(fabric.n_pods)
    delta = 0.0
    if strategy.hedging:
        if config.delta is not None:
            delta = float(config.delta)
        elif window_demand is not None:
            delta = estimate_delta(window_demand, config.delta_quantile)
        else:
            delta = float(np.asarray(critical_tms).max()) * 0.25
    builder = LpBuilder(fabric, paths, critical_tms, delta=delta)
    stage_times: dict = {}
    # the connectivity floor is only admissible if every pod has enough ports
    mt = config.min_trunk if fabric.radix.min() >= config.min_trunk * (fabric.n_pods - 1) else 0.0

    # ---------------- stage 1: min MLU ----------------
    s = time.perf_counter()
    if not strategy.nonuniform:
        n_e = uniform_topology(fabric)
        res1 = builder.solve_stage1_fixed_topology(fabric.capacities(n_e))
        if not res1.ok:
            raise RuntimeError(f"stage 1 LP failed on {fabric.name}: status {res1.status}")
        u_star, f = float(res1.scalar), res1.f
    elif config.stage1_method == "scaled":
        res1 = builder.solve_stage1_joint_scaled(min_trunk=mt)
        if not res1.ok:
            raise RuntimeError(f"stage 1 LP failed on {fabric.name}: status {res1.status}")
        u_star, f = float(res1.scalar), res1.f
        n_e = res1.n if res1.n is not None else uniform_topology(fabric)
    else:  # paper-faithful binary search
        lo = _mlu_lower_bound(fabric, builder.tms)
        hi = _mlu_upper_bound(builder, fabric)
        best = None
        for _ in range(config.bisect_max_iters):
            if hi - lo <= config.bisect_tol * max(hi, 1e-9):
                break
            mid = 0.5 * (lo + hi)
            res = builder.feasibility_joint(mid if mid > 0 else 1e-9, None, min_trunk=mt)
            if res.ok:
                hi, best = mid, res
            else:
                lo = mid
        if best is None:
            best = builder.feasibility_joint(hi, None, min_trunk=mt)
            if not best.ok:
                raise RuntimeError(f"stage 1 bisection failed on {fabric.name}")
        u_star, f, n_e = hi, best.f, best.n
    stage_times["stage1"] = time.perf_counter() - s

    # ---------------- stage 2: hedge (min risk) ----------------
    r_star = None
    if strategy.hedging and delta > 0:
        s = time.perf_counter()
        u_budget = u_star * _EPS_U + 1e-9
        if not strategy.nonuniform:
            res2 = builder.solve_stage2_fixed_topology(fabric.capacities(n_e), u_budget)
            if res2.ok:
                r_star, f = float(res2.scalar), res2.f
        else:
            # binary search on r with joint feasibility inside (paper-faithful)
            cap_hint = fabric.capacities(n_e)
            live = cap_hint > 1e-9
            r_hi = float((delta / cap_hint[live]).max()) if live.any() else 1.0
            r_hi = max(r_hi, 1e-6)
            # ensure upper end feasible; expand if needed
            for _ in range(16):
                if builder.feasibility_joint(u_budget, r_hi, min_trunk=mt).ok:
                    break
                r_hi *= 2.0
            r_lo, best = 0.0, None
            for _ in range(config.bisect_max_iters):
                if r_hi - r_lo <= config.bisect_tol * max(r_hi, 1e-9):
                    break
                mid = 0.5 * (r_lo + r_hi)
                res = builder.feasibility_joint(u_budget, mid, min_trunk=mt)
                if res.ok:
                    r_hi, best = mid, res
                else:
                    r_lo = mid
            if best is not None:
                r_star, f, n_e = r_hi, best.f, best.n
            else:
                res = builder.feasibility_joint(u_budget, r_hi, min_trunk=mt)
                if res.ok:
                    r_star, f, n_e = r_hi, res.f, res.n
        stage_times["stage2"] = time.perf_counter() - s

    # ---------------- stage 3: min stretch ----------------
    if not config.skip_stage3:
        s = time.perf_counter()
        u_budget = u_star * _EPS_U + 1e-9
        r_budget = None if r_star is None else r_star * _EPS_R + 1e-12
        if not strategy.nonuniform:
            res3 = builder.solve_stage3(u_budget, r_budget, fabric.capacities(n_e))
            if res3.ok:
                f = res3.f
        else:
            res3 = builder.solve_stage3(u_budget, r_budget, None, min_trunk=mt)
            if res3.ok:
                f, n_e = res3.f, res3.n
        stage_times["stage3"] = time.perf_counter() - s

    return GeminiSolution(
        strategy=strategy,
        fabric=fabric,
        n_e=np.asarray(n_e, float),
        f=np.asarray(f, float),
        u_star=float(u_star),
        r_star=r_star,
        delta=delta,
        solve_seconds=time.perf_counter() - t0,
        stage_times=stage_times,
    )
