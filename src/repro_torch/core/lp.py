"""Sparse LP assembly for the three-stage joint solver (paper §4.5).

Decision variables (flat vector ``x``):

* ``f``  — ``(P,)`` path split ratios (shared across all critical TMs; the
  robust-routing setup of [3, 4, 39] the paper builds on);
* ``n``  — ``(E_u,)`` trunk link counts (present only when topology is a
  decision variable, i.e. ToE enabled);
* plus a scalar ``u`` (MLU) or ``r`` (risk) depending on the stage.

Constraint blocks:

* **load**: ``Σ_{p ∋ e} f_p d_{t,c(p)} ≤ u · C_e``  ∀ directed e, ∀ critical TM t
* **risk**: ``f_p · δ ≤ r · C_e``                  ∀ p, ∀ e ∈ p   (paper Eq. 6/8)
* **radix**: ``Σ_{e ∋ i} n_e ≤ R_i``               ∀ pod i        (paper Eq. 3)
* **flow**: ``Σ_{p ∈ P_c} f_p = 1``                ∀ commodity c  (paper Eq. 4)

``C_e = n_e · s_e`` (Eq. 2) makes the load/risk blocks bilinear whenever both
the scalar (u or r) *and* ``n`` are free.  The paper handles this with binary
search (feasibility LPs at fixed u / r); we implement that faithfully in
:mod:`repro.core.solver`, *and* an exact single-LP alternative for stage 1 via
the scaling substitution ``ñ_e = u · n_e`` (then ``load ≤ ñ_e s_e`` and
``Σ ñ ≤ u R_i`` are linear; ``n = ñ / u``) — a beyond-paper improvement
benchmarked in ``benchmarks/bench_solver.py``.

All matrices are scipy.sparse COO → CSR; solved with HiGHS via
``scipy.optimize.linprog``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

from repro_torch.core.graph import Fabric
from repro_torch.core.paths import PathSet

__all__ = ["LpResult", "LpBuilder", "solve_lp", "estimate_delta"]


@dataclasses.dataclass
class LpResult:
    status: int  # scipy linprog status (0 = optimal, 2 = infeasible)
    objective: float
    f: np.ndarray | None  # (P,) path splits
    n: np.ndarray | None  # (E_u,) trunk counts (None if topology fixed)
    scalar: float | None  # u or r when it was a variable

    @property
    def ok(self) -> bool:
        return self.status == 0


class LpBuilder:
    """Assembles the constraint blocks once per (fabric, paths, TMs) triple."""

    def __init__(self, fabric: Fabric, paths: PathSet, tms: np.ndarray, delta: float = 0.0):
        self.fabric = fabric
        self.paths = paths
        self.tms = np.asarray(tms, dtype=np.float64)  # (m, C)
        if self.tms.ndim != 2 or self.tms.shape[1] != paths.n_commodities:
            raise ValueError("tms must be (m, C)")
        self.delta = float(delta)
        self.m = self.tms.shape[0]
        self.P = paths.n_paths
        self.Eu = fabric.n_trunks
        self.Ed = fabric.n_directed
        self.V = fabric.n_pods
        self.trunk_of_edge = fabric.directed_trunk_of_edge()  # (E_d,)
        self.trunk_speed = fabric.trunk_speed()  # (E_u,)
        self.edge_speed = self.trunk_speed[self.trunk_of_edge]  # (E_d,)
        self._load_blocks = self._build_load_blocks()
        self._risk_rows = self._build_risk_rows()
        self._flow = self._build_flow()
        self._radix = self._build_radix()

    # ---- constraint block construction -------------------------------------

    def _build_load_blocks(self):
        """COO triplets of the (m*E_d, P) load operator: row t*Ed+e, col p,
        value d[t, c(p)] for each e ∈ p."""
        pe = self.paths.path_edges  # (P, 2)
        pc = self.paths.path_commodity  # (P,)
        rows, cols, tm_of_row = [], [], []
        for hop in range(2):
            e = pe[:, hop]
            valid = np.nonzero(e >= 0)[0]
            rows.append(e[valid])
            cols.append(valid)
        base_rows = np.concatenate(rows)  # edge index per entry
        base_cols = np.concatenate(cols)  # path index per entry
        return base_rows, base_cols, pc

    def load_matrix(self) -> sp.csr_matrix:
        """(m*E_d, P) sparse matrix A with (A f)[t*Ed+e] = load of edge e under TM t."""
        base_rows, base_cols, pc = self._load_blocks
        rows, cols, vals = [], [], []
        for t in range(self.m):
            d = self.tms[t]
            rows.append(base_rows + t * self.Ed)
            cols.append(base_cols)
            vals.append(d[pc[base_cols]])
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(self.m * self.Ed, self.P),
        )

    def _build_risk_rows(self):
        """List of (path p, directed edge e) pairs for the risk block."""
        pe = self.paths.path_edges
        out = []
        for hop in range(2):
            e = pe[:, hop]
            valid = np.nonzero(e >= 0)[0]
            out.append(np.stack([valid, e[valid]], axis=1))
        return np.concatenate(out, axis=0)  # (R, 2)

    def _build_flow(self) -> sp.csr_matrix:
        """(C, P) equality operator: rows sum path splits per commodity."""
        pc = self.paths.path_commodity
        return sp.csr_matrix(
            (np.ones(self.P), (pc, np.arange(self.P))),
            shape=(self.paths.n_commodities, self.P),
        )

    def _build_radix(self) -> sp.csr_matrix:
        """(V, E_u) operator: sums trunk counts incident to each pod."""
        t = self.fabric.trunks
        rows = np.concatenate([t[:, 0], t[:, 1]])
        cols = np.concatenate([np.arange(self.Eu), np.arange(self.Eu)])
        return sp.csr_matrix((np.ones(2 * self.Eu), (rows, cols)), shape=(self.V, self.Eu))

    def _edge_to_trunk_scatter(self, per_edge_vals: np.ndarray) -> sp.csr_matrix:
        """(m*E_d, E_u) matrix placing -per_edge_vals[row] at column trunk(e)."""
        rows = np.arange(self.m * self.Ed)
        edges = rows % self.Ed
        cols = self.trunk_of_edge[edges]
        return sp.csr_matrix((per_edge_vals, (rows, cols)), shape=(self.m * self.Ed, self.Eu))

    # ---- stage LPs -----------------------------------------------------------

    def solve_stage1_fixed_topology(self, capacities: np.ndarray) -> LpResult:
        """min u  s.t.  load(f) ≤ u·C (C given), flow eq.  Vars: [f, u]."""
        A = self.load_matrix()
        cap = np.tile(np.asarray(capacities, float), self.m)
        a_ub = sp.hstack([A, sp.csr_matrix(-cap[:, None])], format="csr")
        b_ub = np.zeros(A.shape[0])
        a_eq = sp.hstack([self._flow, sp.csr_matrix((self._flow.shape[0], 1))], format="csr")
        b_eq = np.ones(self._flow.shape[0])
        c = np.zeros(self.P + 1)
        c[-1] = 1.0
        res = linprog(c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
                      bounds=[(0, None)] * (self.P + 1), method="highs")
        if res.status != 0:
            return LpResult(res.status, np.inf, None, None, None)
        return LpResult(0, float(res.fun), res.x[: self.P], None, float(res.x[-1]))

    def solve_stage1_joint_scaled(self, min_trunk: float = 0.0) -> LpResult:
        """Beyond-paper exact stage 1 with topology variable, via the scaling
        substitution ``ñ_e = u · (n_e − min_trunk)``:

        min u  s.t.  load(f) ≤ ñ_e·s_e + u·min_trunk·s_e,
                     Σ_{e∋i} ñ_e ≤ u·(R_i − min_trunk·(V−1)),  flow eq.
        Vars: [f, ñ, u].  Recover n = ñ/u + min_trunk.  With ``min_trunk=0``
        this is the plain ñ = u·n trick; with a floor it stays a single LP.
        """
        A = self.load_matrix()
        nscat = self._edge_to_trunk_scatter(np.tile(self.edge_speed, self.m))
        u_load_col = -min_trunk * np.tile(self.edge_speed, self.m)[:, None]
        a_load = sp.hstack([A, -nscat, sp.csr_matrix(u_load_col)], format="csr")
        radix_slack = self.fabric.radix.astype(float) - min_trunk * (self.V - 1)
        if (radix_slack < 0).any():
            raise ValueError("min_trunk floor exceeds some pod's radix")
        a_radix = sp.hstack(
            [sp.csr_matrix((self.V, self.P)), self._radix,
             sp.csr_matrix(-radix_slack[:, None])],
            format="csr",
        )
        a_ub = sp.vstack([a_load, a_radix], format="csr")
        b_ub = np.zeros(a_ub.shape[0])
        a_eq = sp.hstack(
            [self._flow, sp.csr_matrix((self._flow.shape[0], self.Eu + 1))], format="csr")
        b_eq = np.ones(self._flow.shape[0])
        nvar = self.P + self.Eu + 1
        c = np.zeros(nvar)
        c[-1] = 1.0
        res = linprog(c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
                      bounds=[(0, None)] * nvar, method="highs")
        if res.status != 0:
            return LpResult(res.status, np.inf, None, None, None)
        u = float(res.x[-1])
        if u <= 1e-12:  # zero demand: fall back to an (arbitrary) uniform split
            return LpResult(0, 0.0, res.x[: self.P], None, 0.0)
        n = res.x[self.P : self.P + self.Eu] / u + min_trunk
        return LpResult(0, u, res.x[: self.P], n, u)

    def feasibility_joint(self, u: float, r: float | None,
                          min_trunk: float = 0.0) -> LpResult:
        """Paper-faithful feasibility LP at fixed u (and optionally fixed r),
        with topology variable.  Vars: [f, n].

        load(f) ≤ u·s_e·n_e;  [f_p δ ≤ r·s_e·n_e ∀ e ∈ p];  Σ n ≤ R;  flow eq.

        ``min_trunk`` is the anti-stranding floor: every pod pair keeps at
        least this many links so that routing re-solves on the realized
        topology never find a disconnected commodity (DESIGN.md §5).
        """
        A = self.load_matrix()
        nscat = self._edge_to_trunk_scatter(np.tile(u * self.edge_speed, self.m))
        blocks_ub = [sp.hstack([A, -nscat], format="csr")]
        bs = [np.zeros(A.shape[0])]
        if r is not None and self.delta > 0:
            pr = self._risk_rows  # (R, 2): path, edge
            rows = np.arange(pr.shape[0])
            a_f = sp.csr_matrix(
                (np.full(pr.shape[0], self.delta), (rows, pr[:, 0])),
                shape=(pr.shape[0], self.P))
            a_n = sp.csr_matrix(
                (r * self.edge_speed[pr[:, 1]], (rows, self.trunk_of_edge[pr[:, 1]])),
                shape=(pr.shape[0], self.Eu))
            blocks_ub.append(sp.hstack([a_f, -a_n], format="csr"))
            bs.append(np.zeros(pr.shape[0]))
        blocks_ub.append(
            sp.hstack([sp.csr_matrix((self.V, self.P)), self._radix], format="csr"))
        bs.append(self.fabric.radix.astype(float))
        a_ub = sp.vstack(blocks_ub, format="csr")
        b_ub = np.concatenate(bs)
        a_eq = sp.hstack([self._flow, sp.csr_matrix((self._flow.shape[0], self.Eu))],
                         format="csr")
        b_eq = np.ones(self._flow.shape[0])
        bounds = [(0, None)] * self.P + [(min_trunk, None)] * self.Eu
        res = linprog(np.zeros(self.P + self.Eu), A_ub=a_ub, b_ub=b_ub, A_eq=a_eq,
                      b_eq=b_eq, bounds=bounds, method="highs")
        if res.status != 0:
            return LpResult(res.status, np.inf, None, None, None)
        return LpResult(0, 0.0, res.x[: self.P], res.x[self.P :], None)

    def solve_stage2_fixed_topology(self, capacities: np.ndarray, u_star: float) -> LpResult:
        """min r  s.t. load ≤ u*·C, f_p δ ≤ r·C_e.  C fixed ⇒ single LP. Vars: [f, r]."""
        A = self.load_matrix()
        cap = np.tile(np.asarray(capacities, float), self.m)
        a_load = sp.hstack([A, sp.csr_matrix((A.shape[0], 1))], format="csr")
        b_load = u_star * cap
        pr = self._risk_rows
        rows = np.arange(pr.shape[0])
        a_f = sp.csr_matrix((np.full(pr.shape[0], self.delta), (rows, pr[:, 0])),
                            shape=(pr.shape[0], self.P))
        a_r = sp.csr_matrix((-np.asarray(capacities, float)[pr[:, 1]], (rows, np.zeros(pr.shape[0], int))),
                            shape=(pr.shape[0], 1))
        a_risk = sp.hstack([a_f, a_r], format="csr")
        a_ub = sp.vstack([a_load, a_risk], format="csr")
        b_ub = np.concatenate([b_load, np.zeros(pr.shape[0])])
        a_eq = sp.hstack([self._flow, sp.csr_matrix((self._flow.shape[0], 1))], format="csr")
        b_eq = np.ones(self._flow.shape[0])
        c = np.zeros(self.P + 1)
        c[-1] = 1.0
        res = linprog(c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
                      bounds=[(0, None)] * (self.P + 1), method="highs")
        if res.status != 0:
            return LpResult(res.status, np.inf, None, None, None)
        return LpResult(0, float(res.fun), res.x[: self.P], None, float(res.x[-1]))

    def solve_stage3(self, u_star: float, r_star: float | None,
                     capacities: np.ndarray | None,
                     min_trunk: float = 0.0) -> LpResult:
        """min Σ_t Σ_e load  s.t. load ≤ u*·C, [risk ≤ r*·C], radix, flow.

        With ``capacities`` given the topology is fixed (vars [f]); otherwise
        ``n`` is a variable (vars [f, n]) and C_e = n_e s_e with u*, r* constants
        — still a pure LP (paper's stage 3).
        """
        A = self.load_matrix()
        pc = self.paths.path_commodity
        # objective: Σ_t Σ_p f_p d_{t,c(p)} len(p)
        dsum = self.tms.sum(axis=0)  # (C,)
        cost_f = dsum[pc] * self.paths.path_n_edges
        if capacities is not None:
            cap = np.asarray(capacities, float)
            blocks = [A]
            bs = [u_star * np.tile(cap, self.m)]
            if r_star is not None and self.delta > 0:
                pr = self._risk_rows
                rows = np.arange(pr.shape[0])
                a_f = sp.csr_matrix(
                    (np.full(pr.shape[0], self.delta), (rows, pr[:, 0])),
                    shape=(pr.shape[0], self.P))
                blocks.append(a_f)
                bs.append(r_star * cap[pr[:, 1]])
            a_ub = sp.vstack(blocks, format="csr")
            b_ub = np.concatenate(bs)
            res = linprog(cost_f, A_ub=a_ub, b_ub=b_ub, A_eq=self._flow,
                          b_eq=np.ones(self._flow.shape[0]),
                          bounds=[(0, None)] * self.P, method="highs")
            if res.status != 0:
                return LpResult(res.status, np.inf, None, None, None)
            return LpResult(0, float(res.fun), res.x, None, None)
        # topology variable
        nscat = self._edge_to_trunk_scatter(np.tile(u_star * self.edge_speed, self.m))
        blocks = [sp.hstack([A, -nscat], format="csr")]
        bs = [np.zeros(A.shape[0])]
        if r_star is not None and self.delta > 0:
            pr = self._risk_rows
            rows = np.arange(pr.shape[0])
            a_f = sp.csr_matrix((np.full(pr.shape[0], self.delta), (rows, pr[:, 0])),
                                shape=(pr.shape[0], self.P))
            a_n = sp.csr_matrix(
                (r_star * self.edge_speed[pr[:, 1]], (rows, self.trunk_of_edge[pr[:, 1]])),
                shape=(pr.shape[0], self.Eu))
            blocks.append(sp.hstack([a_f, -a_n], format="csr"))
            bs.append(np.zeros(pr.shape[0]))
        blocks.append(sp.hstack([sp.csr_matrix((self.V, self.P)), self._radix], format="csr"))
        bs.append(self.fabric.radix.astype(float))
        a_ub = sp.vstack(blocks, format="csr")
        b_ub = np.concatenate(bs)
        a_eq = sp.hstack([self._flow, sp.csr_matrix((self._flow.shape[0], self.Eu))],
                         format="csr")
        c = np.concatenate([cost_f, np.zeros(self.Eu)])
        bounds = [(0, None)] * self.P + [(min_trunk, None)] * self.Eu
        res = linprog(c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq,
                      b_eq=np.ones(self._flow.shape[0]),
                      bounds=bounds, method="highs")
        if res.status != 0:
            return LpResult(res.status, np.inf, None, None, None)
        return LpResult(0, float(res.fun), res.x[: self.P], res.x[self.P :], None)


def solve_lp(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, bounds=None) -> LpResult:
    """Thin linprog wrapper used by tests to cross-check the JAX PDHG backend."""
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, bounds=bounds,
                  method="highs")
    return LpResult(res.status, float(res.fun) if res.status == 0 else np.inf,
                    res.x if res.status == 0 else None, None, None)


def estimate_delta(demand: np.ndarray, quantile: float = 95.0) -> float:
    """Scalar burst estimate δ (paper §4.4 uses one δ for all pairs): the
    ``quantile`` of positive deviations of demand from each commodity's mean."""
    demand = np.asarray(demand, float)
    dev = demand - demand.mean(axis=0, keepdims=True)
    pos = dev[dev > 0]
    if pos.size == 0:
        return 0.0
    return float(np.percentile(pos, quantile))
