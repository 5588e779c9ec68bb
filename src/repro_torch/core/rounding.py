"""Physical realization, part 1: rounding fractional trunks (paper §A, Alg. 1).

Theorem 3: given a (fractional-weight) trunk graph with *even integer* node
degrees and no self-loops, we can round every edge to ⌊n_e⌋ or ⌊n_e⌋+1 while
preserving node degrees exactly, in O(V²):

1. floor every edge; compute residual degrees ``z_v = x_v − y_v`` (integers,
   even sum, and satisfying Erdős–Gallai — proven in the paper's appendix);
2. Hakimi construction: repeatedly connect the node with the largest residual
   to the next-largest residuals, one unit each (adds ≤ 1 to any pair, hence
   final weights stay within {⌊n_e⌋, ⌊n_e⌋+1}).

The LP emits degrees ``Σ_e n_e ≤ R_i`` (not exact, not even), so realization
first *fills* the solution up to the even radix targets with a small
max-utilization matching LP (extra capacity only loosens the LP's upper-bound
constraints, so filling never hurts MLU/risk).  When one pod's free ports
exceed everyone else's combined (Fig. 15-style heterogeneity), the surplus is
left dark and that pod's target is reduced to the nearest feasible even value.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

from repro_torch.core.graph import Fabric, trunk_index

__all__ = ["fill_to_targets", "round_trunks", "realize"]


def _even_floor(x: float) -> int:
    return int(2 * np.floor(x / 2.0 + 1e-9))


def fill_to_targets(fabric: Fabric, n_e: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Adjust fractional trunks so every pod's degree hits an even target ≤ R_i.

    Returns ``(n_adjusted, targets)`` with ``Σ_{e∋i} n_adjusted = targets_i``
    exactly and ``targets_i`` even integers.  Requires even radixes.

    The adjustment is a signed circulation LP: per-trunk *add* (``a_e ≥ 0``)
    and *remove* (``0 ≤ s_e ≤ n_e``) amounts, with exact degree equalities and
    an objective that strongly prefers adding capacity (free — capacities only
    appear as LP upper bounds) over removing it.  This handles the dominant-pod
    case (one pod with surplus ports and no peers: its surplus goes dark, and
    any fractional remainder is shed through an add/remove triangle) exactly.
    """
    n_e = np.asarray(n_e, dtype=np.float64).copy()
    trunks = trunk_index(fabric.n_pods)
    v = fabric.n_pods
    e_u = trunks.shape[0]
    deg = np.zeros(v)
    np.add.at(deg, trunks[:, 0], n_e)
    np.add.at(deg, trunks[:, 1], n_e)
    radix = fabric.radix.astype(np.float64)
    if ((fabric.radix % 2) != 0).any():
        raise ValueError("pod radixes must be even for patch-panel realization")
    if (deg > radix + 1e-6).any():
        raise ValueError("solution exceeds pod radix")
    leftover = np.maximum(radix - deg, 0.0)

    targets = radix.copy()
    # cap a dominant pod whose leftover exceeds everyone else's combined
    a = int(np.argmax(leftover))
    rest = leftover.sum() - leftover[a]
    if leftover[a] > rest + 1e-9:
        targets[a] = _even_floor(deg[a] + rest)

    rows = np.concatenate([trunks[:, 0], trunks[:, 1]])
    cols = np.concatenate([np.arange(e_u), np.arange(e_u)])
    inc = sp.csr_matrix((np.ones(2 * e_u), (rows, cols)), shape=(v, e_u))

    for attempt in range(4):
        gap = targets - deg  # signed
        if np.abs(gap).sum() <= 1e-9:
            return n_e, targets.astype(np.int64)
        # vars x = [a_e, s_e]; degrees: inc @ (a - s) = gap
        a_eq = sp.hstack([inc, -inc], format="csr")
        cost = np.concatenate([np.full(e_u, 1e-3), np.ones(e_u)])
        bounds = [(0, None)] * e_u + [(0, ne) for ne in n_e]
        res = linprog(cost, A_eq=a_eq, b_eq=gap, bounds=bounds, method="highs")
        if res.status == 0:
            out = n_e + res.x[:e_u] - res.x[e_u:]
            return np.maximum(out, 0.0), targets.astype(np.int64)
        # rare corner: lower the most-slack pod's target by 2 and retry
        targets[int(np.argmax(targets - deg))] -= 2
    raise RuntimeError("fill_to_targets: could not reach even-integer degrees")


def round_trunks(n_pods: int, n_e: np.ndarray) -> np.ndarray:
    """Paper Algorithm 1: round fractional trunk weights to integers while
    preserving (even-integer) node degrees.  Input/output are (E_u,) arrays.
    """
    trunks = trunk_index(n_pods)
    n_e = np.asarray(n_e, dtype=np.float64)
    deg = np.zeros(n_pods)
    np.add.at(deg, trunks[:, 0], n_e)
    np.add.at(deg, trunks[:, 1], n_e)
    x = np.rint(deg).astype(np.int64)
    if not np.allclose(deg, x, atol=1e-6):
        raise ValueError("node degrees must be integers (fill the graph first)")
    if (x % 2 != 0).any():
        raise ValueError("node degrees must be even (paper Thm. 3 precondition)")

    floor = np.floor(n_e + 1e-9).astype(np.int64)
    y = np.zeros(n_pods, dtype=np.int64)
    np.add.at(y, trunks[:, 0], floor)
    np.add.at(y, trunks[:, 1], floor)
    z = x - y  # residual degrees
    if z.sum() % 2 != 0:
        raise AssertionError("residual degree sum must be even")

    pair_index = {}
    for e, (i, j) in enumerate(trunks):
        pair_index[(int(i), int(j))] = e
    extra = np.zeros_like(floor)

    # Hakimi: connect max-residual node to the next-z_1 largest residuals.
    z = z.astype(np.int64)
    while z.sum() > 0:
        order = np.argsort(-z, kind="stable")
        v1 = order[0]
        k = z[v1]
        if k <= 0:
            break
        picks = [u for u in order[1:] if z[u] > 0][:k]
        if len(picks) < k:
            raise AssertionError("Erdős–Gallai violated: rounding input malformed")
        for u in picks:
            a, b = (int(v1), int(u)) if v1 < u else (int(u), int(v1))
            e = pair_index[(a, b)]
            if extra[e] >= 1:
                raise AssertionError("Hakimi step would add a parallel extra edge")
            extra[e] += 1
            z[u] -= 1
        z[v1] = 0
    return floor + extra


def realize(fabric: Fabric, n_e: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Full realization: fill to even targets, then round (Algorithm 1).

    Returns ``(n_int, targets)`` — integer trunk counts whose node degrees are
    exactly ``targets`` (even, ≤ radix).
    """
    filled, targets = fill_to_targets(fabric, n_e)
    return round_trunks(fabric.n_pods, filled), targets
