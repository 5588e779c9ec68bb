"""Physical realization, part 2: patch-panel assignment (paper §A, Thm. 4) —
a copy of ``repro/core/patch_panels.py`` with its import rewritten.

Theorem 4: if every pod's (realized) degree is ``2^k``, any integer trunk
topology can be built from ``2^p`` patch panels (``p < k``) with ``2^{k-p}``
ports of every pod wired to every panel — so *reconfiguration never moves
fibers between panels*, only jumpers inside each panel.

Construction (the paper's proof, implemented):

1. expand the integer multigraph into individual links;
2. the multigraph has even degrees → find an Eulerian circuit per connected
   component; orienting edges along the circuit gives in-degree = out-degree
   = degree/2 at every node;
3. the oriented graph's edges, viewed as a bipartite (out-port → in-port)
   multigraph, are ``r``-regular → decompose into ``r`` perfect matchings
   (repeated Hall augmenting paths); each matching pulled back to the
   undirected graph is a **2-factor** (every node has degree exactly 2);
4. group the 2-factors into ``2^p`` panel groups of equal size.

We generalize slightly: degrees need only be *even* (not a power of two); a
pod with degree ``2r_v < 2r_max`` simply contributes fewer links and the
decomposition yields ``r_max`` "2-or-0-factors" (degree ≤ 2 everywhere).  When
the graph is *regular* (``r_v = r_max`` everywhere) and ``panels`` divides
``r_max``, round-robin grouping of the factors meets the fixed per-panel port
budget of ``ceil(2 r_v / panels)`` exactly — for power-of-two radixes this
reduces exactly to Theorem 4.  For irregular graphs (or panel counts that do
not divide ``r_max``) whole-factor grouping can only guarantee the looser
``2 * ceil(n_factors / panels)`` per node; the budget property is tested in
the regular regime (``tests/test_patch_panels.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import trunk_index

__all__ = ["PanelAssignment", "eulerian_orientation", "two_factorize", "assign_panels"]


@dataclasses.dataclass
class PanelAssignment:
    n_panels: int
    # panel_edges[p] is an (L_p, 2) array of pod pairs (one row per physical link)
    panel_edges: list

    def links_per_pod_per_panel(self, n_pods: int) -> np.ndarray:
        out = np.zeros((len(self.panel_edges), n_pods), dtype=np.int64)
        for p, edges in enumerate(self.panel_edges):
            if edges.size:
                np.add.at(out[p], edges.reshape(-1), 1)
        return out


def _expand_links(n_pods: int, n_int: np.ndarray) -> list:
    """Integer trunk counts -> explicit link list [(i, j), ...] (multigraph)."""
    links = []
    for e, (i, j) in enumerate(trunk_index(n_pods)):
        links.extend([(int(i), int(j))] * int(n_int[e]))
    return links


def eulerian_orientation(n_pods: int, links: list) -> list:
    """Orient an even-degree multigraph along Eulerian circuits.

    Returns directed links [(u, v), ...] with in-degree == out-degree at every
    node (per connected component).  Hierholzer's algorithm on an adjacency
    multiset.
    """
    adj = [dict() for _ in range(n_pods)]  # neighbor -> count
    deg = np.zeros(n_pods, dtype=np.int64)
    for u, v in links:
        adj[u][v] = adj[u].get(v, 0) + 1
        adj[v][u] = adj[v].get(u, 0) + 1
        deg[u] += 1
        deg[v] += 1
    if (deg % 2 != 0).any():
        raise ValueError("all degrees must be even for Eulerian orientation")

    directed = []
    remaining = deg.copy()
    for start in range(n_pods):
        while remaining[start] > 0:
            # Hierholzer: walk until back at start, splicing sub-circuits
            stack = [start]
            circuit = []
            while stack:
                u = stack[-1]
                if adj[u]:
                    v = next(iter(adj[u]))
                    adj[u][v] -= 1
                    if adj[u][v] == 0:
                        del adj[u][v]
                    adj[v][u] -= 1
                    if adj[v][u] == 0:
                        del adj[v][u]
                    remaining[u] -= 1
                    remaining[v] -= 1
                    stack.append(v)
                else:
                    circuit.append(stack.pop())
            directed.extend(zip(circuit[:-1], circuit[1:]))
    return directed


def _augment(u0: int, adj: list, match_l: list, match_r: list, n: int) -> bool:
    """One augmenting-path search (Kuhn DFS), iterative.

    The recursive formulation recurses once per edge of the alternating path;
    on large-radix fabrics (F22-class: radix 64, high trunk multiplicity) the
    path can exceed Python's recursion limit, so the DFS keeps an explicit
    stack of ``(left node, neighbor iterator)`` frames instead.  ``via[v]``
    records the left node that first reached right node ``v``; flipping the
    matched edges back along that chain performs the augmentation.
    """
    seen = [False] * n
    via = [-1] * n  # right node -> left node that discovered it
    stack = [(u0, iter(adj[u0]))]
    while stack:
        u, it = stack[-1]
        advanced = False
        for v in it:
            if adj[u][v] <= 0 or seen[v]:
                continue
            seen[v] = True
            via[v] = u
            w = match_r[v]
            if w == -1:
                while True:  # flip along u0 ... via[v] -> v
                    u2 = via[v]
                    prev_v = match_l[u2]
                    match_l[u2] = v
                    match_r[v] = u2
                    if u2 == u0:
                        return True
                    v = prev_v
            stack.append((w, iter(adj[w])))
            advanced = True
            break
        if not advanced:
            stack.pop()
    return False


def _perfect_matching(n: int, adj: list) -> list | None:
    """Hopcroft–Karp-lite: max bipartite matching via repeated augmenting DFS
    (iterative — see :func:`_augment`).  ``adj[u]`` = multiset dict of
    right-nodes.  Returns list pairing each left u with a right node, or None
    if no perfect matching over active nodes."""
    match_l = [-1] * n
    match_r = [-1] * n
    for u in range(n):
        if adj[u] and match_l[u] == -1:
            if not _augment(u, adj, match_l, match_r, n):
                return None
    return match_l


def two_factorize(n_pods: int, n_int: np.ndarray) -> list:
    """Decompose an even-degree integer trunk multigraph into 2-factors.

    Returns a list of factors; each factor is a list of undirected links
    [(i, j), ...] in which every node appears in at most 2 links (exactly 2 for
    nodes of maximal degree; exactly ``deg_v / r_max * ...`` — see module doc).
    """
    links = _expand_links(n_pods, n_int)
    if not links:
        return []
    directed = eulerian_orientation(n_pods, links)
    out_deg = np.zeros(n_pods, dtype=np.int64)
    for u, _ in directed:
        out_deg[u] += 1
    r_max = int(out_deg.max())

    # bipartite multigraph out -> in
    adj = [dict() for _ in range(n_pods)]
    for u, v in directed:
        adj[u][v] = adj[u].get(v, 0) + 1

    factors = []
    for _ in range(r_max):
        m = _perfect_matching(n_pods, adj)
        if m is None:
            # regularize: nodes with smaller degree may be skipped this round.
            # Build matching over only the nodes with the max remaining degree
            # by falling back to greedy peeling of one edge per active node.
            m = [-1] * n_pods
            used_r = set()
            order = np.argsort(-np.array([sum(a.values()) for a in adj]))
            for u in order:
                u = int(u)
                for v in sorted(adj[u], key=lambda vv: -adj[u][vv]):
                    if v not in used_r and adj[u][v] > 0:
                        m[u] = v
                        used_r.add(v)
                        break
        factor = []
        for u, v in enumerate(m):
            if v is None or v < 0:
                continue
            adj[u][v] -= 1
            if adj[u][v] == 0:
                del adj[u][v]
            factor.append((min(u, v), max(u, v)))
        if factor:
            factors.append(factor)
    # anything left (irregular fallback) becomes extra factors greedily
    leftovers = [(u, v) for u in range(n_pods) for v, c in adj[u].items() for _ in range(c)]
    while leftovers:
        used = set()
        factor = []
        rest = []
        for u, v in leftovers:
            if u in used or v in used:
                rest.append((u, v))
                continue
            used.add(u)
            used.add(v)
            factor.append((min(u, v), max(u, v)))
        factors.append(factor)
        leftovers = rest
    return factors


def assign_panels(n_pods: int, n_int: np.ndarray, n_panels: int) -> PanelAssignment:
    """Group 2-factors into ``n_panels`` balanced panel groups (Theorem 4)."""
    factors = two_factorize(n_pods, n_int)
    groups = [[] for _ in range(n_panels)]
    for idx, factor in enumerate(factors):
        groups[idx % n_panels].extend(factor)
    return PanelAssignment(
        n_panels=n_panels,
        panel_edges=[np.asarray(g, dtype=np.int64).reshape(-1, 2) for g in groups],
    )
