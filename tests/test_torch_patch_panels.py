"""Port vs reference: patch-panel assignment (paper §A, Thm. 4).

``repro_torch.core.patch_panels`` is a copy of ``repro/core/patch_panels.py``
with its import rewritten, so every function gives the reference's output
exactly (integer arithmetic; ``==`` on every array and list): the Eulerian
orientation, the 2-factorization, the perfect matching on a deep augmenting
chain, the panel grouping, and the per-panel port counts — on realized
topologies of the synthetic fleet, on random regular multigraphs and on an
irregular one (the greedy fallback).
"""

import numpy as np
import pytest

import repro.core.patch_panels as ref_pp
import repro_torch.core.patch_panels as port_pp
from repro.core.fleet import FLEET_SPECS, make_fabric
from repro.core.graph import trunk_index, uniform_topology
from repro.core.rounding import realize


def _regular_multigraph(v: int, r: int, seed: int) -> np.ndarray:
    """2r-regular loopless multigraph on v nodes: union of r random
    Hamiltonian cycles, as integer trunk counts (E_u,)."""
    rng = np.random.default_rng(seed)
    trunks = trunk_index(v)
    lut = {(int(i), int(j)): e for e, (i, j) in enumerate(trunks)}
    n_int = np.zeros(trunks.shape[0], dtype=np.int64)
    for _ in range(r):
        perm = rng.permutation(v)
        for a, b in zip(perm, np.roll(perm, -1)):
            n_int[lut[(min(a, b), max(a, b))]] += 1
    return n_int


def _irregular_multigraph(v: int, seed: int) -> np.ndarray:
    """Even degrees that differ between nodes: random even trunk counts."""
    rng = np.random.default_rng(seed)
    return 2 * rng.integers(0, 4, size=trunk_index(v).shape[0])


def _realized(idx: int) -> tuple:
    fab = make_fabric(FLEET_SPECS[idx])
    return fab.n_pods, realize(fab, uniform_topology(fab))[0]


CASES = {
    "regular_v5_r4": lambda: (5, _regular_multigraph(5, 4, 1)),
    "regular_v8_r8": lambda: (8, _regular_multigraph(8, 8, 3)),
    "regular_v12_r32": lambda: (12, _regular_multigraph(12, 32, 5)),
    "irregular_v7": lambda: (7, _irregular_multigraph(7, 2)),
    "irregular_v9": lambda: (9, _irregular_multigraph(9, 11)),
    "F1_uniform": lambda: _realized(0),
    "F18_uniform": lambda: _realized(17),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_factorize_matches_reference(case):
    v, n_int = CASES[case]()
    links = ref_pp._expand_links(v, n_int)
    assert port_pp._expand_links(v, n_int) == links
    assert (port_pp.eulerian_orientation(v, links)
            == ref_pp.eulerian_orientation(v, links))
    assert port_pp.two_factorize(v, n_int) == ref_pp.two_factorize(v, n_int)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n_panels", [1, 3, 4])
def test_assign_panels_matches_reference(case, n_panels):
    v, n_int = CASES[case]()
    ref = ref_pp.assign_panels(v, n_int, n_panels)
    port = port_pp.assign_panels(v, n_int, n_panels)
    assert port.n_panels == ref.n_panels == n_panels
    assert len(port.panel_edges) == len(ref.panel_edges)
    for a, b in zip(port.panel_edges, ref.panel_edges):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.links_per_pod_per_panel(v),
                                  ref.links_per_pod_per_panel(v))
    assert port.links_per_pod_per_panel(v).sum() == 2 * n_int.sum()


def test_perfect_matching_matches_reference_on_a_deep_chain():
    """The chain that forces an augmenting path as long as the graph (the
    iterative search, not recursion), and an infeasible instance."""
    n = 3000
    adj = [{min(u + 1, n - 1): 1, u: 1} for u in range(n)]
    m = port_pp._perfect_matching(n, [dict(a) for a in adj])
    assert m == ref_pp._perfect_matching(n, [dict(a) for a in adj])
    assert sorted(m) == list(range(n))
    assert port_pp._perfect_matching(3, [{0: 1}, {0: 1}, {}]) is None


def test_odd_degree_raises_as_in_reference():
    with pytest.raises(ValueError, match="even"):
        port_pp.eulerian_orientation(3, [(0, 1)])
    with pytest.raises(ValueError, match="even"):
        ref_pp.eulerian_orientation(3, [(0, 1)])
