"""Path sets and incidence structures for the joint solver (paper §4.5).

The paper restricts routing to the direct (1-hop) pod-to-pod path plus all
2-hop *transit* paths (footnote 4).  For a ``V``-pod fabric each commodity
``(i, j)`` therefore has ``V - 1`` candidate paths: ``i→j`` and ``i→k→j`` for
every ``k ∉ {i, j}``.

This module enumerates that path set once per fabric size and exposes flat
arrays suitable for vectorised load computation (numpy / JAX / the Pallas
``linkload`` kernel):

* ``path_commodity``: ``(P,)``  — commodity index of each path.
* ``path_edges``:     ``(P, 2)``— directed-edge indices along the path; 1-hop
  paths repeat a sentinel ``-1`` in the second slot.
* ``path_n_edges``:   ``(P,)``  — 1 or 2.
* ``commodity_paths``:``(C, V-1)`` — path indices per commodity (first entry
  is always the direct path).

The *routing weight matrix* ``W[c, e] = Σ_{p ∈ P_c, e ∈ p} f_p`` collapses a
path-split solution into a commodity×edge operator so per-interval loads are a
single matmul: ``load[t, e] = Σ_c d[t, c] · W[c, e]`` — this is the hot spot
the ``kernels/linkload`` Pallas kernel fuses with metric reductions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.graph import Fabric, directed_edge_index

__all__ = ["PathSet", "build_paths", "routing_weight_matrix",
           "routing_weight_matrices"]


@dataclasses.dataclass(frozen=True)
class PathSet:
    n_pods: int
    n_paths: int
    n_commodities: int
    n_directed: int
    path_commodity: np.ndarray  # (P,) int
    path_edges: np.ndarray  # (P, 2) int, -1 padded
    path_n_edges: np.ndarray  # (P,) int in {1, 2}
    commodity_paths: np.ndarray  # (C, V-1) int
    direct_path: np.ndarray  # (C,) int — index of the 1-hop path per commodity

    def paths_of(self, commodity: int) -> np.ndarray:
        return self.commodity_paths[commodity]


@functools.lru_cache(maxsize=64)
def build_paths(n_pods: int) -> PathSet:
    """Enumerate 1-hop + 2-hop paths for every ordered commodity."""
    v = n_pods
    edges = directed_edge_index(v)
    edge_of = {(int(i), int(j)): e for e, (i, j) in enumerate(edges)}
    n_comm = v * (v - 1)

    path_commodity, path_edges, path_n_edges = [], [], []
    commodity_paths = np.full((n_comm, v - 1), -1, dtype=np.int64)
    direct_path = np.empty((n_comm,), dtype=np.int64)

    p = 0
    for c, (i, j) in enumerate(edges):  # commodity enumeration == edge enumeration
        i, j = int(i), int(j)
        # direct path
        path_commodity.append(c)
        path_edges.append((edge_of[(i, j)], -1))
        path_n_edges.append(1)
        commodity_paths[c, 0] = p
        direct_path[c] = p
        p += 1
        # transit paths i -> k -> j
        slot = 1
        for k in range(v):
            if k == i or k == j:
                continue
            path_commodity.append(c)
            path_edges.append((edge_of[(i, k)], edge_of[(k, j)]))
            path_n_edges.append(2)
            commodity_paths[c, slot] = p
            slot += 1
            p += 1

    return PathSet(
        n_pods=v,
        n_paths=p,
        n_commodities=n_comm,
        n_directed=n_comm,
        path_commodity=np.asarray(path_commodity, dtype=np.int64),
        path_edges=np.asarray(path_edges, dtype=np.int64),
        path_n_edges=np.asarray(path_n_edges, dtype=np.int64),
        commodity_paths=commodity_paths,
        direct_path=direct_path,
    )


def routing_weight_matrix(paths: PathSet, f: np.ndarray) -> np.ndarray:
    """Collapse path splits ``f`` (``(P,)``, summing to 1 per commodity) into
    the commodity×edge weight matrix ``W`` (``(C, E_d)``)."""
    f = np.asarray(f, dtype=np.float64)
    if f.shape != (paths.n_paths,):
        raise ValueError(f"f must have shape ({paths.n_paths},), got {f.shape}")
    w = np.zeros((paths.n_commodities, paths.n_directed), dtype=np.float64)
    for hop in range(2):
        e = paths.path_edges[:, hop]
        valid = e >= 0
        np.add.at(w, (paths.path_commodity[valid], e[valid]), f[valid])
    return w


def routing_weight_matrices(paths: PathSet, f: np.ndarray) -> np.ndarray:
    """Batched :func:`routing_weight_matrix`: ``f`` is ``(B, P)`` (one routing
    epoch per row), returns ``(B, C, E_d)``."""
    f = np.asarray(f, dtype=np.float64)
    if f.ndim != 2 or f.shape[1] != paths.n_paths:
        raise ValueError(f"f must have shape (B, {paths.n_paths}), got {f.shape}")
    b = f.shape[0]
    w = np.zeros((b, paths.n_commodities, paths.n_directed), dtype=np.float64)
    rows = np.arange(b)[:, None]
    for hop in range(2):
        e = paths.path_edges[:, hop]
        valid = e >= 0
        np.add.at(w, (rows, paths.path_commodity[valid][None, :],
                      e[valid][None, :]), f[:, valid])
    return w
