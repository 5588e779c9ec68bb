"""Pod-level fabric graph model (paper §4.5 "Notation" + "Modeling pod heterogeneity").

The DCNI is modeled as a complete undirected trunk graph over pods.  Trunk
(i, j) carries ``n_e`` physical links; each link runs at the *lower* of the two
pods' port speeds (Equation 2 of the paper), so the directed capacity of the
trunk is ``C_e = n_e * min(s_i, s_j)`` in each direction (full-duplex fiber).

Indexing conventions used throughout ``repro.core``:

* ``n_pods``: number of pods, ``V``.
* *trunks* are undirected pod pairs ``(i, j), i < j`` — ``E_u = V*(V-1)/2``.
* *directed edges* are ordered pairs ``(i, j), i != j`` — ``E_d = V*(V-1)``;
  directed edge ``(i, j)`` and ``(j, i)`` share the same trunk (and hence the
  same ``n_e``), but carry independent load.
* *commodities* are ordered pod pairs ``(src, dst)`` — one row of a traffic
  matrix. Commodity index == directed edge index (same enumeration).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Fabric",
    "trunk_index",
    "directed_edge_index",
    "uniform_topology",
]


def trunk_index(n_pods: int) -> np.ndarray:
    """Return an ``(E_u, 2)`` array of undirected trunk endpoints, i < j."""
    pairs = [(i, j) for i in range(n_pods) for j in range(i + 1, n_pods)]
    return np.asarray(pairs, dtype=np.int32)


def directed_edge_index(n_pods: int) -> np.ndarray:
    """Return an ``(E_d, 2)`` array of directed edge endpoints, i != j."""
    pairs = [(i, j) for i in range(n_pods) for j in range(n_pods) if i != j]
    return np.asarray(pairs, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class Fabric:
    """A pod-level fabric: per-pod DCNI radix and port speed.

    Attributes:
      name: fabric identifier (e.g. ``"F5"``).
      radix: ``(V,)`` int array — DCNI-facing ports per pod (paper's ``R_i``).
      speed: ``(V,)`` float array — uplink rate per port (e.g. Gb/s).
    """

    name: str
    radix: np.ndarray
    speed: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "radix", np.asarray(self.radix, dtype=np.int64))
        object.__setattr__(self, "speed", np.asarray(self.speed, dtype=np.float64))
        if self.radix.shape != self.speed.shape:
            raise ValueError("radix and speed must have the same shape")
        if (self.radix <= 0).any() or (self.speed <= 0).any():
            raise ValueError("radix and speed must be positive")

    @property
    def n_pods(self) -> int:
        return int(self.radix.shape[0])

    @property
    def n_trunks(self) -> int:
        v = self.n_pods
        return v * (v - 1) // 2

    @property
    def n_directed(self) -> int:
        v = self.n_pods
        return v * (v - 1)

    @property
    def trunks(self) -> np.ndarray:
        return trunk_index(self.n_pods)

    @property
    def directed(self) -> np.ndarray:
        return directed_edge_index(self.n_pods)

    def trunk_speed(self) -> np.ndarray:
        """``(E_u,)`` per-link speed of each trunk: min of endpoint speeds (Eq. 2)."""
        t = self.trunks
        return np.minimum(self.speed[t[:, 0]], self.speed[t[:, 1]])

    def directed_trunk_of_edge(self) -> np.ndarray:
        """``(E_d,)`` map from directed edge index to undirected trunk index."""
        v = self.n_pods
        lut = {}
        for e, (i, j) in enumerate(trunk_index(v)):
            lut[(int(i), int(j))] = e
        out = np.empty(self.n_directed, dtype=np.int64)
        for d, (i, j) in enumerate(directed_edge_index(v)):
            a, b = (int(i), int(j)) if i < j else (int(j), int(i))
            out[d] = lut[(a, b)]
        return out

    def capacities(self, n_e: np.ndarray) -> np.ndarray:
        """Directed per-edge capacity ``(E_d,)`` from trunk link counts ``(E_u,)``."""
        per_dir = np.asarray(n_e, dtype=np.float64) * self.trunk_speed()
        return per_dir[self.directed_trunk_of_edge()]

    def total_ports(self) -> int:
        return int(self.radix.sum())

    def pod_capacity(self) -> np.ndarray:
        """``(V,)`` aggregate DCNI capacity of each pod: radix * speed."""
        return self.radix.astype(np.float64) * self.speed

    @staticmethod
    def homogeneous(name: str, n_pods: int, radix: int, speed: float = 100.0) -> "Fabric":
        return Fabric(
            name=name,
            radix=np.full((n_pods,), radix, dtype=np.int64),
            speed=np.full((n_pods,), float(speed)),
        )


def uniform_topology(fabric: Fabric) -> np.ndarray:
    """The paper's *uniform* topology: the same number of links between every
    pod pair (possibly fractional; realization rounds later).

    With heterogeneous radixes a uniform topology cannot use every port of the
    larger pods (paper Fig. 15); we use ``min_i R_i / (V - 1)`` trunks per pair,
    which is the largest uniform allocation that respects every radix.
    """
    v = fabric.n_pods
    if v < 2:
        raise ValueError("need at least two pods")
    per_pair = float(fabric.radix.min()) / float(v - 1)
    return np.full((fabric.n_trunks,), per_pair, dtype=np.float64)
