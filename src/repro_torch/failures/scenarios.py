"""Seeded failure-scenario sampler: link, trunk, panel, and pod contingencies
— a copy of ``repro/failures/scenarios.py`` with its imports rewritten.

A *scenario* is a multiplicative capacity retention profile: per-trunk keep
fractions (what share of the trunk's physical links survive) plus per-pod
keep fractions (degraded pod hardware).  Scenarios never mutate a topology —
they compose with whatever capacities a plan realized (including transition
drain residuals) as masks, see :mod:`repro_torch.failures.mask`.

Sampling is deterministic per ``(fabric.name, FailureConfig.seed)`` through
the same crc32 scheme :mod:`repro_torch.core.fleet` uses for fabric/trace
generation (process-stable, unlike salted ``hash()``).  Each failure
component draws from its *own* independent generator, so the link-failure
draws of scenario k do not shift when, say, ``p_panel`` is turned on — and,
critically, the draws depend on nothing strategy- or plan-specific: hedged
and unhedged sweeps of one fabric are always evaluated under identical
contingencies (paired sampling, the same variance-free-comparison contract
as the paired burst-loss seeds).

The physical-link reference for Binomial link failures and panel fractions
is the fabric's realized *uniform* topology (:func:`repro_torch.core.rounding.
realize` of :func:`repro_torch.core.graph.uniform_topology`) — a plan-independent
integer link count per trunk, so scenario sets stay identical across
strategies that realize different topologies.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.graph import Fabric, trunk_index, uniform_topology
from repro_torch.core.patch_panels import assign_panels
from repro_torch.core.rounding import realize

__all__ = ["ScenarioSet", "scenario_seed", "panel_fractions",
           "sample_scenarios"]


def scenario_seed(fabric_name: str, seed: int, component: str) -> int:
    """Process-stable per-(fabric, seed, component) RNG seed.

    The ``failures.`` namespace keeps these draws disjoint from the fleet
    generator's ``fabric``/``trace`` streams under the same base seed.
    """
    return zlib.crc32(f"{fabric_name}/{seed}/failures.{component}".encode())


@dataclasses.dataclass(frozen=True)
class ScenarioSet:
    """K sampled contingencies for one fabric.

    Attributes:
      trunk_keep: ``(K, E_u)`` surviving capacity fraction per trunk
        (independent link failures × whole-trunk cuts × panel faults,
        composed multiplicatively under the usual independence
        approximation).
      pod_keep: ``(K, V)`` surviving capacity fraction per pod.
      n_failed_links: ``(K,)`` physical links lost per scenario (trunk-level
        mechanisms only — the survivability curves' x-axis).
      n_ref_links: ``(E_u,)`` reference physical links per trunk.
    """

    trunk_keep: np.ndarray
    pod_keep: np.ndarray
    n_failed_links: np.ndarray
    n_ref_links: np.ndarray

    @property
    def n_scenarios(self) -> int:
        return int(self.trunk_keep.shape[0])


def panel_fractions(n_pods: int, n_ref: np.ndarray,
                    n_panels: int) -> np.ndarray:
    """``(P, E_u)`` fraction of each trunk's links carried by each panel.

    A faulted panel takes down exactly its share of every trunk — the
    correlated failure mode the panel decomposition (§A / Thm. 4) induces.
    Trunks with no reference links carry zeros.
    """
    asg = assign_panels(n_pods, np.asarray(n_ref, np.int64), n_panels)
    lut = {(int(i), int(j)): e for e, (i, j) in enumerate(trunk_index(n_pods))}
    counts = np.zeros((asg.n_panels, len(lut)), np.float64)
    for p, edges in enumerate(asg.panel_edges):
        for i, j in edges:
            a, b = (int(i), int(j)) if i < j else (int(j), int(i))
            counts[p, lut[(a, b)]] += 1.0
    denom = np.maximum(np.asarray(n_ref, np.float64), 1.0)
    return counts / denom[None, :]


def sample_scenarios(fabric: Fabric, fcfg) -> ScenarioSet:
    """Sample ``fcfg.n_scenarios`` contingencies for ``fabric``.

    Deterministic per ``(fabric.name, fcfg.seed)`` and per failure component
    — see the module docstring for the pairing contract.
    """
    k = fcfg.n_scenarios
    e_u = fabric.n_trunks
    v = fabric.n_pods
    n_ref = np.asarray(realize(fabric, uniform_topology(fabric))[0], np.int64)
    n_ref_f = n_ref.astype(np.float64)

    def rng(component: str):
        return np.random.default_rng(
            scenario_seed(fabric.name, fcfg.seed, component))

    trunk_keep = np.ones((k, e_u), np.float64)
    if fcfg.p_link > 0.0:
        failed = rng("link").binomial(n_ref[None, :], fcfg.p_link,
                                      size=(k, e_u))
        trunk_keep *= np.where(n_ref[None, :] > 0,
                               (n_ref_f[None, :] - failed)
                               / np.maximum(n_ref_f[None, :], 1.0), 1.0)
    if fcfg.p_trunk > 0.0:
        cut = rng("trunk").random((k, e_u)) < fcfg.p_trunk
        trunk_keep *= np.where(cut, 0.0, 1.0)
    if fcfg.p_panel > 0.0:
        g = rng("panel")
        # draw the faulted panel id unconditionally so the stream never
        # shifts with p_panel
        faulted = g.random(k) < fcfg.p_panel
        panel_id = g.integers(0, fcfg.n_panels, size=k)
        frac = panel_fractions(v, n_ref, fcfg.n_panels)  # (P, E_u)
        trunk_keep *= np.where(faulted[:, None],
                               1.0 - frac[panel_id], 1.0)
    pod_keep = np.ones((k, v), np.float64)
    if fcfg.p_pod > 0.0:
        degraded = rng("pod").random((k, v)) < fcfg.p_pod
        pod_keep = np.where(degraded, fcfg.pod_degrade, 1.0)
    n_failed = np.rint(((1.0 - trunk_keep) * n_ref_f[None, :])
                       .sum(axis=1)).astype(np.int64)
    return ScenarioSet(trunk_keep=trunk_keep, pod_keep=pod_keep,
                       n_failed_links=n_failed, n_ref_links=n_ref)
