"""Failure-model knobs and the expected-vs-worst-case trade-off weight — a
copy of ``repro/failures/config.py``.

Kept dependency-free (dataclasses only) so :mod:`repro_torch.core.controller` can
import the config without pulling the scenario sampler / evaluation machinery
into its import graph — the same layering contract as
:mod:`repro_torch.transition.config`.
"""

from __future__ import annotations

import dataclasses

__all__ = ["FailureConfig"]


@dataclasses.dataclass(frozen=True)
class FailureConfig:
    """Contingency-analysis settings (see README "Failure model").

    ``ControllerConfig.failures = None`` (the default) disables contingency
    analysis entirely — controller output is bit-identical to the
    pre-failures behavior (test-enforced).  With a config set, every sweep
    additionally evaluates its realized plan under ``n_scenarios`` sampled
    failure contingencies and attaches a
    :class:`repro_torch.failures.evaluate.ContingencyReport` to the result.

    Scenario sampling is deterministic per ``(fabric.name, seed)`` — not per
    strategy, not per plan — so hedged and unhedged sweeps of the same fabric
    are always scored under *identical* failure draws (paired comparisons,
    mirroring the paired burst-loss seeds).

    Attributes:
      n_scenarios: contingencies sampled per sweep (the extra leading vmap
        axis of the fused evaluation).
      p_link: per-physical-link independent failure probability.  Each trunk
        keeps a Binomial-surviving fraction of its links.
      p_trunk: per-trunk whole-cut probability (fiber bundle / conduit cut:
        both directions of the pair lose all capacity).
      p_panel: per-scenario probability that one patch panel faults; every
        trunk loses the fraction of its links that the panel decomposition
        (:func:`repro_torch.core.patch_panels.assign_panels`) routes through that
        panel — the correlated multi-trunk failure mode OCS fabrics see.
      n_panels: panels used for the panel-fault model (independent of any
        ``TransitionConfig.n_panels``; defaults match).
      p_pod: per-pod degradation probability (e.g. a DCNI-facing linecard
        loss); a degraded pod's every incident edge keeps ``pod_degrade``
        of its capacity.
      pod_degrade: surviving capacity fraction of a degraded pod's edges.
      resolve: re-solve routing per scenario (what-if TE response, MLU-only:
        the re-solve skips stage 3) instead of evaluating the plan's fixed
        routing under the masked capacities (the default — models failures
        faster than the TE control loop).
      contingency_weight: None (default) keeps decision policies
        (``pick_best``, ``should_reconfigure``) untouched; a weight ``w`` in
        [0, 1] blends expected-case and worst-contingency objectives as
        ``(1-w)·expected + w·worst`` in both policies (``w=0`` is exactly
        legacy arithmetic).
      seed: base seed of the per-fabric crc32 scheme.
    """

    n_scenarios: int = 64
    p_link: float = 0.02
    p_trunk: float = 0.0
    p_panel: float = 0.0
    n_panels: int = 4
    p_pod: float = 0.0
    pod_degrade: float = 0.5
    resolve: bool = False
    contingency_weight: float | None = None
    seed: int = 0

    def __post_init__(self):
        if self.n_scenarios < 1:
            raise ValueError("n_scenarios must be >= 1")
        for name in ("p_link", "p_trunk", "p_panel", "p_pod", "pod_degrade"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]")
        if self.n_panels < 1:
            raise ValueError("n_panels must be >= 1")
        if self.contingency_weight is not None and not (
                0.0 <= self.contingency_weight <= 1.0):
            raise ValueError("contingency_weight must be None or in [0, 1]")
