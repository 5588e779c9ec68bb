"""Sub-interval burst expander: 5-minute TM means → short-timescale samples.

A measurement interval reports the *average* demand of each commodity; real
traffic inside the interval carries sub-second to tens-of-seconds bursts that
the average hides (paper §2, Fig. 4).  The expander refines a ``(T, C)``
interval trace into ``(T·S, C)`` sub-interval samples:

    sub[t·S + s, c] = demand[t, c] · (1 + burst[t, s, c])

where ``burst`` is zero except at Bernoulli(``rate``) positions, which draw a
Pareto(``shape``) magnitude scaled by ``scale`` — the same heavy-tailed
family (and per-fabric calibration) that :mod:`repro.core.fleet` uses for
interval-level bursts.  Bursts are *additive on top of the interval mean*: a
zero-burst expansion reproduces the mean exactly in every sub-step, so a
trace with MLU < 1 sees zero loss (the acceptance anchor of the model).

Generation is deterministic per ``(seed, shape of the block)``: the same
demand block with the same seed always sees the same bursts, so strategies
compared on the same trace are compared under *identical* burst realizations
(paired common random numbers).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BurstParams", "from_fleet_spec", "expand"]


@dataclasses.dataclass(frozen=True)
class BurstParams:
    """Heavy-tailed sub-interval burst model for one fabric.

    Attributes:
      rate: per-(sub-step, commodity) burst probability in [0, 1].
      shape: Pareto tail index (lower = heavier tail), as in
        :class:`repro.core.fleet.FabricSpec`.
      scale: burst magnitude multiplier, × the commodity's interval mean.
      clip: ceiling on the total burst multiplier.  Offered load is bounded
        by finite server NICs, so a commodity cannot burst arbitrarily far
        above its mean — the same saturation argument behind the AR-noise
        ceiling in :mod:`repro.core.fleet`.  ``inf`` disables.
    """

    rate: float
    shape: float
    scale: float
    clip: float = float("inf")

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError("burst rate must be in [0, 1]")
        if self.shape <= 0:
            raise ValueError("Pareto shape must be positive")
        if self.scale < 0:
            raise ValueError("burst scale must be non-negative")
        if self.clip <= 0:
            raise ValueError("burst clip must be positive")

    @property
    def is_zero(self) -> bool:
        return self.rate == 0.0 or self.scale == 0.0

    @staticmethod
    def zero() -> "BurstParams":
        return BurstParams(rate=0.0, shape=2.5, scale=0.0)


def from_fleet_spec(spec, rate_boost: float = 4.0,
                    attenuation: float = 0.5, clip: float = 8.0) -> BurstParams:
    """Calibrate sub-interval bursts from a fleet :class:`FabricSpec`.

    ``spec.burst_rate/shape/scale`` describe *interval-level* bursts (spikes
    that survive 5-minute averaging).  Short bursts are more frequent but
    smaller: ``rate_boost`` scales the per-sub-step probability up and
    ``attenuation`` scales the magnitude down, keeping the fleet's volatility
    ordering (F3/F6 burstiest, F1 calmest) intact at the sub-interval
    timescale.  The default ``rate_boost`` keeps bursts *sparse* (roughly one
    active bursting commodity per sub-step on the burstiest fabrics) — the
    unpredicted-single-spike regime hedging targets (§3); the rate is also
    capped at 0.1, beyond which "bursts" would be the steady state rather
    than excursions.  Burst multipliers are clipped at ``clip`` (finite
    server NICs bound offered load).  Accepts any object with
    ``burst_rate/burst_shape/burst_scale`` attributes, so it does not import
    :mod:`repro.core.fleet`.
    """
    return BurstParams(
        rate=min(0.1, rate_boost * float(spec.burst_rate)),
        shape=float(spec.burst_shape),
        scale=attenuation * float(spec.burst_scale),
        clip=clip,
    )


def expand(demand: np.ndarray, n_sub: int, params: BurstParams,
           seed: int = 0) -> np.ndarray:
    """Expand a ``(T, C)`` interval-mean block into ``(T·S, C)`` sub-samples.

    Each interval mean is repeated ``n_sub`` times; Bernoulli-placed Pareto
    bursts are added on top (relative to the commodity's interval mean).
    Deterministic per ``seed``; ``params.is_zero`` short-circuits to an exact
    repeat.
    """
    demand = np.asarray(demand, dtype=np.float64)
    if demand.ndim != 2:
        raise ValueError(f"demand must be (T, C); got {demand.shape}")
    if n_sub < 1:
        raise ValueError("n_sub must be >= 1")
    sub = np.repeat(demand, n_sub, axis=0)
    if params.is_zero:
        return sub
    rng = np.random.default_rng(seed)
    hit = rng.random(sub.shape) < params.rate
    mag = params.scale * (rng.pareto(params.shape, size=sub.shape) + 1.0)
    mag = np.minimum(mag, params.clip)
    return sub * (1.0 + hit * mag)
