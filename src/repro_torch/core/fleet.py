"""Calibrated synthetic fleet: 22 fabrics with paper-§2 traffic statistics.

The paper's dataset (6 months of 5-minute TMs from 22 production fabrics) is
proprietary.  We synthesize a fleet whose *measured statistics reproduce the
paper's published observations*:

* skew (Fig. 5): for ~half the fabrics, ≤30% of pod-pairs carry 80% of traffic
  (gravity model with lognormal pod masses; per-fabric skew parameter);
* boundedness (Fig. 6): ~17/22 fabrics have well-bounded fraction p > 0.9,
  with a worst fabric near p ≈ 0.68 (per-fabric burst rate/scale);
* DMR tails (Fig. 7): max DMR ranges ~3 (predictable) to ~13 (volatile);
* dynamism (Fig. 4): diurnal + weekly seasonality, AR(1) noise, Pareto bursts;
* heterogeneity (§4.5): some fabrics mix 40/100/200G port speeds and radixes.

Generation is deterministic per (fabric index, seed).  Traffic units are Gb/s;
demand is scaled so the *uniform topology* sees a configurable target
utilization, keeping all fabrics in a realistic operating regime.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.graph import Fabric, directed_edge_index, uniform_topology
from repro_torch.core.traffic import Trace

__all__ = ["FabricSpec", "FLEET_SPECS", "make_fabric", "make_trace", "make_fleet",
           "sub_burst_params", "pad_pods", "commodity_slots", "scatter_pad",
           "fleet_bucket_key"]


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    name: str
    n_pods: int
    radix_choices: tuple  # per-pod radix drawn from these
    speed_choices: tuple  # per-pod port speed (Gb/s)
    skew_sigma: float  # lognormal sigma of pod masses (higher = more skewed)
    burst_rate: float  # per-commodity burst probability per interval
    burst_shape: float  # Pareto tail index (lower = heavier tail)
    burst_scale: float  # burst magnitude relative to base demand
    noise: float  # AR(1) innovation scale
    target_uniform_mlu: float  # demand scaled so uniform topology sees this MLU


def _specs() -> tuple:
    """22 fabrics: F1..F22. Volatility/skew profiles span the paper's range.

    F1 is the most predictable (max DMR ≈ 3); F3 the least bounded (p ≈ 0.68);
    F6 volatile (max DMR ≈ 13).  Half the fleet is high-skew, half near-uniform.
    """
    specs = []
    rng = np.random.default_rng(20210817)  # fixed fleet layout
    for idx in range(22):
        name = f"F{idx + 1}"
        n_pods = int(rng.integers(6, 13))
        high_skew = idx % 2 == 0  # 11 of 22 fabrics (paper: 11/22 skewed)
        if name == "F1":
            vol = 0.05
        elif name == "F3":
            vol = 1.0
        elif name == "F6":
            vol = 0.75
        else:
            # most fabrics predictable (paper: 17/22 mostly-bounded)
            vol = float(rng.uniform(0.02, 0.3)) if idx % 5 else float(rng.uniform(0.5, 0.9))
        mixed = idx % 3 == 0  # some fabrics mix line rates / radixes
        specs.append(
            FabricSpec(
                name=name,
                n_pods=n_pods,
                radix_choices=(32, 64) if mixed else (64,),
                speed_choices=(40.0, 100.0) if mixed else (100.0,),
                skew_sigma=1.1 if high_skew else 0.25,
                burst_rate=2e-5 + 2.5e-3 * vol**2,
                burst_shape=1.6 if vol > 0.7 else 2.5,
                burst_scale=1.0 + 6.0 * vol,
                noise=0.05 + 0.3 * vol,
                target_uniform_mlu=float(rng.uniform(0.35, 0.6)),
            )
        )
    return tuple(specs)


FLEET_SPECS = _specs()


def sub_burst_params(spec: FabricSpec, **kwargs):
    """Sub-interval burst calibration for ``spec`` (see :mod:`repro.burst`).

    Reuses the fabric's interval-level ``burst_rate/shape/scale`` so the
    fleet's volatility ordering carries over to the burst-loss timescale.
    Keyword arguments (``rate_boost``, ``attenuation``, ``clip``) forward to
    :func:`repro.burst.expander.from_fleet_spec`, which owns the defaults.
    Returns a :class:`repro.burst.BurstParams`.
    """
    from repro_torch.burst.expander import from_fleet_spec

    return from_fleet_spec(spec, **kwargs)


def _stable_seed(name: str, seed: int, kind: str) -> int:
    """Process-independent RNG seed.  Python's ``hash()`` of strings is
    salted per process (PYTHONHASHSEED), which silently broke the
    deterministic-per-(fabric, seed) contract across runs."""
    return zlib.crc32(f"{name}/{seed}/{kind}".encode())


def make_fabric(spec: FabricSpec, seed: int = 0) -> Fabric:
    rng = np.random.default_rng(_stable_seed(spec.name, seed, "fabric"))
    radix = rng.choice(spec.radix_choices, size=spec.n_pods)
    speed = rng.choice(spec.speed_choices, size=spec.n_pods)
    # keep radixes even (patch-panel theorem applies to even degrees)
    radix = (radix // 2) * 2
    return Fabric(name=spec.name, radix=radix, speed=speed)


def make_trace(
    spec: FabricSpec,
    fabric: Fabric,
    days: float = 42.0,
    interval_minutes: float = 15.0,
    seed: int = 0,
) -> Trace:
    """Generate a (T, C) trace for one fabric."""
    rng = np.random.default_rng(_stable_seed(spec.name, seed, "trace"))
    v = fabric.n_pods
    c = v * (v - 1)
    ipd = int(round(24 * 60 / interval_minutes))
    t = int(round(days * ipd))

    # gravity-model base TM from lognormal pod masses
    mass = rng.lognormal(mean=0.0, sigma=spec.skew_sigma, size=v)
    src = np.repeat(np.arange(v), v - 1)
    dst = np.concatenate([[j for j in range(v) if j != i] for i in range(v)])
    base = mass[src] * mass[dst]
    base = base / base.mean()

    # temporal structure: exactly-periodic diurnal/weekly envelope
    vol = max(0.0, (spec.noise - 0.05) / 0.3)  # recover the volatility knob
    steps = np.arange(t)
    hours = steps * (interval_minutes / 60.0)
    phase = rng.uniform(0, 2 * np.pi, size=c)
    amp_d = rng.uniform(0.1, 0.35, size=c)
    diurnal = 1.0 + amp_d[None, :] * np.sin(2 * np.pi * hours[:, None] / 24.0 + phase[None, :])
    amp_w = 0.15 * min(1.0, 2.0 * vol)
    weekly = 1.0 + amp_w * np.sin(2 * np.pi * hours[:, None] / (24.0 * 7) + phase[None, :] / 2)

    # AR(1) multiplicative noise with *saturating* upper clip: production
    # demand is bounded by finite offered load, so predictable fabrics sit AT
    # their envelope with high probability (point mass at the ceiling) — that
    # is precisely what makes the trailing weekly max a valid bound (§2).
    # Volatile fabrics get a higher ceiling (k·σ) and roam above the envelope.
    ar = np.empty((t, c))
    x = rng.normal(0, spec.noise, size=c)
    rho = 0.9
    innov = rng.normal(0, spec.noise, size=(t, c))
    for k in range(t):
        x = rho * x + np.sqrt(1 - rho**2) * innov[k]
        ar[k] = x
    clip_hi = spec.noise * max(0.0, 4.0 * (vol - 0.35))
    ar = np.exp(np.clip(ar + spec.noise, None, clip_hi) - clip_hi)
    # ar ≤ 1 with P(ar = 1) high for predictable fabrics; volatile fabrics
    # effectively rescale (constant factor absorbed by the MLU normalization).

    demand = base[None, :] * diurnal * weekly * ar

    # Pareto bursts: sudden multi-interval spikes on random commodities
    n_bursts = rng.binomial(t * c, spec.burst_rate)
    if n_bursts > 0:
        bi = rng.integers(0, t, size=n_bursts)
        bj = rng.integers(0, c, size=n_bursts)
        mag = spec.burst_scale * (rng.pareto(spec.burst_shape, size=n_bursts) + 1.0)
        dur = rng.integers(1, max(2, ipd // 8), size=n_bursts)
        for b in range(n_bursts):
            demand[bi[b] : bi[b] + dur[b], bj[b]] += mag[b] * base[bj[b]]

    # scale demand so the uniform topology would see target MLU at the mean
    trace = Trace(spec.name, demand, interval_minutes, v)
    n_uni = uniform_topology(fabric)
    cap = fabric.capacities(n_uni)  # (E_d,)
    # direct-path-only load on the uniform topology = demand itself per edge
    mean_load = demand.mean(axis=0)  # (C,) == (E_d,)
    mlu_now = float((mean_load / cap).max())
    scale = spec.target_uniform_mlu / max(mlu_now, 1e-12)
    return Trace(spec.name, demand * scale, interval_minutes, v)


def make_fleet(days: float = 42.0, interval_minutes: float = 15.0, seed: int = 0,
               n_fabrics: int | None = None):
    """Yield ``(spec, fabric, trace)`` for the whole fleet (or a prefix)."""
    specs = FLEET_SPECS if n_fabrics is None else FLEET_SPECS[:n_fabrics]
    for spec in specs:
        fabric = make_fabric(spec, seed)
        trace = make_trace(spec, fabric, days, interval_minutes, seed)
        yield spec, fabric, trace


# ---- fleet-engine bucketing + padding masks ---------------------------------
# The fleet engine (repro.core.fleet_engine) batches different-sized fabrics
# through one padded solver/kernel shape.  Pods are rounded up to a quantum
# (few buckets, bounded V³ padding waste); a fabric's commodities/edges embed
# into the padded layout via `commodity_slots`, with zeros (dead capacity)
# everywhere else — the solver's per-element valid mask
# (JaxRoutingSolver.valid_for_pods) keeps dead links out of routing.


def pad_pods(n_pods: int, quantum: int = 4) -> int:
    """Round a pod count up to the bucket quantum (e.g. 6, 7, 8 → 8)."""
    if quantum < 1:
        raise ValueError("quantum must be >= 1")
    return max(quantum, -(-n_pods // quantum) * quantum)


def commodity_slots(n_pods: int, n_padded: int) -> np.ndarray:
    """Indices of a ``n_pods``-fabric's commodities (== directed edges) inside
    the ``n_padded``-pod enumeration.  Both enumerations are lexicographic
    over ordered pairs, so the embedding is order-preserving."""
    comm = directed_edge_index(n_padded)
    mask = (comm[:, 0] < n_pods) & (comm[:, 1] < n_pods)
    return np.nonzero(mask)[0]


def scatter_pad(x: np.ndarray, slots: np.ndarray, size: int,
                axis: int = -1) -> np.ndarray:
    """Embed ``x`` into a zero array of length ``size`` along ``axis``, at
    positions ``slots`` (the commodity/edge padding mask's inverse)."""
    x = np.asarray(x)
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis] = size
    out = np.zeros(shape, x.dtype)
    idx = [slice(None)] * x.ndim
    idx[axis] = slots
    out[tuple(idx)] = x
    return out


def fleet_bucket_key(fabric: Fabric, cc, sc, trace: Trace,
                     quantum: int = 4) -> tuple:
    """Bucket key for one controller sweep: everything that must agree for
    its routing solves and its fused scoring pass to share one batch —
    padded pod count, critical-TM count, PDHG settings (incl. the solver
    arithmetic precision), scoring backend and threshold, loss config, and
    trace cadence."""
    return (pad_pods(fabric.n_pods, quantum), cc.k_critical,
            cc.pdhg_max_iters, cc.pdhg_tol, sc.skip_stage3,
            cc.solver_precision, cc.backend, cc.overload_threshold, cc.loss,
            float(trace.interval_minutes))
