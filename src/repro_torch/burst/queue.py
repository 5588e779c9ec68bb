"""Finite-buffer fluid-queue loss model over sub-interval link loads — the
counterpart of ``repro/burst/queue.py``.

Each directed link ``e`` is a fluid queue drained at capacity ``cap[e]``
(Gb/s) with a finite buffer ``buf[e]`` (Gb) sized in time units of the line
rate (``buffer_ms``).  Over sub-steps of duration ``dt`` seconds with offered
load ``load[k, e]``:

    x[k]    = q[k] + (load[k, e] - cap[e]) · dt      # fluid level
    drop[k] = max(0, x[k] - buf[e])                  # overflowed volume (Gb)
    q[k+1]  = clip(x[k], 0, buf[e])

The per-interval **loss fraction** is dropped volume over offered *demand*
volume (the expanded sub-interval demand, bursts included), aggregated over
links and the interval's ``n_sub`` sub-steps and clipped to 1.  Queue state
starts empty at every block (routing epoch) boundary.  See the reference
module for the model's timescale assumptions.

Burst expansion (:func:`repro_torch.burst.expander.expand`) and the loss
fractions stay float64 numpy on the host, as in the reference; the queue scan
runs on the CUDA kernel (``backend="torch"``: one launch per block, one per
sweep batched, or one per fleet bucket) or the float64 numpy oracle
(``backend="numpy"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.burst.expander import BurstParams, expand
from repro_torch.device import fleet_rows

__all__ = ["LossConfig", "link_buffer_gb", "interval_loss",
           "interval_loss_batched", "interval_loss_fleet", "queue_loss_numpy"]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Configuration of the burst-loss pipeline (expander + fluid queue).

    Attributes:
      burst: sub-interval burst model (:class:`BurstParams`).
      n_sub: sub-samples per TM interval (S).
      buffer_ms: per-link buffer depth in milliseconds at line rate.
      seed: burst realization seed (same seed ⇒ same bursts ⇒ paired
        comparisons across strategies).
    """

    burst: BurstParams = BurstParams.zero()
    n_sub: int = 12
    buffer_ms: float = 25.0
    seed: int = 0


def link_buffer_gb(capacities: np.ndarray, buffer_ms: float) -> np.ndarray:
    """Buffer depth per link in Gb: ``cap (Gb/s) × buffer_ms``."""
    return np.asarray(capacities, np.float64) * (buffer_ms * 1e-3)


def queue_loss_numpy(demand: np.ndarray, weights: np.ndarray, cap: np.ndarray,
                     buf: np.ndarray, dt: float):
    """Float64 queue-loss oracle (the precision reference).

    Returns per-sub-step ``(drop, tot)`` — dropped Gb and offered load Gb/s,
    each summed over links, shape ``(TS,)`` float64.
    """
    demand = np.asarray(demand, np.float64)
    load = demand @ np.asarray(weights, np.float64)
    cap = np.asarray(cap, np.float64)
    buf = np.asarray(buf, np.float64)
    ts = demand.shape[0]
    q = np.zeros_like(cap)
    drop = np.empty(ts, np.float64)
    tot = np.empty(ts, np.float64)
    for k in range(ts):
        x = q + (load[k] - cap) * dt
        drop[k] = np.maximum(x - buf, 0.0).sum()
        q = np.clip(x, 0.0, buf)
        tot[k] = load[k].sum()
    return drop, tot


def _loss_fractions(drop: np.ndarray, sub: np.ndarray, t: int, n_sub: int,
                    dt: float) -> np.ndarray:
    """Aggregate per-sub-step drops (Gb) and sub-interval demand into the
    per-interval loss fraction (dropped over offered volume, clipped to 1).
    Shared by the single-block and batched paths so their arithmetic cannot
    drift apart."""
    drop_i = drop.reshape(t, n_sub).sum(axis=1)  # Gb dropped
    offered_i = sub.sum(axis=1).reshape(t, n_sub).sum(axis=1) * dt  # Gb demanded
    return np.where(offered_i > 1e-12,
                    np.minimum(drop_i / np.maximum(offered_i, 1e-12), 1.0), 0.0)


def interval_loss(
    demand: np.ndarray,
    weights: np.ndarray,
    capacities: np.ndarray,
    interval_seconds: float,
    cfg: LossConfig,
    backend: str = "torch",
    device=None,
) -> np.ndarray:
    """Per-interval loss fraction for a ``(T, C)`` demand block.

    Expands the block into sub-interval samples
    (:func:`repro_torch.burst.expander.expand`, seeded by ``cfg.seed``),
    routes them with ``weights (C, E_d)``, runs the fluid queue per link (one
    launch of the queueloss kernel on ``backend="torch"``; the queue starts
    empty at the block) and aggregates dropped over offered *demand* volume
    per original interval.  ``device`` is the torch backend's device
    (``None`` = CUDA).  Returns a ``(T,)`` float64 array in [0, 1].
    """
    demand = np.asarray(demand, dtype=np.float64)
    t = demand.shape[0]
    if t == 0:
        return np.zeros((0,))
    cap = np.asarray(capacities, dtype=np.float64)
    sub = expand(demand, cfg.n_sub, cfg.burst, cfg.seed)
    dt = interval_seconds / cfg.n_sub
    buf = link_buffer_gb(cap, cfg.buffer_ms)
    from repro_torch.kernels.queueloss import ops as qlops

    drop, _ = qlops.queue_loss(sub, weights, cap, buf, dt, backend=backend,
                               device=device)
    return _loss_fractions(drop, sub, t, cfg.n_sub, dt)


def interval_loss_batched(
    blocks: list,
    weights: np.ndarray,
    capacities: np.ndarray,
    interval_seconds: float,
    cfg: LossConfig,
    seeds: list,
    backend: str = "torch",
    device=None,
) -> list:
    """Per-interval loss fractions of a controller sweep's routing epochs.

    Args:
      blocks: list of per-epoch ``(T_b, C)`` demand blocks (lengths may vary).
      weights: ``(B, C, E_d)`` per-epoch routing-weight matrices.
      capacities: ``(B, E_d)`` per-epoch directed capacities.
      seeds: per-epoch burst seeds (the controller uses ``cfg.seed + start``
        so comparisons stay paired across strategies).
      backend: ``"torch"`` (one launch of the epoch-batched queueloss kernel)
        or ``"numpy"``.
      device: the torch backend's device (``None`` = CUDA).

    Burst expansion stays per-epoch (each epoch draws its own realization
    from its seed); short epochs are zero-padded — padded sub-steps only
    drain queues and never drop.  Returns a list of per-epoch ``(T_b,)``
    loss-fraction arrays.
    """
    b = len(blocks)
    if b == 0:
        return []
    cap = np.asarray(capacities, np.float64)
    dt = interval_seconds / cfg.n_sub
    subs, lens = [], []
    for block, seed in zip(blocks, seeds):
        block = np.asarray(block, np.float64)
        lens.append(block.shape[0])
        subs.append(expand(block, cfg.n_sub, cfg.burst, seed))
    ts_max = max(lens) * cfg.n_sub
    sub_b = np.zeros((b, ts_max, subs[0].shape[1]), np.float64)
    for i, s in enumerate(subs):
        sub_b[i, : s.shape[0]] = s
    buf_b = np.stack([link_buffer_gb(c, cfg.buffer_ms) for c in cap])
    from repro_torch.kernels.queueloss import ops as qlops

    drop_b, _ = qlops.queue_loss_batched(sub_b, weights, cap, buf_b, dt,
                                         backend=backend, device=device)
    return [_loss_fractions(drop_b[i, : n * cfg.n_sub], s, n, cfg.n_sub, dt)
            for i, (s, n) in enumerate(zip(subs, lens))]


def interval_loss_fleet(
    blocks_fleet: list,
    weights_fleet: list,
    capacities_fleet: list,
    interval_seconds: float,
    cfg: LossConfig,
    seeds_fleet: list,
    backend: str = "torch",
    slots_fleet: list | None = None,
    device=None,
    rows: np.ndarray | None = None,
    weights_op=None,
) -> list:
    """Per-interval loss fractions of many fabrics' sweeps in one queue scan.

    Args:
      blocks_fleet: per-fabric lists of ``(T_b, C)`` demand blocks in each
        fabric's **native** commodity layout — burst expansion is
        deterministic per (seed, block shape), so expanding a padded block
        would draw other bursts than the per-fabric controller and break the
        paired-seed contract.
      weights_fleet: per-fabric ``(B_f, C_p, E_p)`` routing-weight stacks in
        the (possibly padded) bucket layout.
      capacities_fleet: per-fabric ``(B_f, E_p)`` capacities, same layout.
      seeds_fleet: per-fabric lists of per-block burst seeds (the controller
        uses ``cfg.seed + start``).
      backend: ``"torch"`` (one launch of the fleet queueloss kernel) or
        ``"numpy"``.
      slots_fleet: per-fabric commodity-slot embeddings
        (:func:`repro_torch.core.fleet.commodity_slots`) into the bucket
        layout, whose width comes from ``weights_fleet``; ``None`` when the
        blocks already match the weights.
      device: the torch backend's device (``None`` = CUDA).
      rows: ``(F,)`` entries of the lists above, one per scanned row: row
        ``r`` scans entry ``rows[r]``'s blocks under ``capacities_fleet[r]``
        (each entry is expanded once and goes to the device once).
        ``None``: one row per entry.
      weights_op: the ``(F, B_max, C_p, E_p)`` weights operand of these rows
        as :func:`repro_torch.core.simulator.route_metrics_fleet` built it
        for its linkload launch (on ``"torch"`` a tensor on the device);
        ``None`` builds it from ``weights_fleet``.

    Burst expansion stays per block, per seed and in the native layout; the
    expanded sub-samples are scattered into the bucket layout and zero-padded
    to ``(F, B_max, TS_max, C_p)``.  Padded commodities carry zero demand
    against zero capacity, and padded blocks and sub-steps only drain queues,
    so neither ever drops.  Returns per-fabric lists of ``(T_b,)`` loss
    fractions.
    """
    f = len(capacities_fleet)
    if f == 0:
        return []
    src = np.arange(f) if rows is None else np.asarray(rows, np.int64)
    dt = interval_seconds / cfg.n_sub
    subs, lens = [], []
    for blocks, seeds in zip(blocks_fleet, seeds_fleet):
        row_subs, row_lens = [], []
        for block, seed in zip(blocks, seeds):
            block = np.asarray(block, np.float64)
            row_lens.append(block.shape[0])
            row_subs.append(expand(block, cfg.n_sub, cfg.burst, seed))
        subs.append(row_subs)
        lens.append(row_lens)
    b_max = max(len(row) for row in subs)
    ts_max = max((n for row in lens for n in row), default=1) * cfg.n_sub
    c = np.asarray(weights_fleet[0]).shape[1]
    e = np.asarray(weights_fleet[0]).shape[2]
    j = len(blocks_fleet)
    sub_b = np.zeros((j, b_max, max(ts_max, 1), c), np.float64)
    cap_b = np.zeros((f, b_max, e), np.float64)
    buf_b = np.zeros((f, b_max, e), np.float64)
    for fi in range(j):
        slots = None if slots_fleet is None else slots_fleet[fi]
        for bi, s in enumerate(subs[fi]):
            if slots is None:
                sub_b[fi, bi, : s.shape[0]] = s
            else:  # embed the native-layout expansion into the bucket layout
                sub_b[fi, bi, : s.shape[0], :][:, slots] = s
    if weights_op is None:
        w_b = np.zeros((j, b_max, c, e), np.float64)
        for fi in range(j):
            w_b[fi, :len(subs[fi])] = np.asarray(weights_fleet[fi], np.float64)
        weights_op = fleet_rows(w_b, rows, backend, device)
    for r in range(f):
        nb = len(subs[src[r]])
        cap_b[r, :nb] = np.asarray(capacities_fleet[r], np.float64)
        buf_b[r, :nb] = link_buffer_gb(cap_b[r, :nb], cfg.buffer_ms)
    from repro_torch.kernels.queueloss import ops as qlops

    drop_b, _ = qlops.queue_loss_fleet(
        fleet_rows(sub_b, rows, backend, device), weights_op, cap_b, buf_b,
        dt, backend=backend, device=device)
    return [[_loss_fractions(drop_b[r, bi, : n * cfg.n_sub], s, n, cfg.n_sub,
                             dt)
             for bi, (s, n) in enumerate(zip(subs[src[r]], lens[src[r]]))]
            for r in range(f)]
