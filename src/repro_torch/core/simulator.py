"""Trace-driven link-utilization scoring (paper §5.2 methodology, §3 metrics)
— the counterpart of ``repro/core/simulator.py``.

Given a routing-weight matrix ``W (C, E_d)`` and directed capacities
``cap (E_d,)`` — or one of each per routing epoch, ``(B, C, E_d)`` and
``(B, E_d)`` — per-interval loads are one matmul per block:

    load[t, e] = Σ_c demand[t, c] · W[c, e]

Metrics per interval: MLU (max load/C over live links), ALU (mean load/C),
OLR (fraction of links above the overload threshold) and stretch (total load
over total demand).  Summaries report the p99.9 over intervals.  With a
:class:`repro_torch.burst.LossConfig`, each interval also gets the burst-level
loss fraction.  ``backend="torch"`` runs the linkload and queueloss CUDA
kernels — one launch each per block (:func:`route_metrics`), per sweep
(:func:`route_metrics_batched`) or per fleet bucket
(:func:`route_metrics_fleet`); ``"numpy"`` is the float64 oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["IntervalMetrics", "route_metrics", "route_metrics_batched",
           "route_metrics_fleet", "p999", "summarize"]


def _concat_loss(a, a_size: int, b, b_size: int):
    """Concatenate optional loss arrays; an empty side adopts the other's
    tracking state, and mixing tracked with untracked drops loss entirely."""
    if a is None and b is None:
        return None
    if a is None:
        return b if a_size == 0 else None
    if b is None:
        return a if b_size == 0 else None
    return np.concatenate([a, b])


@dataclasses.dataclass
class IntervalMetrics:
    mlu: np.ndarray  # (T,)
    alu: np.ndarray  # (T,)
    olr: np.ndarray  # (T,)
    stretch: np.ndarray  # (T,)
    loss: np.ndarray | None = None  # (T,) burst-level loss fraction, if tracked

    def concat(self, other: "IntervalMetrics") -> "IntervalMetrics":
        return IntervalMetrics(
            mlu=np.concatenate([self.mlu, other.mlu]),
            alu=np.concatenate([self.alu, other.alu]),
            olr=np.concatenate([self.olr, other.olr]),
            stretch=np.concatenate([self.stretch, other.stretch]),
            loss=_concat_loss(self.loss, self.mlu.size, other.loss, other.mlu.size),
        )

    @staticmethod
    def empty() -> "IntervalMetrics":
        z = np.zeros((0,))
        return IntervalMetrics(z, z, z, z)


def p999(x: np.ndarray) -> float:
    return float(np.percentile(x, 99.9)) if x.size else float("nan")


def summarize(m: IntervalMetrics) -> dict:
    out = {
        "p999_mlu": p999(m.mlu),
        "p999_alu": p999(m.alu),
        "p999_olr": p999(m.olr),
        "p999_stretch": p999(m.stretch),
        "mean_mlu": float(m.mlu.mean()) if m.mlu.size else float("nan"),
        "mean_alu": float(m.alu.mean()) if m.alu.size else float("nan"),
        "mean_stretch": float(m.stretch.mean()) if m.stretch.size else float("nan"),
    }
    if m.loss is not None:
        out["p999_loss"] = p999(m.loss)
        out["mean_loss"] = float(m.loss.mean()) if m.loss.size else float("nan")
    return out


def route_metrics(
    demand: np.ndarray,
    weights: np.ndarray,
    capacities: np.ndarray,
    overload_threshold: float = 0.8,
    backend: str = "torch",
    loss_cfg=None,
    interval_seconds: float | None = None,
    device=None,
) -> IntervalMetrics:
    """Per-interval MLU/ALU/OLR/stretch for a (T, C) demand block.

    ``backend="torch"`` scores through :func:`link_metrics` (one launch of
    the linkload kernel on a CUDA device); ``"numpy"`` is the reference's
    float64 path.  With ``loss_cfg`` (a :class:`repro_torch.burst.LossConfig`)
    and ``interval_seconds``, also attaches the per-interval burst-level loss
    fraction from :func:`repro_torch.burst.interval_loss` on ``backend``.
    ``device`` is the torch backend's device (``None`` = CUDA).

    Dead links (capacity ≤ 1e-9) carry no utilization: they are excluded from
    MLU and from the ALU/OLR live-link averages on both backends, and an
    all-dead capacity vector scores MLU/ALU/OLR = 0.
    """
    demand = np.asarray(demand, dtype=np.float64)
    cap = np.asarray(capacities, dtype=np.float64)
    live = cap > 1e-9
    if backend == "torch":
        from repro_torch.kernels.linkload import ops as llops

        mlu, alu, olr, load_tot = (np.asarray(x) for x in llops.link_metrics(
            demand, weights, cap, overload_threshold, device=device))
    elif backend == "numpy":
        load = demand @ weights  # (T, E_d)
        if live.any():
            util = load[:, live] / cap[None, live]
            mlu = util.max(axis=1)
            alu = util.mean(axis=1)
            olr = (util > overload_threshold).mean(axis=1)
        else:
            mlu = alu = olr = np.zeros(demand.shape[0])
        load_tot = load.sum(axis=1)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    tot_dem = demand.sum(axis=1)
    stretch = np.where(tot_dem > 1e-12, load_tot / np.maximum(tot_dem, 1e-12), 1.0)
    loss = None
    if loss_cfg is not None:
        if interval_seconds is None:
            raise ValueError("loss tracking requires interval_seconds")
        from repro_torch.burst import interval_loss

        loss = interval_loss(demand, weights, cap, interval_seconds, loss_cfg,
                             backend=backend, device=device)
    return IntervalMetrics(mlu=mlu, alu=alu, olr=olr, stretch=stretch, loss=loss)


def route_metrics_batched(
    blocks: list,
    weights: np.ndarray,
    capacities: np.ndarray,
    overload_threshold: float = 0.8,
    backend: str = "torch",
    loss_cfg=None,
    loss_seeds: list | None = None,
    interval_seconds: float | None = None,
    device=None,
) -> IntervalMetrics:
    """Single-pass scoring of an entire controller sweep.

    Args:
      blocks: list of per-epoch ``(T_b, C)`` demand blocks, in trace order
        (lengths may differ; short epochs are zero-padded internally).
      weights: ``(B, C, E_d)`` per-epoch routing-weight matrices.
      capacities: ``(B, E_d)`` per-epoch directed capacities.
      backend: ``"torch"`` or ``"numpy"``.
      loss_cfg / loss_seeds / interval_seconds: with a
        :class:`repro_torch.burst.LossConfig` and per-epoch seeds, also
        computes the burst-level loss fraction (seeds must match the
        reference controller's ``cfg.seed + start`` so comparisons stay
        paired).
      device: the torch backend's device (``None`` = CUDA).

    Returns the concatenated :class:`IntervalMetrics` over all epochs, in
    epoch order.
    """
    from repro_torch.kernels.linkload import ops as llops

    b = len(blocks)
    if b == 0:
        return IntervalMetrics.empty()
    lens = [np.asarray(bl).shape[0] for bl in blocks]
    t_pad = max(lens)
    c = np.asarray(blocks[0]).shape[1]
    demand_b = np.zeros((b, t_pad, c), np.float64)
    for i, bl in enumerate(blocks):
        demand_b[i, : lens[i]] = np.asarray(bl, np.float64)
    mlu_b, alu_b, olr_b, tot_b = llops.link_metrics_batched(
        demand_b, weights, capacities, overload_threshold,
        backend=backend, device=device)
    dem_tot = demand_b.sum(axis=2)  # (B, T_pad)
    stretch_b = np.where(dem_tot > 1e-12,
                         tot_b / np.maximum(dem_tot, 1e-12), 1.0)
    loss_list = None
    if loss_cfg is not None:
        if interval_seconds is None or loss_seeds is None:
            raise ValueError("loss tracking requires interval_seconds and seeds")
        from repro_torch.burst import interval_loss_batched

        loss_list = interval_loss_batched(
            blocks, weights, capacities, interval_seconds, loss_cfg,
            loss_seeds, backend=backend, device=device)

    def trim(arr):
        return np.concatenate(
            [np.asarray(arr[i][: lens[i]], np.float64) for i in range(b)])

    return IntervalMetrics(
        mlu=trim(mlu_b), alu=trim(alu_b), olr=trim(olr_b), stretch=trim(stretch_b),
        loss=np.concatenate(loss_list) if loss_list is not None else None)


def route_metrics_fleet(
    blocks_fleet: list,
    weights_fleet: list,
    caps_fleet: list,
    overload_threshold: float = 0.8,
    backend: str = "torch",
    loss_cfg=None,
    loss_seeds_fleet: list | None = None,
    interval_seconds: float | None = None,
    loss_blocks_fleet: list | None = None,
    loss_slots_fleet: list | None = None,
    device=None,
    rows: np.ndarray | None = None,
) -> list:
    """Single fused scoring pass over an entire fleet bucket.

    Every fabric's scoring blocks are stacked onto a leading *fabric* axis:
    on ``backend="torch"`` one launch of the fleet linkload kernel (and one of
    the fleet queueloss kernel with ``loss_cfg``) scores the whole bucket.
    The fleet engine pads all fabrics to one commodity/edge layout; the
    block-count and interval-count padding happens here (padded blocks carry
    zero demand against zero capacity and are trimmed before returning).

    Args:
      blocks_fleet: per-fabric lists of ``(T_b, C)`` demand blocks, in trace
        order (lengths may differ within and across fabrics).
      weights_fleet: per-fabric ``(B_f, C, E_d)`` routing-weight stacks.
      caps_fleet: per-fabric ``(B_f, E_d)`` directed capacities.
      backend: ``"torch"`` or ``"numpy"``.
      loss_cfg / loss_seeds_fleet / interval_seconds: with a
        :class:`repro_torch.burst.LossConfig` and per-fabric seed lists, also
        computes burst-level loss fractions (paired seeds as in
        :func:`route_metrics_batched`).
      loss_blocks_fleet / loss_slots_fleet: when ``blocks_fleet`` lives in a
        padded commodity layout, the same blocks in each fabric's native
        layout and their commodity-slot embeddings
        (:func:`repro_torch.core.fleet.commodity_slots`), so the burst
        expansion draws what the per-fabric controller draws.
      device: the torch backend's device (``None`` = CUDA).
      rows: ``(F,)`` entries of the lists above, one per scored row: row
        ``r`` scores entry ``rows[r]``'s blocks, weights, seeds and loss
        layout under ``caps_fleet[r]`` (the contingency evaluator's
        scenarios of one plan share its routing).  Each entry goes to the
        device once, its rows are gathered there, and both kernels read the
        one gathered weights operand.  ``None`` (default): one row per
        entry, ``caps_fleet`` aligned with ``blocks_fleet``.

    Returns a list of per-row :class:`IntervalMetrics`, each in the layout
    of the per-fabric controller's concatenated metrics.
    """
    from repro_torch.device import fleet_rows
    from repro_torch.kernels.linkload import ops as llops

    f = len(caps_fleet)
    if f == 0:
        return []
    src = np.arange(f) if rows is None else np.asarray(rows, np.int64)
    lens = [[np.asarray(b).shape[0] for b in blocks] for blocks in blocks_fleet]
    b_max = max(len(blocks) for blocks in blocks_fleet)
    t_pad = max((n for row in lens for n in row), default=1)
    c = np.asarray(weights_fleet[0]).shape[1]
    e = np.asarray(weights_fleet[0]).shape[2]
    j = len(blocks_fleet)
    demand_b = np.zeros((j, b_max, max(t_pad, 1), c), np.float64)
    weights_b = np.zeros((j, b_max, c, e), np.float64)
    caps_b = np.zeros((f, b_max, e), np.float64)
    for fi, blocks in enumerate(blocks_fleet):
        for bi, bl in enumerate(blocks):
            demand_b[fi, bi, : lens[fi][bi]] = np.asarray(bl, np.float64)
        weights_b[fi, :len(blocks)] = np.asarray(weights_fleet[fi], np.float64)
    for r in range(f):
        caps_b[r, :len(blocks_fleet[src[r]])] = np.asarray(caps_fleet[r],
                                                           np.float64)
    weights_op = fleet_rows(weights_b, rows, backend, device)
    mlu_b, alu_b, olr_b, tot_b = llops.link_metrics_fleet(
        fleet_rows(demand_b, rows, backend, device), weights_op, caps_b,
        overload_threshold, backend=backend, device=device)
    dem_tot = demand_b.sum(axis=3)  # (J, B, T_pad)
    if rows is not None:
        dem_tot = dem_tot[src]
    stretch_b = np.where(dem_tot > 1e-12,
                         tot_b / np.maximum(dem_tot, 1e-12), 1.0)
    loss_fleet = None
    if loss_cfg is not None:
        if interval_seconds is None or loss_seeds_fleet is None:
            raise ValueError("loss tracking requires interval_seconds and seeds")
        from repro_torch.burst import interval_loss_fleet

        loss_fleet = interval_loss_fleet(
            loss_blocks_fleet if loss_blocks_fleet is not None else blocks_fleet,
            weights_fleet, caps_fleet, interval_seconds, loss_cfg,
            loss_seeds_fleet, backend=backend, slots_fleet=loss_slots_fleet,
            device=device, rows=rows, weights_op=weights_op)
    out = []
    for r in range(f):
        blocks, n_b = blocks_fleet[src[r]], lens[src[r]]

        def trim(arr):
            if not blocks:
                return np.zeros((0,))
            return np.concatenate(
                [np.asarray(arr[r][bi][: n_b[bi]], np.float64)
                 for bi in range(len(blocks))])

        out.append(IntervalMetrics(
            mlu=trim(mlu_b), alu=trim(alu_b), olr=trim(olr_b),
            stretch=trim(stretch_b),
            loss=(np.concatenate(loss_fleet[r])
                  if loss_fleet is not None else None)))
    return out
