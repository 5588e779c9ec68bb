"""Trace-driven link-utilization scoring (paper §5.2 methodology, §3 metrics)
— the counterpart of ``repro/core/simulator.py``'s batched path.

Given per-epoch routing-weight matrices ``W (B, C, E_d)`` and directed
capacities ``cap (B, E_d)``, per-interval loads are one matmul per epoch:

    load[b, t, e] = Σ_c demand[b, t, c] · W[b, c, e]

Metrics per interval: MLU (max load/C over live links), ALU (mean load/C),
OLR (fraction of links above the overload threshold) and stretch (total load
over total demand).  Summaries report the p99.9 over intervals.  With a
:class:`repro_torch.burst.LossConfig`, each interval also gets the burst-level
loss fraction.  ``backend="torch"`` runs one launch each of the epoch-batched
linkload and queueloss CUDA kernels; ``"numpy"`` is the float64 oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["IntervalMetrics", "route_metrics_batched", "p999", "summarize"]


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
