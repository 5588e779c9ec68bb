"""Plain-PyTorch version of the fused link-load metrics kernel.

The counterpart of ``repro/kernels/linkload/ref.py``.  The functions
materialize the load tensor ((T, E), (B, T, E) batched, or (F, B, T, E) for a
fleet bucket) that the CUDA kernel (``csrc/linkload.cu``) keeps out of device memory; the wrappers in
:mod:`.ops` run them for CPU tensors, and ``chip_smoke.py`` holds the kernel
against them on the card.
"""

from __future__ import annotations

import torch

__all__ = ["linkload_metrics_ref", "linkload_metrics_batched_ref",
           "linkload_metrics_fleet_ref"]


def linkload_metrics_ref(demand: torch.Tensor, w: torch.Tensor,
                         inv_cap: torch.Tensor, threshold: float):
    """demand (T, C), w (C, E), inv_cap (E,) (0 = dead link).

    Returns (mlu, alu_sum, olr_count, load_sum), each (T,).
    """
    load = demand @ w  # (T, E)
    util = load * inv_cap[None, :]  # dead/padded links contribute 0
    return (util.amax(dim=1), util.sum(dim=1),
            (util > threshold).to(util.dtype).sum(dim=1), load.sum(dim=1))


def linkload_metrics_batched_ref(demand: torch.Tensor, w: torch.Tensor,
                                 inv_cap: torch.Tensor, threshold: float):
    """demand (B, T, C), w (B, C, E), inv_cap (B, E) (0 = dead link).

    Returns (mlu, alu_sum, olr_count, load_sum), each (B, T).
    """
    load = demand @ w  # (B, T, E)
    util = load * inv_cap[:, None, :]  # dead/padded links contribute 0
    return (util.amax(dim=2), util.sum(dim=2),
            (util > threshold).to(util.dtype).sum(dim=2), load.sum(dim=2))


def linkload_metrics_fleet_ref(demand: torch.Tensor, w: torch.Tensor,
                               inv_cap: torch.Tensor, threshold: float):
    """demand (F, B, T, C), w (F, B, C, E), inv_cap (F, B, E) (0 = dead link);
    every (fabric, block) pair is scored on its own.

    Returns (mlu, alu_sum, olr_count, load_sum), each (F, B, T).
    """
    f, b, t = demand.shape[:3]
    out = linkload_metrics_batched_ref(demand.reshape((f * b,) + demand.shape[2:]),
                                       w.reshape((f * b,) + w.shape[2:]),
                                       inv_cap.reshape(f * b, w.shape[3]), threshold)
    return tuple(x.reshape(f, b, t) for x in out)
