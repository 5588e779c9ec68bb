"""Wrapper for the fused link-load metrics kernel (``csrc/linkload.cu``).

The counterpart of ``repro/kernels/linkload/ops.py``'s
:func:`link_metrics_batched`: live-link masking, capacity normalization and
the conversion of the kernel's raw accumulators (sums/counts) into the
simulator's MLU / ALU / OLR / total-load metrics.  ``backend`` is ``"torch"``
(the CUDA kernel on a CUDA device, its plain version on the CPU) or
``"numpy"`` (the float64 oracle).

:func:`linkload_batched` is the tensor-level wrapper: a CUDA tensor launches
the kernel (and adds one to :data:`launches`), a CPU tensor runs the plain
version in :mod:`.ref`.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels._checks import placement
from repro_torch.kernels.linkload.ref import linkload_metrics_batched_ref

__all__ = ["launches", "linkload_batched", "link_metrics_batched"]

launches = 0  # kernel launches so far; set to 0 before a run to count its own


def _entry():
    lib = _build.library("linkload")
    fn = lib.linkload_batched
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.linkload_max_commodities.restype = ctypes.c_int
    return lib, fn


def linkload_batched(demand: torch.Tensor, w: torch.Tensor,
                     inv_cap: torch.Tensor, threshold: float):
    """Per-row (mlu, alu_sum, olr_count, load_sum), each (B, T) float32.

    demand (B, T, C), w (B, C, E), inv_cap (B, E) (0 = dead link): contiguous
    float32, all on the CPU (plain version) or all on one CUDA device (the
    kernel).
    """
    dev = placement("linkload_batched", demand=demand, w=w, inv_cap=inv_cap)
    b, t, c = demand.shape
    if w.shape[:2] != (b, c) or inv_cap.shape != (b, w.shape[2]):
        raise ValueError(f"linkload_batched: shapes {tuple(demand.shape)}, "
                         f"{tuple(w.shape)}, {tuple(inv_cap.shape)} disagree")
    if dev.type == "cpu":
        return linkload_metrics_batched_ref(demand, w, inv_cap, threshold)
    e = w.shape[2]
    lib, fn = _entry()
    if c > lib.linkload_max_commodities():
        raise ValueError(f"linkload_batched: C={c} exceeds the kernel's "
                         f"shared-memory tile ({lib.linkload_max_commodities()})")
    out = torch.empty((4, b, t), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(demand.data_ptr(), w.data_ptr(), inv_cap.data_ptr(),
                float(threshold), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), out[3].data_ptr(), b, t, c, e,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "linkload", "linkload_batched", rc)
    global launches
    launches += 1
    return out[0], out[1], out[2], out[3]


def link_metrics_batched(demand, weights, capacities, threshold: float = 0.8,
                         backend: str = "torch", device=None):
    """Epoch-batched link metrics: one call scores every routing epoch.

    Args:
      demand: (B, T, C) per-epoch demand blocks (zero-padded rows are scored
        and trimmed by the caller).
      weights: (B, C, E) per-epoch routing-weight matrices.
      capacities: (B, E) per-epoch directed capacities.
      threshold: overload threshold of the OLR count.
      backend: ``"torch"`` or ``"numpy"``.
      device: the torch backend's device (``None`` = CUDA).

    Returns (mlu, alu, olr, total_load), each (B, T); ALU/OLR are averaged
    over each epoch's own live links.
    """
    demand = np.asarray(demand)
    weights = np.asarray(weights)
    cap = np.asarray(capacities, np.float64)
    live = cap > 1e-9  # (B, E)
    n_live = np.maximum(live.sum(axis=1), 1)[:, None]  # (B, 1)
    inv_cap = np.where(live, 1.0 / np.maximum(cap, 1e-9), 0.0)
    if backend == "torch":
        dev = resolve_device(device)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

        mlu, alu_sum, olr_cnt, tot = (
            x.cpu().numpy() for x in linkload_batched(
                put(demand), put(weights), put(inv_cap), threshold))
    elif backend == "numpy":
        load = demand.astype(np.float64) @ weights.astype(np.float64)  # (B,T,E)
        util = load * inv_cap[:, None, :]
        mlu = util.max(axis=2)
        alu_sum = util.sum(axis=2)
        olr_cnt = (util > threshold).sum(axis=2)
        tot = load.sum(axis=2)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return mlu, alu_sum / n_live, olr_cnt / n_live, tot
