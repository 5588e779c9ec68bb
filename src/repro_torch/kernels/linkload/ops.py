"""Wrappers for the fused link-load metrics kernel (``csrc/linkload.cu``).

The counterpart of ``repro/kernels/linkload/ops.py``'s :func:`link_metrics`
(one demand block under one weight matrix), :func:`link_metrics_batched`
(one block per routing epoch) and :func:`link_metrics_fleet` (every block of
every fabric in a fleet bucket): live-link masking, capacity normalization and
the conversion of the kernel's raw accumulators (sums/counts) into the
simulator's MLU / ALU / OLR / total-load metrics.  ``backend`` is ``"torch"``
(the CUDA kernel on a CUDA device, its plain version on the CPU) or
``"numpy"`` (the float64 oracle).

:func:`linkload`, :func:`linkload_batched` and :func:`linkload_fleet` are
the tensor-level wrappers: a CUDA tensor launches the kernel (and adds one to
:data:`single_launches`, :data:`launches` or :data:`fleet_launches`), a CPU
tensor runs the plain version in :mod:`.ref`, and so does a ``meta`` tensor
(shapes alone).
Nothing falls back from one to the other.  On the card each takes the body
(staged or batched) that the autotune table names for its shape bucket
(:func:`repro_torch.kernels.autotune.table.resolve_tiles`; ``body=`` pins
one), by default the one its C entry picks by its own cut; the tuner records
a body only if its outputs are bit-identical to the default's.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels._checks import PLAIN_DEVICES, placement
from repro_torch.kernels.autotune import table as _table
from repro_torch.kernels.linkload.ref import (linkload_metrics_batched_ref,
                                              linkload_metrics_fleet_ref,
                                              linkload_metrics_ref)

__all__ = ["launches", "single_launches", "fleet_launches", "linkload",
           "linkload_batched", "linkload_fleet", "link_metrics",
           "link_metrics_batched", "link_metrics_fleet"]

# kernel launches so far; set to 0 before a run to count its own
launches = 0  # linkload_batched
single_launches = 0  # linkload (one block)
fleet_launches = 0  # linkload_fleet


# the C entries and the number of int dimensions each takes after the
# pointers and the threshold: (T, C, E), (B, T, C, E), (F, B, T, C, E)
_ENTRIES = {"linkload_single": 3, "linkload_batched": 4, "linkload_fleet": 5,
            "linkload_tiles": 4}
_LIB = None  # (library, max commodities), set on first use
# the autotune family of each counted entry
_FAMILY = {"linkload_single": "linkload", "linkload_batched": "linkload_batched",
           "linkload_fleet": "linkload_fleet"}


def _library():
    """The linkload library with every entry's ``argtypes`` and ``restype``
    set, and its commodity limit read, once per process."""
    global _LIB
    if _LIB is None:
        lib = _build.library("linkload")
        for name, n_dims in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
                           + [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_dims
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.linkload_max_commodities.restype = ctypes.c_int
        lib.linkload_single_fits.argtypes = [ctypes.c_int] * 3
        lib.linkload_single_fits.restype = ctypes.c_int
        lib.linkload_single_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.linkload_single_smem_bytes.restype = ctypes.c_longlong
        lib.linkload_staged_threads.argtypes = [ctypes.c_int] * 2
        lib.linkload_staged_threads.restype = ctypes.c_int
        _LIB = (lib, lib.linkload_max_commodities())
    return _LIB


@functools.lru_cache(maxsize=None)
def _single_fits(t: int, c: int, e: int) -> bool:
    """Whether (T, C) blocks under (C, E) weights take the staged body (one
    CTA a block, in every entry) or the batched body."""
    return bool(_library()[0].linkload_single_fits(t, c, e))


def _launch(name: str, dev, demand, w, inv_cap, threshold, out, dims,
            body: str | None = None):
    """Launch the C entry ``name`` over ``dims`` = (*lead, T, C, E), or the
    batched body over its pairs (``linkload_tiles``, the same contiguous
    layout) where ``body`` (``None``: the autotune table's) says "batched";
    "auto" and "staged" keep the entry's own cut."""
    lib, c_max = _library()
    c = dims[-2]
    if c > c_max:
        raise ValueError(f"{name}: C={c} exceeds the kernel's shared-memory "
                         f"tile ({c_max})")
    if name in _FAMILY:
        if body is None:
            body = _table.body_for(_FAMILY[name], *dims[-3:], dev)
        if body == "batched":
            name, dims = "linkload_tiles", (math.prod(dims[:-3]), *dims[-3:])
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(
            demand.data_ptr(), w.data_ptr(), inv_cap.data_ptr(),
            float(threshold), *(o.data_ptr() for o in out), *dims,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "linkload", name, rc)


def linkload(demand: torch.Tensor, w: torch.Tensor, inv_cap: torch.Tensor,
             threshold: float, *, body: str | None = None):
    """Per-row (mlu, alu_sum, olr_count, load_sum), each (T,) float32.

    demand (T, C), w (C, E), inv_cap (E,) (0 = dead link): contiguous
    float32, all on the CPU (plain version) or all on one CUDA device (the
    kernel).
    """
    dev = placement("linkload", demand=demand, w=w, inv_cap=inv_cap)
    t, c = demand.shape
    if w.dim() != 2 or w.shape[0] != c or inv_cap.shape != (w.shape[1],):
        raise ValueError(f"linkload: shapes {tuple(demand.shape)}, "
                         f"{tuple(w.shape)}, {tuple(inv_cap.shape)} disagree")
    if dev.type in PLAIN_DEVICES:
        return linkload_metrics_ref(demand, w, inv_cap, threshold)
    out = torch.empty((4, t), dtype=torch.float32, device=dev)
    _launch("linkload_single", dev, demand, w, inv_cap, threshold, out,
            (t, c, w.shape[1]), body)
    global single_launches
    single_launches += 1
    return out[0], out[1], out[2], out[3]


def linkload_batched(demand: torch.Tensor, w: torch.Tensor,
                     inv_cap: torch.Tensor, threshold: float, *,
                     body: str | None = None):
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
    if dev.type in PLAIN_DEVICES:
        return linkload_metrics_batched_ref(demand, w, inv_cap, threshold)
    out = torch.empty((4, b, t), dtype=torch.float32, device=dev)
    _launch("linkload_batched", dev, demand, w, inv_cap, threshold, out,
            (b, t, c, w.shape[2]), body)
    global launches
    launches += 1
    return out[0], out[1], out[2], out[3]


def _linkload_tiles(demand, w, inv_cap, threshold: float):
    """The batched body over B epochs on the card, whatever the shape (what
    :func:`linkload_batched` launched before it took the staged body): for
    comparisons in ``chip_smoke.py`` and the card tests; no launch is
    counted."""
    dev = placement("linkload_tiles", demand=demand, w=w, inv_cap=inv_cap)
    b, t, c = demand.shape
    out = torch.empty((4, b, t), dtype=torch.float32, device=dev)
    _launch("linkload_tiles", dev, demand, w, inv_cap, threshold, out,
            (b, t, c, w.shape[2]))
    return out[0], out[1], out[2], out[3]


def linkload_fleet(demand: torch.Tensor, w: torch.Tensor,
                   inv_cap: torch.Tensor, threshold: float, *,
                   body: str | None = None):
    """Per-row (mlu, alu_sum, olr_count, load_sum), each (F, B, T) float32.

    demand (F, B, T, C), w (F, B, C, E), inv_cap (F, B, E) (0 = dead link;
    all-zero padded blocks score zeros): contiguous float32, all on the CPU
    (plain version) or all on one CUDA device (the kernel).
    """
    dev = placement("linkload_fleet", demand=demand, w=w, inv_cap=inv_cap)
    if demand.dim() != 4 or w.dim() != 4:
        raise ValueError(f"linkload_fleet: demand and w must be 4-d, got "
                         f"{tuple(demand.shape)}, {tuple(w.shape)}")
    f, b, t, c = demand.shape
    if w.shape[:3] != (f, b, c) or inv_cap.shape != (f, b, w.shape[3]):
        raise ValueError(f"linkload_fleet: shapes {tuple(demand.shape)}, "
                         f"{tuple(w.shape)}, {tuple(inv_cap.shape)} disagree")
    if dev.type in PLAIN_DEVICES:
        return linkload_metrics_fleet_ref(demand, w, inv_cap, threshold)
    out = torch.empty((4, f, b, t), dtype=torch.float32, device=dev)
    _launch("linkload_fleet", dev, demand, w, inv_cap, threshold, out,
            (f, b, t, c, w.shape[3]), body)
    global fleet_launches
    fleet_launches += 1
    return out[0], out[1], out[2], out[3]


def _live_inv_cap(capacities):
    """Live-link mask's count (≥ 1, over the last axis) and the inverse
    capacities with dead links (capacity ≤ 1e-9) at 0, float64."""
    cap = np.asarray(capacities, np.float64)
    live = cap > 1e-9
    n_live = np.maximum(live.sum(axis=-1), 1)
    return n_live, np.where(live, 1.0 / np.maximum(cap, 1e-9), 0.0)


def _put(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # an operand already on the device
        return x.to(dev, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


def link_metrics(demand, weights, capacities, threshold: float = 0.8,
                 backend: str = "torch", device=None):
    """Per-interval (mlu, alu, olr, total_load) for a (T, C) demand block.

    Args:
      demand: (T, C) demand; weights: (C, E) routing weights; capacities:
        (E,) directed capacities (≤ 1e-9 = dead link).
      threshold: overload threshold of the OLR count.
      backend: ``"torch"`` (float32, one launch of the kernel on a CUDA
        device) or ``"numpy"`` (float64).
      device: the torch backend's device (``None`` = CUDA).

    ALU and OLR are averaged over *live* links only; dead links have
    inv_cap = 0, so they never contribute.
    """
    n_live, inv_cap = _live_inv_cap(capacities)
    if backend == "torch":
        dev = resolve_device(device)
        mlu, alu_sum, olr_cnt, tot = (
            x.cpu().numpy() for x in linkload(
                _put(demand, dev), _put(weights, dev), _put(inv_cap, dev),
                threshold))
    elif backend == "numpy":
        load = (np.asarray(demand, np.float32).astype(np.float64)
                @ np.asarray(weights, np.float32).astype(np.float64))
        util = load * inv_cap.astype(np.float32)[None, :]
        mlu = util.max(axis=1)
        alu_sum = util.sum(axis=1)
        olr_cnt = (util > threshold).sum(axis=1)
        tot = load.sum(axis=1)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return mlu, alu_sum / n_live, olr_cnt / n_live, tot


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
    n_live, inv_cap = _live_inv_cap(capacities)
    n_live = n_live[:, None]  # (B, 1)
    if backend == "torch":
        dev = resolve_device(device)
        mlu, alu_sum, olr_cnt, tot = (
            x.cpu().numpy() for x in linkload_batched(
                _put(demand, dev), _put(weights, dev), _put(inv_cap, dev),
                threshold))
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


def link_metrics_fleet(demand, weights, capacities, threshold: float = 0.8,
                       backend: str = "torch", device=None):
    """Fabric-batched link metrics: one call scores every scoring block of
    every fabric in a fleet bucket.

    Args:
      demand: (F, B, T, C) per-(fabric, block) demand (zero rows and all-zero
        padded blocks are scored and trimmed by the caller).
      weights: (F, B, C, E) per-(fabric, block) routing-weight matrices.
        On ``"torch"`` either may already be a tensor on the device.
      capacities: (F, B, E) per-(fabric, block) directed capacities (zero on
        padded links and padded blocks).
      threshold: overload threshold of the OLR count.
      backend: ``"torch"`` (one launch of the fleet kernel on a CUDA device)
        or ``"numpy"``.
      device: the torch backend's device (``None`` = CUDA).

    Returns (mlu, alu, olr, total_load), each (F, B, T); ALU/OLR are averaged
    over each (fabric, block)'s own live links.
    """
    n_live, inv_cap = _live_inv_cap(capacities)
    n_live = n_live[..., None]  # (F, B, 1)
    if backend == "torch":
        dev = resolve_device(device)
        mlu, alu_sum, olr_cnt, tot = (
            x.cpu().numpy() for x in linkload_fleet(
                _put(demand, dev), _put(weights, dev), _put(inv_cap, dev),
                threshold))
    elif backend == "numpy":
        load = (np.asarray(demand, np.float64)
                @ np.asarray(weights, np.float64))  # (F, B, T, E)
        util = load * inv_cap[:, :, None, :]
        mlu = util.max(axis=3)
        alu_sum = util.sum(axis=3)
        olr_cnt = (util > threshold).sum(axis=3)
        tot = load.sum(axis=3)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return mlu, alu_sum / n_live, olr_cnt / n_live, tot
