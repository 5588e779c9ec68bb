"""Wrapper for the fused queue-loss kernel (``csrc/queueloss.cu``).

The counterpart of ``repro/kernels/queueloss/ops.py``'s
:func:`queue_loss_batched`.  ``backend`` is ``"torch"`` (the CUDA kernel on a
CUDA device, its plain version on the CPU; float32) or ``"numpy"`` (the
float64 oracle :func:`repro_torch.burst.queue.queue_loss_numpy`).  All
implement the same finite-buffer fluid-queue recurrence; padded links get
``cap = buf = 0`` and carry zero load, so they never drop.

:func:`queueloss_batched` is the tensor-level wrapper: a CUDA tensor launches
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
from repro_torch.kernels.queueloss.ref import queueloss_batched_ref

__all__ = ["launches", "queueloss_batched", "queue_loss_batched"]

launches = 0  # kernel launches so far; set to 0 before a run to count its own


def _entry():
    lib = _build.library("queueloss")
    fn = lib.queueloss_batched
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.queueloss_links_per_block.restype = ctypes.c_int
    lib.queueloss_max_commodities.restype = ctypes.c_int
    return lib, fn


def queueloss_batched(demand: torch.Tensor, w: torch.Tensor, cap: torch.Tensor,
                      buf: torch.Tensor, dt: float):
    """Per-sub-step (drop_sum, load_sum), each (B, TS) float32.

    demand (B, TS, C), w (B, C, E), cap/buf (B, E): contiguous float32, all on
    the CPU (plain version) or all on one CUDA device (the kernel).  The queue
    starts empty in every epoch.
    """
    dev = placement("queueloss_batched", demand=demand, w=w, cap=cap, buf=buf)
    b, ts, c = demand.shape
    e = w.shape[2]
    if w.shape[:2] != (b, c) or cap.shape != (b, e) or buf.shape != (b, e):
        raise ValueError(f"queueloss_batched: shapes {tuple(demand.shape)}, "
                         f"{tuple(w.shape)}, {tuple(cap.shape)}, "
                         f"{tuple(buf.shape)} disagree")
    if dev.type == "cpu":
        return queueloss_batched_ref(demand, w, cap, buf, dt)
    lib, fn = _entry()
    if c > lib.queueloss_max_commodities():
        raise ValueError(f"queueloss_batched: C={c} exceeds the kernel's "
                         f"shared-memory chunk ({lib.queueloss_max_commodities()})")
    per = lib.queueloss_links_per_block()
    n_e = max(1, -(-e // per))
    out = torch.empty((2, b, ts), dtype=torch.float32, device=dev)
    part = torch.empty((2, b, ts, n_e), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(demand.data_ptr(), w.data_ptr(), cap.data_ptr(), buf.data_ptr(),
                float(dt), out[0].data_ptr(), out[1].data_ptr(),
                part[0].data_ptr(), part[1].data_ptr(), b, ts, c, e,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "queueloss", "queueloss_batched", rc)
    global launches
    launches += 1
    return out[0], out[1]


def queue_loss_batched(demand, weights, capacities, buffers, dt: float,
                       backend: str = "torch", device=None):
    """Epoch-batched queue loss: one call scans every routing epoch.

    Args:
      demand: (B, TS, C) sub-interval demand blocks, one epoch per row
        (zero-padded trailing sub-steps only drain queues, never add drops
        for the real prefix — trim the outputs to each epoch's length).
      weights: (B, C, E); capacities/buffers: (B, E); dt: sub-step seconds.
      backend: ``"torch"`` or ``"numpy"``.
      device: the torch backend's device (``None`` = CUDA).

    Queue state starts empty in every epoch (the controller's block-boundary
    reset).  Returns (drop, tot), each (B, TS) float64.
    """
    if backend == "numpy":  # float64 end to end
        from repro_torch.burst.queue import queue_loss_numpy

        out = [queue_loss_numpy(d, w, c, bf, dt)
               for d, w, c, bf in zip(demand, weights, capacities, buffers)]
        return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]))
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    drop, tot = queueloss_batched(put(demand), put(weights), put(capacities),
                                  put(buffers), dt)
    return (drop.cpu().numpy().astype(np.float64),
            tot.cpu().numpy().astype(np.float64))
