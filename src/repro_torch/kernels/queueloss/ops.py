"""Wrappers for the fused queue-loss kernel (``csrc/queueloss.cu``).

The counterpart of ``repro/kernels/queueloss/ops.py``'s :func:`queue_loss`
(one sub-step block, one queue carried across it), :func:`queue_loss_batched`
(one block per routing epoch) and :func:`queue_loss_fleet` (every block of
every fabric in a fleet bucket).  ``backend`` is
``"torch"`` (the CUDA kernel on a CUDA device, its plain version on the CPU;
float32) or ``"numpy"`` (the float64 oracle
:func:`repro_torch.burst.queue.queue_loss_numpy`).  All implement the same
finite-buffer fluid-queue recurrence; padded links get ``cap = buf = 0`` and
carry zero load, so they never drop.

:func:`queueloss`, :func:`queueloss_batched` and :func:`queueloss_fleet`
are the tensor-level wrappers: a CUDA tensor launches the kernel (and adds one
to :data:`single_launches`, :data:`launches` or :data:`fleet_launches`), a
CPU tensor runs the plain version in :mod:`.ref`, and so does a ``meta``
tensor (shapes alone).  Nothing falls back from one to the other.
On the card each takes the body (the single block's 8-CTA cluster, the fleet
body or the E-tiled body) that the autotune table names for its shape bucket
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
from repro_torch.kernels.queueloss.ref import (queueloss_batched_ref,
                                               queueloss_fleet_ref,
                                               queueloss_ref)

__all__ = ["launches", "single_launches", "fleet_launches", "queueloss",
           "queueloss_batched", "queueloss_fleet", "queue_loss",
           "queue_loss_batched", "queue_loss_fleet"]

# kernel launches so far; set to 0 before a run to count its own
launches = 0  # queueloss_batched
single_launches = 0  # queueloss (one block)
fleet_launches = 0  # queueloss_fleet


# the C entries and the number of int dimensions each takes after the
# pointers and dt: (TS, C, E), (B, TS, C, E), (F, B, TS, C, E)
_ENTRIES = {"queueloss_single": 3, "queueloss_batched": 4, "queueloss_fleet": 5,
            "queueloss_tiles": 4}
_LIB = None  # (library, max commodities, links per block), set on first use
# the autotune family of each counted entry
_FAMILY = {"queueloss_single": "queueloss", "queueloss_batched": "queueloss_batched",
           "queueloss_fleet": "queueloss_fleet"}


def _library():
    """The queue-loss library with every entry's ``argtypes`` and
    ``restype`` set, and its two limits read, once per process."""
    global _LIB
    if _LIB is None:
        lib = _build.library("queueloss")
        for name, n_dims in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float]
                           + [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_dims
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        for name in ("queueloss_max_commodities", "queueloss_links_per_block",
                     "queueloss_single_fits", "queueloss_fleet_fits"):
            getattr(lib, name).restype = ctypes.c_int
        for name in ("queueloss_single_fits", "queueloss_fleet_fits",
                     "queueloss_fleet_smem_bytes"):
            getattr(lib, name).argtypes = [ctypes.c_int] * 3
        lib.queueloss_fleet_smem_bytes.restype = ctypes.c_longlong
        lib.queueloss_noop.argtypes = [ctypes.c_void_p]
        lib.queueloss_noop.restype = ctypes.c_int
        _LIB = (lib, lib.queueloss_max_commodities(),
                lib.queueloss_links_per_block())
    return _LIB


@functools.lru_cache(maxsize=None)
def _single_fits(ts: int, c: int, e: int) -> bool:
    """Whether a (TS, C) block under a (C, E) W takes the single-block body
    (one launch, no partials) or the batched body over one pair."""
    return bool(_library()[0].queueloss_single_fits(ts, c, e))


@functools.lru_cache(maxsize=None)
def _fleet_fits(ts: int, c: int, e: int) -> bool:
    """Whether (TS, C) blocks under (C, E) weights take the fleet body (one
    CTA per pair or epoch, one launch, no partials) or the E-tiled body and
    its partials pass; the batched and fleet entries share it."""
    return bool(_library()[0].queueloss_fleet_fits(ts, c, e))


def _launch(name: str, dev, demand, w, cap, buf, dt, dims,
            body: str | None = None):
    """Launch the C entry ``name`` (four input pointers, dt, two outputs and
    two partial buffers, ``dims`` ints, the stream); returns (drop, load).
    The single-block, batched and fleet entries take no partials where their
    own bodies take the shape.  ``body`` (``None``: the autotune table's)
    "etiled" launches the E-tiled body over the pairs (``queueloss_tiles``,
    the same contiguous layout), "fleet" the fleet body through the batched
    entry; "auto" and the entry's own body keep its cut."""
    lib, max_c, links = _library()
    *lead, ts, c, e = dims
    if c > max_c:
        raise ValueError(f"{name}: C={c} exceeds the kernel's shared-memory "
                         f"chunk ({max_c})")
    if name in _FAMILY:
        if body is None:
            body = _table.body_for(_FAMILY[name], ts, c, e, dev)
        if body == "etiled":
            name, dims = "queueloss_tiles", (math.prod(lead), ts, c, e)
        elif body == "fleet" and name == "queueloss_single":
            name, dims = "queueloss_batched", (1, ts, c, e)
    out = torch.empty((2, *lead, ts), dtype=torch.float32, device=dev)
    if ((name == "queueloss_single" and _single_fits(ts, c, e))
            or (name in ("queueloss_batched", "queueloss_fleet")
                and _fleet_fits(ts, c, e))):
        part_ptrs = (None, None)
    else:
        part = torch.empty((2, *lead, ts, max(1, -(-e // links))),
                           dtype=torch.float32, device=dev)
        part_ptrs = (part[0].data_ptr(), part[1].data_ptr())
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(demand.data_ptr(), w.data_ptr(), cap.data_ptr(),
                                buf.data_ptr(), float(dt), out[0].data_ptr(),
                                out[1].data_ptr(), *part_ptrs, *dims,
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "queueloss", name, rc)
    return out[0], out[1]


def queueloss(demand: torch.Tensor, w: torch.Tensor, cap: torch.Tensor,
              buf: torch.Tensor, dt: float, *,
              body: str | None = None):
    """Per-sub-step (drop_sum, load_sum), each (TS,) float32.

    demand (TS, C), w (C, E), cap/buf (E,): contiguous float32, all on the
    CPU (plain version) or all on one CUDA device (the kernel).  The queue
    starts empty at the call and carries across all TS sub-steps.
    """
    dev = placement("queueloss", demand=demand, w=w, cap=cap, buf=buf)
    ts, c = demand.shape
    if (w.dim() != 2 or w.shape[0] != c or cap.shape != (w.shape[1],)
            or buf.shape != cap.shape):
        raise ValueError(f"queueloss: shapes {tuple(demand.shape)}, "
                         f"{tuple(w.shape)}, {tuple(cap.shape)}, "
                         f"{tuple(buf.shape)} disagree")
    if dev.type in PLAIN_DEVICES:
        return queueloss_ref(demand, w, cap, buf, dt)
    out = _launch("queueloss_single", dev, demand, w, cap, buf, dt,
                  (ts, c, w.shape[1]), body)
    global single_launches
    single_launches += 1
    return out


def queueloss_batched(demand: torch.Tensor, w: torch.Tensor, cap: torch.Tensor,
                      buf: torch.Tensor, dt: float, *,
                      body: str | None = None):
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
    if dev.type in PLAIN_DEVICES:
        return queueloss_batched_ref(demand, w, cap, buf, dt)
    out = _launch("queueloss_batched", dev, demand, w, cap, buf, dt,
                  (b, ts, c, e), body)
    global launches
    launches += 1
    return out


def _queueloss_tiles(demand, w, cap, buf, dt: float):
    """The E-tiled body and its partials pass over B epochs on the card,
    whatever the shape (what :func:`queueloss_batched` launched before it took
    the fleet body): for comparisons in ``chip_smoke.py`` and the card tests;
    no launch is counted."""
    dev = placement("queueloss_tiles", demand=demand, w=w, cap=cap, buf=buf)
    b, ts, c = demand.shape
    return _launch("queueloss_tiles", dev, demand, w, cap, buf, dt,
                   (b, ts, c, w.shape[2]))


def queueloss_fleet(demand: torch.Tensor, w: torch.Tensor, cap: torch.Tensor,
                    buf: torch.Tensor, dt: float, *,
                    body: str | None = None):
    """Per-sub-step (drop_sum, load_sum), each (F, B, TS) float32.

    demand (F, B, TS, C), w (F, B, C, E), cap/buf (F, B, E): contiguous
    float32, all on the CPU (plain version) or all on one CUDA device (the
    kernel).  The queue starts empty in every (fabric, block) pair.
    """
    dev = placement("queueloss_fleet", demand=demand, w=w, cap=cap, buf=buf)
    if demand.dim() != 4 or w.dim() != 4:
        raise ValueError(f"queueloss_fleet: demand and w must be 4-d, got "
                         f"{tuple(demand.shape)}, {tuple(w.shape)}")
    f, b, ts, c = demand.shape
    e = w.shape[3]
    if (w.shape[:3] != (f, b, c) or cap.shape != (f, b, e)
            or buf.shape != (f, b, e)):
        raise ValueError(f"queueloss_fleet: shapes {tuple(demand.shape)}, "
                         f"{tuple(w.shape)}, {tuple(cap.shape)}, "
                         f"{tuple(buf.shape)} disagree")
    if dev.type in PLAIN_DEVICES:
        return queueloss_fleet_ref(demand, w, cap, buf, dt)
    out = _launch("queueloss_fleet", dev, demand, w, cap, buf, dt,
                  (f, b, ts, c, e), body)
    global fleet_launches
    fleet_launches += 1
    return out


def _put(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # an operand already on the device
        return x.to(dev, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


def queue_loss(demand, weights, capacities, buffers, dt: float,
               backend: str = "torch", device=None):
    """Per-sub-step (drop_sum, load_sum) for a (TS, C) sub-interval demand
    block routed by ``weights (C, E)`` over links with ``capacities (E,)``
    (Gb/s) and finite buffers ``buffers (E,)`` (Gb); ``dt`` is the sub-step
    duration in seconds.

    ``backend`` is ``"torch"`` (one launch of the kernel on a CUDA device)
    or ``"numpy"``; ``device`` is the torch backend's device (``None`` =
    CUDA).  The queue starts empty at the call.  Returns ``(drop, tot)``:
    dropped volume (Gb) and offered load (Gb/s) per sub-step, each summed
    over links, shape ``(TS,)`` float64.
    """
    if backend == "numpy":  # float64 end to end
        from repro_torch.burst.queue import queue_loss_numpy

        return queue_loss_numpy(demand, weights, capacities, buffers, dt)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    drop, tot = queueloss(_put(demand, dev), _put(weights, dev),
                          _put(capacities, dev), _put(buffers, dev), dt)
    return (drop.cpu().numpy().astype(np.float64),
            tot.cpu().numpy().astype(np.float64))


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
    drop, tot = queueloss_batched(_put(demand, dev), _put(weights, dev),
                                  _put(capacities, dev), _put(buffers, dev), dt)
    return (drop.cpu().numpy().astype(np.float64),
            tot.cpu().numpy().astype(np.float64))


def queue_loss_fleet(demand, weights, capacities, buffers, dt: float,
                     backend: str = "torch", device=None):
    """Fabric-batched queue loss: one call scans every scoring block of every
    fabric in a fleet bucket.

    Args:
      demand: (F, B, TS, C) sub-interval demand blocks (zero-padded trailing
        sub-steps and all-zero padded blocks only drain queues, never drop).
      weights: (F, B, C, E); capacities/buffers: (F, B, E); dt: sub-step
        seconds.  On ``"torch"`` demand and weights may already be tensors
        on the device.
      backend: ``"torch"`` (one launch of the fleet kernel on a CUDA device)
        or ``"numpy"`` (:func:`repro_torch.burst.queue.queue_loss_numpy` per
        (fabric, block)).
      device: the torch backend's device (``None`` = CUDA).

    Queue state starts empty in every (fabric, block) pair.  Returns
    (drop, tot), each (F, B, TS) float64.
    """
    if backend == "numpy":  # float64 end to end
        from repro_torch.burst.queue import queue_loss_numpy

        out = [[queue_loss_numpy(d, w, c, bf, dt)
                for d, w, c, bf in zip(df, wf, cf, bff)]
               for df, wf, cf, bff in zip(demand, weights, capacities, buffers)]
        return (np.stack([[o[0] for o in row] for row in out]),
                np.stack([[o[1] for o in row] for row in out]))
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    drop, tot = queueloss_fleet(_put(demand, dev), _put(weights, dev),
                                _put(capacities, dev), _put(buffers, dev), dt)
    return (drop.cpu().numpy().astype(np.float64),
            tot.cpu().numpy().astype(np.float64))
