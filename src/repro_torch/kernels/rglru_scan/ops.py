"""Wrapper for the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

The counterpart of ``repro/kernels/rglru_scan/ops.py``'s :func:`rglru_scan`:
a CUDA tensor launches the kernel (and adds one to :data:`launches`), a CPU
tensor runs the plain version in :mod:`.ref`, and so does a ``meta`` tensor
(shapes alone: the dry run); nothing falls back from one to the other.  Unlike the TPU wrapper it pads nothing (no a=1 / b=0 tails): the
kernel walks any S and masks the ragged channel edge itself.  The kernel
splits S into chunks scanned in parallel and combined in a fixed order, so
its rounding differs from a sequential walk within the reference's 1e-4.

Training differentiates through :class:`RGLRUScan` (:func:`rglru_scan`
takes it whenever grad mode is on and an input requires grad).  For
h_t = a_t·h_{t-1} + b_t the gradient g = dL/db is the same recurrence run
backwards, g_t = dh_t + a_{t+1}·g_{t+1} (a_S = 0): one more launch of the
kernel on the time-reversed dh with a shifted one step; then
dL/da_t = g_t·h_{t-1} (h_{-1} = 0) from the saved forward output.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import PLAIN_DEVICES, placement
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

__all__ = ["launches", "RGLRUScan", "rglru_scan", "rglru_scan_bwd"]

launches = 0  # kernel launches so far; set to 0 before a run to count its own
_FN = None  # (library, entry) with argtypes set, on first use


def _entry():
    """The library and its ``rglru_scan`` entry, ``argtypes`` set once."""
    global _FN
    if _FN is None:
        lib = _build.library("rglru_scan")
        fn = lib.rglru_scan
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = (lib, fn)
    return _FN


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Linear recurrence h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1.

    a, b: (B, S, D) contiguous float32, both on the CPU (plain version) or on
    one CUDA device (the kernel).  Returns h (B, S, D) float32, through
    :class:`RGLRUScan` when grad mode is on and an input requires grad.
    """
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RGLRUScan.apply(a, b)
    return _scan(a, b)


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """(da, db) of h = :func:`rglru_scan` (a, b) for the gradient ``dh``,
    from ``a`` and the forward's ``h``: the reversed recurrence through the
    kernel (the plain version on the CPU), one launch."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    g = _scan(a_next.flip(1), dh.flip(1).contiguous()).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g


class RGLRUScan(torch.autograd.Function):
    """:func:`rglru_scan` with a gradient (:func:`rglru_scan_bwd`)."""

    @staticmethod
    def forward(ctx, a, b):
        h = _scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, dh)


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel, or the plain version on the CPU."""
    dev = placement("rglru_scan", a=a, b=b)
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: shapes {tuple(a.shape)}, {tuple(b.shape)} "
                         f"must be one (B, S, D)")
    if dev.type in PLAIN_DEVICES:
        return rglru_scan_ref(a, b)
    bsz, s, d = a.shape
    h = torch.empty_like(a)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, s, d,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "rglru_scan", "rglru_scan", rc)
    global launches
    launches += 1
    return h
