"""Wrapper for the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

The counterpart of ``repro/kernels/rglru_scan/ops.py``'s :func:`rglru_scan`:
a CUDA tensor launches the kernel (and adds one to :data:`launches`), a CPU
tensor runs the plain version in :mod:`.ref`; nothing falls back from one to
the other.  Unlike the TPU wrapper it pads nothing (no a=1 / b=0 tails): the
kernel walks any S and masks the ragged channel edge itself.  The kernel
splits S into chunks scanned in parallel and combined in a fixed order, so
its rounding differs from a sequential walk within the reference's 1e-4.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import placement
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

__all__ = ["launches", "rglru_scan"]

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
    one CUDA device (the kernel).  Returns h (B, S, D) float32.
    """
    dev = placement("rglru_scan", a=a, b=b)
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: shapes {tuple(a.shape)}, {tuple(b.shape)} "
                         f"must be one (B, S, D)")
    if dev.type == "cpu":
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
