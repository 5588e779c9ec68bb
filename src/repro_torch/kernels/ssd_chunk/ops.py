"""Wrapper for the SSD chunk kernel (``csrc/ssd_chunk.cu``).

The counterpart of ``repro/kernels/ssd_chunk/ops.py``'s :func:`ssd_scan`: a
CUDA tensor launches the kernel (and adds one to :data:`launches`), a CPU
tensor runs the plain version in :mod:`.ref`; nothing falls back from one to
the other.  As in the reference, the chunk length is halved until it divides
S.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import placement
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

__all__ = ["MAX_CHUNK", "MAX_HEAD_P", "MAX_STATE", "launches", "ssd_scan"]

# the kernel's tile limits (csrc kMaxQ, kMaxP, kMaxN)
MAX_CHUNK, MAX_HEAD_P, MAX_STATE = 128, 64, 128

launches = 0  # kernel launches so far; set to 0 before a run to count its own


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """SSD over the (B, H, S, P) heads-major layout.

    x (B, H, S, P); dt (B, H, S, 1); a (H, 1, 1, 1) (negative decay rates);
    b/c (B, 1, S, N) (one group): contiguous float32, all on the CPU (plain
    version) or all on one CUDA device (the kernel).  Returns y (B, H, S, P)
    float32.
    """
    dev = placement("ssd_scan", x=x, dt=dt, a=a, b=b, c=c)
    bsz, h, s, p = x.shape
    n = b.shape[-1]
    if (dt.shape != (bsz, h, s, 1) or a.shape != (h, 1, 1, 1)
            or b.shape != (bsz, 1, s, n) or c.shape != b.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)} "
                         f"disagree")
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    if dev.type == "cpu":
        return ssd_chunk_ref(x, dt, a, b, c, chunk)
    if chunk > MAX_CHUNK or p > MAX_HEAD_P or n > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {chunk}, P={p}, N={n} exceed the "
                         f"kernel's {MAX_CHUNK}, {MAX_HEAD_P}, {MAX_STATE}")
    y = torch.empty_like(x)
    lib = _build.library("ssd_chunk")
    fn = lib.ssd_chunk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), y.data_ptr(), bsz, h, s, p, n, chunk,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "ssd_chunk", "ssd_chunk", rc)
    global launches
    launches += 1
    return y
