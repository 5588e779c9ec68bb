"""Wrapper for the SSD chunk kernel (``csrc/ssd_chunk.cu``).

The counterpart of ``repro/kernels/ssd_chunk/ops.py``'s :func:`ssd_scan`,
replacing the TPU kernel ``ssd_chunk_pallas``
(``repro/kernels/ssd_chunk/ssd_chunk.py``).  A CUDA tensor calls the entry
(and adds one to :data:`launches`), a CPU tensor runs the plain version in
:mod:`.ref`; nothing falls back from one to the other.  As in the reference,
the chunk length is halved until it divides S.

On the H100 the work is float32 FMAs (operations bound it: 16.4 GFLOP at
mamba2-130m's prefill).  The TPU kernel walks the chunks of one (b, h) in
order; the entry instead runs the chunks in parallel, in the order of sums
of the plain version ``models.ssd.ssd_chunked``: three kernels in order on
the current stream (each chunk's cumulative decay; the state entering each
chunk, walked in order by (b, h, 32 state rows); then every chunk's output
in parallel, C·Bᵀ shared by a group of heads), through scratch allocated
here, B·H·(S/Q)·N·P floats for the states (201 MB at mamba2-130m's
prefill) and B·H·(2S + S/Q) for the decays.
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

launches = 0  # entry calls so far; set to 0 before a run to count its own


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """SSD over the (B, H, S, P) heads-major layout.

    x (B, H, S, P); dt (B, H, S, 1); a (H, 1, 1, 1) (negative decay rates);
    b/c (B, 1, S, N) (one group): contiguous float32, all on the CPU (plain
    version) or all on one CUDA device (the kernel).  Returns y (B, H, S, P)
    float32.  The kernel has no backward yet: on a CUDA device with grad
    mode on and an input requiring grad it raises ``NotImplementedError``
    rather than hand back an output without a gradient.
    """
    dev = placement("ssd_scan", x=x, dt=dt, a=a, b=b, c=c)
    if (dev.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, dt, a, b, c))):
        raise NotImplementedError(
            "ssd_scan: the SSD chunk kernel's backward is a later slice of the "
            "port (ROADMAP 2.9.3: the SSD chunk backward)")
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
    # scratch: the state entering each chunk; per (b, h) L and the weights
    # exp(L_Q - L)·dt over S, and each chunk's decay exp(L_Q)
    s_in = torch.empty((bsz, h, s // chunk, n, p), dtype=x.dtype, device=dev)
    scan = torch.empty(bsz * h * (2 * s + s // chunk), dtype=x.dtype, device=dev)
    lib = _build.library("ssd_chunk")
    fn = lib.ssd_chunk
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), y.data_ptr(), s_in.data_ptr(), scan.data_ptr(),
                bsz, h, s, p, n, chunk, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "ssd_chunk", "ssd_chunk", rc)
    global launches
    launches += 1
    return y
