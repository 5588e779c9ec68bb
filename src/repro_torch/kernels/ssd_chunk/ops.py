"""Wrappers for the SSD chunk kernel and its backward (``csrc/ssd_chunk.cu``).

The counterpart of ``repro/kernels/ssd_chunk/ops.py``'s :func:`ssd_scan`,
replacing the TPU kernel ``ssd_chunk_pallas``
(``repro/kernels/ssd_chunk/ssd_chunk.py``).  A CUDA tensor calls the entry
(and adds one to :data:`launches`), a CPU tensor runs the plain version in
:mod:`.ref`, and so does a ``meta`` tensor (shapes alone: the dry run);
nothing falls back from one to the other.  As in the reference,
the chunk length is halved until it divides S.

On the H100 the work is float32 FMAs (operations bound it: 14.7 GFLOP at
mamba2-130m's prefill, counting causal triangles).  The TPU kernel walks the
chunks of one (b, h) in order; the entry instead runs the chunks in
parallel, in the order of sums of the plain version
``models.ssd.ssd_chunked``: three kernels in order on the current stream
(each chunk's cumulative decay; the state entering each chunk, walked in
order by (b, h, 32 state rows); then every chunk's output in parallel,
C·Bᵀ shared by a group of heads), through scratch allocated here,
B·H·(S/Q)·N·P floats for the states (201 MB at mamba2-130m's prefill) and
B·H·(2S + S/Q) for the decays.

Training differentiates through :class:`SSDScan`, which :func:`ssd_scan`
takes whenever grad mode is on and an input requires grad.  Its backward is
:func:`ssd_scan_bwd`: on a CUDA tensor the backward entry ``ssd_chunk_bwd``
(#9b, counted in :data:`bwd_launches`), on the CPU
:func:`.ref.ssd_chunk_ref_bwd`, which is autograd through the plain version
``ssd_chunk_ref`` run again.  So the CPU computes the plain version's
gradient, as autograd straight through ``ssd_chunk_ref`` would; it goes
through the Function so that the CPU tests exercise what training runs on
the card (its routing, what it saves, how often each remat mode runs it).

The backward entry (four launches: the scan, both state walks in one
launch, the gradient kernel, da's sum) runs every product on the tensor
cores in 3xTF32: each float32 operand splits into a TF32 part rounded to
nearest and the rest, and three TF32 products stand for one, within ~1e-6
of float32 (TF32 alone would break the gradient's 1e-4 chunk invariance).
At mamba2-130m's training shape the gradient's 42.5 GFLOP bound it at 0.26
ms as 3xTF32 on the tensor cores, its route (0.63 ms on the CUDA cores); on
the card the gradient kernel is bound by the instructions around its MMAs
and the walks by the round trip of the states through scratch.  The gradient kernel is one CTA per (b,
chunk) over every head: each head's x, dy, S_in and G arrive by cp.async
into a ring of four shared-memory slots while earlier heads compute; it
takes only the causal tiles of each chunk's Q x Q products, forms the dL
term C·(S_in dy) from the dy·S_inᵀ that dc needs, and takes the head sums
of db's Wᵀ·C and dc's W·B once a chunk (B and C are one group).  No
atomics: two calls give the same bits.

The forward saves only its inputs: the backward entry recomputes the decays
and the states entering each chunk rather than keep the forward's.  Those
states are B·H·(S/Q)·N·P floats, 201 MB a layer at mamba2-130m's training
shape; saved, they would stay alive for every layer between its forward and
its backward when training runs without remat (4.8 GB over 24 layers).
Under remat a layer's scan and state walk thus run three times a step (the
forward, remat's recompute, the backward entry's); the third costs less than
the whole forward entry, which is under 4 % of a full-size mamba2-130m step
on an H100 over 24 layers (``chip_smoke.py`` phases 3 and 13; PERF.md §6).
The backward entry works at chunks of at most :data:`MAX_BWD_CHUNK` steps
(its shared memory is laid out for 64): a longer chunk is halved, which
changes only the order of sums.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import PLAIN_DEVICES, placement
# the module, not its functions: ref imports models.ssd, which imports this
# module, so either may be imported first
from repro_torch.kernels.ssd_chunk import ref

__all__ = ["MAX_BWD_CHUNK", "MAX_CHUNK", "MAX_HEAD_P", "MAX_STATE", "SSDScan",
           "bwd_launches", "launches", "ssd_scan", "ssd_scan_bwd"]

# the kernel's tile limits (csrc kMaxQ, kMaxP, kMaxN); the backward's chunk (kGQ)
MAX_CHUNK, MAX_HEAD_P, MAX_STATE = 128, 64, 128
MAX_BWD_CHUNK = 64

launches = 0  # forward entry calls so far; set to 0 before a run to count its own
bwd_launches = 0  # backward entry calls so far, counted the same way


def _check(x, dt, a, b, c, chunk: int, **more) -> tuple[torch.device, int]:
    """The device and the chunk length (halved until it divides S), after
    checking placement and shapes."""
    dev = placement("ssd_scan", x=x, dt=dt, a=a, b=b, c=c, **more)
    bsz, h, s, p = x.shape
    n = b.shape[-1]
    if (dt.shape != (bsz, h, s, 1) or a.shape != (h, 1, 1, 1)
            or b.shape != (bsz, 1, s, n) or c.shape != b.shape
            or any(t.shape != x.shape for t in more.values())):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)} "
                         f"disagree")
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    if dev.type == "cuda" and (chunk > MAX_CHUNK or p > MAX_HEAD_P or n > MAX_STATE):
        raise ValueError(f"ssd_scan: chunk {chunk}, P={p}, N={n} exceed the "
                         f"kernel's {MAX_CHUNK}, {MAX_HEAD_P}, {MAX_STATE}")
    return dev, chunk


def _forward(x, dt, a, b, c, chunk: int) -> torch.Tensor:
    dev, chunk = _check(x, dt, a, b, c, chunk)
    if dev.type in PLAIN_DEVICES:
        return ref.ssd_chunk_ref(x, dt, a, b, c, chunk)
    bsz, h, s, p = x.shape
    n = b.shape[-1]
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


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                 chunk: int = 128):
    """(dx, ddt, da, db, dc) of :func:`ssd_scan` for the output gradient
    ``dy`` (B, H, S, P), each in its input's layout.  CUDA tensors launch
    the backward entry (and add one to :data:`bwd_launches`), CPU and
    ``meta`` tensors run :func:`.ref.ssd_chunk_ref_bwd`."""
    dev, chunk = _check(x, dt, a, b, c, chunk, dy=dy)
    if dev.type in PLAIN_DEVICES:
        return ref.ssd_chunk_ref_bwd(x, dt, a, b, c, dy, chunk)
    bsz, h, s, p = x.shape
    n = b.shape[-1]
    while chunk > MAX_BWD_CHUNK or s % chunk:
        chunk //= 2
    nc = s // chunk
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    da, db, dc = torch.empty_like(a), torch.empty_like(b), torch.empty_like(c)
    f32 = dict(dtype=torch.float32, device=dev)
    # scratch: the states entering each chunk and their gradients G; per
    # (b, h) L, exp(L_Q - L)·dt and exp(L) over S and the chunks' decays; da's
    # (b, h, chunk) shares
    s_in = torch.empty((bsz, h, nc, n, p), **f32)
    g_st = torch.empty((bsz, h, nc, n, p), **f32)
    scan = torch.empty(bsz * h * (3 * s + nc), **f32)
    da_part = torch.empty(bsz * h * nc, **f32)
    lib = _build.library("ssd_chunk")
    fn = lib.ssd_chunk_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
                db.data_ptr(), dc.data_ptr(), s_in.data_ptr(), g_st.data_ptr(),
                scan.data_ptr(), da_part.data_ptr(), bsz, h, s, p, n, chunk,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "ssd_chunk", "ssd_chunk_bwd", rc)
    global bwd_launches
    bwd_launches += 1
    return dx, ddt, da, db, dc


class SSDScan(torch.autograd.Function):
    """:func:`ssd_scan` with a gradient: the forward keeps its inputs, the
    backward is :func:`ssd_scan_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: int):
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        return _forward(x, dt, a, b, c, chunk)

    @staticmethod
    def backward(ctx, dy):
        return (*ssd_scan_bwd(*ctx.saved_tensors, dy.contiguous(), ctx.chunk), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """SSD over the (B, H, S, P) heads-major layout.

    x (B, H, S, P); dt (B, H, S, 1); a (H, 1, 1, 1) (negative decay rates);
    b/c (B, 1, S, N) (one group): contiguous float32, all on the CPU (plain
    version) or all on one CUDA device (the kernel).  Returns y (B, H, S, P)
    float32, through :class:`SSDScan` when grad mode is on and an input
    requires grad, else the forward alone.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b, c)):
        return SSDScan.apply(x, dt, a, b, c, chunk)
    return _forward(x, dt, a, b, c, chunk)
