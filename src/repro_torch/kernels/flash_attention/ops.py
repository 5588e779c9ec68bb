"""Wrappers for the flash-attention kernel (``csrc/flash_attention.cu``).

The counterpart of ``repro/kernels/flash_attention/ops.py``, replacing the
TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention/flash_attention.py``).
:func:`flash_attention_rows` is the tensor-level wrapper in the kernel's
(B·H, Sq, hd) layout: a CUDA tensor launches the kernel (and adds one to
:data:`launches`), a CPU tensor runs the plain version in :mod:`.ref`,
and so does a ``meta`` tensor (shapes alone: the dry run);
nothing falls back from one to the other.  :func:`flash_attention` takes the
model's (B, S, H, hd) layout.  Unlike the TPU wrapper it pads nothing: the
kernel masks the ragged sequence edge itself and takes any hd up to 256, and
it scales by the true hd.

Operations bound the kernel on the H100 (206 GFLOP at recurrentgemma-9b's
prefill, 0.21 ms at the bf16 tensor-core rate).  The bfloat16 entry does
both products on the tensor cores (``mma.sync`` bf16 -> f32, as the TPU
kernel's dots), 128-row q-tiles against 64-key tiles copied ahead with
``cp.async``.  The float32 entry keeps a CUDA-core body of float32 FMAs: no
TF32 rounding, which the 2e-3 contract and the float32 decode-vs-forward
check rely on.

Training differentiates through :class:`FlashAttention`, which
:func:`flash_attention` takes whenever grad mode is on and an input requires
grad: its forward also saves the rows' log-sum-exp, and its backward
launches the backward kernels (``csrc/flash_attention_bwd.cu``,
``flash_attention_bwd_{bf16,f32}``: dQ with D = rowsum(dO∘O), then dK/dV
on clusters that split each GQA group's heads; bf16 on ``wgmma``; counted in
:data:`bwd_launches`), or runs :func:`.ref.attention_bwd_ref` for CPU
tensors.  Serving takes the forward alone, as before, with the same launches
and the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import PLAIN_DEVICES, placement
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

__all__ = ["MAX_HEAD_DIM", "launches", "bwd_launches", "FlashAttention",
           "flash_attention", "flash_attention_rows", "flash_attention_bwd_rows"]

MAX_HEAD_DIM = 256  # the widest head the kernel takes (csrc kMaxHd)

launches = 0  # forward launches so far; set to 0 before a run to count its own
bwd_launches = 0  # backward launches so far, counted the same way

_DTYPES = (torch.float32, torch.bfloat16)
_ENTRIES = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRIES = {torch.float32: "flash_attention_bwd_f32",
                torch.bfloat16: "flash_attention_bwd_bf16"}


def _check(q, k, v, n_heads: int, n_kv: int) -> torch.device:
    dev = placement("flash_attention", _DTYPES, q=q, k=k, v=v)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} disagree")
    bh, sq, hd = q.shape
    if (n_kv < 1 or n_heads % n_kv or bh % n_heads
            or k.shape[0] != bh // n_heads * n_kv or k.shape[2] != hd):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not fit H={n_heads}, KV={n_kv}")
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError("flash_attention: q, k and v must share one dtype")
    if dev.type == "cuda" and hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: hd={hd} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    return dev


def _entry(library: str, table: dict, dtype, n_ptrs: int, tail=()):
    """The library and its entry for ``dtype``, ``argtypes`` set: pointers,
    eight ints, the scale, ``tail`` and the stream."""
    lib = _build.library(library)
    name = table[dtype]
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8 + [
        ctypes.c_float, *tail, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, name, fn


def _launch_forward(q, k, v, dev, n_heads, n_kv, causal, window, with_lse):
    """One launch of the forward kernel: (out, lse or None)."""
    bh, sq, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    lib, name, fn = _entry("flash_attention", _ENTRIES, q.dtype, 5)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                0 if lse is None else lse.data_ptr(), bh, sq, k.shape[1], hd,
                n_heads, n_kv, int(causal), int(window), 1.0 / hd ** 0.5,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_attention", name, rc)
    global launches
    launches += 1
    return out, lse


def flash_attention_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         n_heads: int, n_kv: int, causal: bool, window: int,
                         with_lse: bool = False):
    """q (B·H, Sq, hd); k/v (B·KV, Sk, hd) -> (B·H, Sq, hd) in q's dtype, and
    with ``with_lse`` also the rows' log-sum-exp (B·H, Sq) float32, which the
    backward takes: (out, lse).

    Row ``r = b·H + h`` of q attends over K/V row ``b·KV + h // (H/KV)``.
    Masks: ``kj < Sk``, causal ``kj <= qi``, and with ``window > 0``
    ``kj > qi - window``.  All three tensors contiguous, of one dtype
    (float32 or bfloat16), on the CPU (plain version) or on one CUDA device
    (the kernel; softmax statistics in float32).  No gradient: see
    :class:`FlashAttention`.
    """
    dev = _check(q, k, v, n_heads, n_kv)
    mask = dict(n_heads=n_heads, n_kv=n_kv, causal=causal, window=window)
    if dev.type in PLAIN_DEVICES:
        out = attention_ref(q, k, v, **mask)
        return (out, attention_lse_ref(q, k, **mask)) if with_lse else out
    out, lse = _launch_forward(q, k, v, dev, with_lse=with_lse, **mask)
    return (out, lse) if with_lse else out


def flash_attention_bwd_rows(q, k, v, o, d_out, lse, *, n_heads: int, n_kv: int,
                             causal: bool, window: int):
    """(dq, dk, dv) of :func:`flash_attention_rows` for the output gradient
    ``d_out``, from its output ``o`` and the rows' log-sum-exp ``lse``
    (B·H, Sq) float32.  CUDA tensors launch the backward kernel (and add one
    to :data:`bwd_launches`), CPU and ``meta`` tensors run
    :func:`.ref.attention_bwd_ref`.
    No row may have every key masked (the causal and the cross-attention
    masks of the models never do)."""
    dev = _check(q, k, v, n_heads, n_kv)
    placement("flash_attention backward", _DTYPES[:1], lse=lse)
    mask = dict(n_heads=n_heads, n_kv=n_kv, causal=causal, window=window)
    d_out = d_out.contiguous()
    placement("flash_attention backward", (q.dtype,), o=o, d_out=d_out)
    if dev.type in PLAIN_DEVICES:
        return attention_bwd_ref(q, k, v, o, d_out, lse, **mask)
    return _launch_backward(q, k, v, o, d_out, lse, dev, **mask)[:3]


def _launch_backward(q, k, v, o, d_out, lse, dev, *, n_heads, n_kv, causal, window,
                     parts: int = 3):
    """One launch of the backward entry: (dq, dk, dv, delta).  ``parts``
    picks its kernels (1 = dQ, which also writes D = rowsum(dO∘O); 2 =
    dK/dV, which reads D); anything but 3 leaves the other outputs unwritten
    and serves only to time a part."""
    bh, sq, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, sq), dtype=torch.float32, device=dev)
    lib, name, fn = _entry("flash_attention_bwd", _BWD_ENTRIES, q.dtype, 10,
                           (ctypes.c_int,))
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), bh, sq, k.shape[1], hd, n_heads, n_kv,
                int(causal), int(window), 1.0 / hd ** 0.5, parts,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_attention_bwd", name, rc)
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv, delta


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention_rows` with a gradient: the forward also keeps
    the rows' log-sum-exp, the backward is :func:`flash_attention_bwd_rows`."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads: int, n_kv: int, causal: bool, window: int):
        mask = dict(n_heads=n_heads, n_kv=n_kv, causal=causal, window=window)
        out, lse = flash_attention_rows(q, k, v, with_lse=True, **mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_rows(q, k, v, out, d_out, lse, **ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) -> (B, Sq, H, hd), through
    :class:`FlashAttention` when grad mode is on and an input requires grad,
    else the forward alone."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    qf = q.transpose(1, 2).contiguous().view(b * h, sq, hd)
    kf = k.transpose(1, 2).contiguous().view(b * kv, sk, hd)
    vf = v.transpose(1, 2).contiguous().view(b * kv, sk, hd)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = FlashAttention.apply(qf, kf, vf, h, kv, causal, window)
    else:
        out = flash_attention_rows(qf, kf, vf, n_heads=h, n_kv=kv, causal=causal,
                                   window=window)
    return out.reshape(b, h, sq, hd).transpose(1, 2)
