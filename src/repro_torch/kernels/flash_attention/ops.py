"""Wrappers for the flash-attention kernel (``csrc/flash_attention.cu``).

The counterpart of ``repro/kernels/flash_attention/ops.py``, replacing the
TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention/flash_attention.py``).
:func:`flash_attention_rows` is the tensor-level wrapper in the kernel's
(B·H, Sq, hd) layout: a CUDA tensor launches the kernel (and adds one to
:data:`launches`), a CPU tensor runs the plain version in :mod:`.ref`;
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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import placement
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["MAX_HEAD_DIM", "launches", "flash_attention", "flash_attention_rows"]

MAX_HEAD_DIM = 256  # the widest head the kernel takes (csrc kMaxHd)

launches = 0  # kernel launches so far; set to 0 before a run to count its own

_ENTRIES = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}


def flash_attention_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         n_heads: int, n_kv: int, causal: bool, window: int):
    """q (B·H, Sq, hd); k/v (B·KV, Sk, hd) -> (B·H, Sq, hd) in q's dtype.

    Row ``r = b·H + h`` of q attends over K/V row ``b·KV + h // (H/KV)``.
    Masks: ``kj < Sk``, causal ``kj <= qi``, and with ``window > 0``
    ``kj > qi - window``.  All three tensors contiguous, of one dtype
    (float32 or bfloat16), on the CPU (plain version) or on one CUDA device
    (the kernel; softmax statistics in float32).
    """
    dev = placement("flash_attention", (torch.float32, torch.bfloat16),
                    q=q, k=k, v=v)
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
    if dev.type == "cpu":
        return attention_ref(q, k, v, n_heads=n_heads, n_kv=n_kv,
                             causal=causal, window=window)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: hd={hd} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    name = _ENTRIES[q.dtype]
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, sq, k.shape[1], hd, n_heads, n_kv, int(causal), int(window),
                1.0 / hd ** 0.5, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_attention", name, rc)
    global launches
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    qf = q.transpose(1, 2).contiguous().view(b * h, sq, hd)
    kf = k.transpose(1, 2).contiguous().view(b * kv, sk, hd)
    vf = v.transpose(1, 2).contiguous().view(b * kv, sk, hd)
    out = flash_attention_rows(qf, kf, vf, n_heads=h, n_kv=kv, causal=causal,
                               window=window)
    return out.reshape(b, h, sq, hd).transpose(1, 2)
