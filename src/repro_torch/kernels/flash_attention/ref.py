"""Plain-PyTorch version of the flash-attention kernel.

The counterpart of ``repro/kernels/flash_attention/ref.py``: unfused softmax
attention over the (B·H, Sq, hd) / (B·KV, Sk, hd) layout, with the kernel's
mask semantics (``kj < seq_k``, causal, sliding window; window 0 = global).
It materializes the (B·H, Sq, Sk) score tensor that the CUDA kernel
(``csrc/flash_attention.cu``) keeps out of device memory; the wrapper in
:mod:`.ops` runs it for CPU tensors, and ``chip_smoke.py`` holds the kernel
against it on the card.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref", "bf16_rounding_bound", "kv_rows"]

NEG_INF = -2.0e38


def kv_rows(n_rows: int, n_heads: int, n_kv: int, device) -> torch.Tensor:
    """The K/V row of every q row ``r = b·H + h``: ``b·KV + h // (H/KV)``."""
    r = torch.arange(n_rows, device=device)
    return (r // n_heads) * n_kv + (r % n_heads) // (n_heads // n_kv)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  n_heads: int, n_kv: int, causal: bool, window: int):
    """q (B·H, Sq, hd); k/v (B·KV, Sk, hd) -> (B·H, Sq, hd) in q's dtype.

    Scores are taken in q's dtype and then in float32 (as the reference's
    ``einsum(...).astype(f32)``), divided by sqrt(hd), masked to ``NEG_INF``
    and normalized in float32; the weights are cast back to q's dtype before
    the product with v.
    """
    bh, sq, hd = q.shape
    sk = k.shape[1]
    rows = kv_rows(bh, n_heads, n_kv, q.device)
    k_full, v_full = k[rows], v[rows]
    s = torch.einsum("rqd,rkd->rqk", q, k_full).float() / hd ** 0.5
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
    if window > 0:
        mask = mask & (kj > qi - window)
    s = torch.where(mask[None], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("rqk,rkd->rqd", w, v_full)


def bf16_rounding_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **mask):
    """What a bfloat16 kernel may differ by from exact attention on the same
    inputs: (the plain version in float32 on ``q``, ``k``, ``v``, the bound per
    element).

    The kernel takes scores and softmax statistics in float32 and rounds
    twice to bfloat16 (unit roundoff 2^-8): the weights before the product
    with v, which costs at most 2^-8·Σ_j w_j·|v_j|, and the output, at most
    2^-8·|out|.  The bound is twice their sum, 2^-7·(Σ_j w_j·|v_j| + |out|),
    plus 1e-6 for float32 sums.  A window one key off moves some element by
    several times the bound.
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = attention_ref(qf, kf, vf, **mask)
    return ref, 2.0 ** -7 * (attention_ref(qf, kf, vf.abs(), **mask) + ref.abs()) + 1e-6
