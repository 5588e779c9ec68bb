"""Plain-PyTorch version of the flash-attention kernel.

The counterpart of ``repro/kernels/flash_attention/ref.py``: unfused softmax
attention over the (B·H, Sq, hd) / (B·KV, Sk, hd) layout, with the kernel's
mask semantics (``kj < seq_k``, causal, sliding window; window 0 = global).
It materializes the (B·H, Sq, Sk) score tensor that the CUDA kernel
(``csrc/flash_attention.cu``) keeps out of device memory; the wrapper in
:mod:`.ops` runs it for CPU tensors, and ``chip_smoke.py`` holds the kernel
against it on the card.  :func:`attention_bwd_ref` is the plain version of
the kernel's backward, from the forward's output and per-row log-sum-exp
(:func:`attention_lse_ref`).
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref", "attention_lse_ref", "attention_bwd_ref",
           "bf16_rounding_bound", "bf16_grad_rounding_bound", "kv_rows"]

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
    rows = kv_rows(q.shape[0], n_heads, n_kv, q.device)
    s = _masked_scores(q, k[rows], causal, window)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("rqk,rkd->rqd", w, v[rows])


def _masked_scores(q, k_full, causal: bool, window: int):
    """float32 scores q·kᵀ/sqrt(hd) of every q row against its K row,
    ``NEG_INF`` outside the mask."""
    sq, hd = q.shape[1:]
    sk = k_full.shape[1]
    s = torch.einsum("rqd,rkd->rqk", q, k_full).float() / hd ** 0.5
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
    if window > 0:
        mask = mask & (kj > qi - window)
    return torch.where(mask[None], s, NEG_INF)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, n_heads: int,
                      n_kv: int, causal: bool, window: int) -> torch.Tensor:
    """The per-row log-sum-exp of the masked scores (B·H, Sq), float32: the
    statistic the kernel's forward saves for its backward (m + log l)."""
    rows = kv_rows(q.shape[0], n_heads, n_kv, q.device)
    return torch.logsumexp(_masked_scores(q, k[rows], causal, window), dim=-1)


def _group_sum(x, n_heads: int, n_kv: int):
    """Sum (B·H, S, hd) over the H/KV q heads of each K/V row -> (B·KV, S, hd),
    in float32, cast back to x's dtype."""
    bh, s, hd = x.shape
    b = bh // n_heads
    return (x.float().reshape(b, n_kv, n_heads // n_kv, s, hd).sum(2)
            .reshape(b * n_kv, s, hd).to(x.dtype))


def attention_bwd_ref(q, k, v, o, d_out, lse, *, n_heads: int, n_kv: int,
                      causal: bool, window: int):
    """(dq, dk, dv) of :func:`attention_ref` for the output gradient
    ``d_out``, from its output ``o`` and :func:`attention_lse_ref` ``lse``.

    The weights are recomputed as P = exp(S - lse) (float32, masked entries
    exactly 0); dV = Pᵀ·dO with P in q's dtype, as the forward rounds it;
    dS = P∘(dP - D) with dP = dO·Vᵀ and D = rowsum(dO∘O) in float32; dQ and
    dK are dS/sqrt(hd), rounded to q's dtype, times K and Q; dK and dV sum
    over the H/KV q heads of each K/V row.
    """
    hd = q.shape[2]
    rows = kv_rows(q.shape[0], n_heads, n_kv, q.device)
    k_full, v_full = k[rows], v[rows]
    p = torch.exp(_masked_scores(q, k_full, causal, window) - lse[..., None])
    dv = torch.einsum("rqk,rqd->rkd", p.to(q.dtype), d_out)
    dp = torch.einsum("rqd,rkd->rqk", d_out, v_full).float()
    delta = (d_out.float() * o.float()).sum(-1)
    ds = (p * (dp - delta[..., None]) / hd ** 0.5).to(q.dtype)
    dq = torch.einsum("rqk,rkd->rqd", ds, k_full)
    dk = torch.einsum("rqk,rqd->rkd", ds, q)
    return dq, _group_sum(dk, n_heads, n_kv), _group_sum(dv, n_heads, n_kv)


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


def bf16_grad_rounding_bound(q, k, v, d_out, **mask):
    """What a bfloat16 backward kernel may differ by from the exact gradient
    on the same inputs: ((dq, dk, dv) of the plain version in float32 on
    ``q``, ``k``, ``v``, ``d_out``, (the bounds per element)).

    With u = 2^-8 the unit roundoff of bfloat16: the forward's output O is
    rounded, which moves D = rowsum(dO∘O) by at most u·Σ|dO||O|; each dS is
    rounded to bfloat16 before its product (u·|dS|), and P before dV's
    (u·Σ P|dO|); every output is rounded (u·|out|); dP and D carry float32
    sums, 2^-20·(|dP| + |D|).  Per element: δS = P∘(δD + 2^-20(|dP| + |D|))
    + u|dS|, and the bounds are twice dQ: δS·|K|/sqrt(hd) + u|dQ|, dK:
    δSᵀ·|Q|/sqrt(hd) + u|dK| (summed over the group) and dV: u(Pᵀ·|dO| +
    |dV|), plus 1e-6.  Taken one batch row at a time, so the (H, Sq, Sk)
    float32 intermediates of one row are all that is held.
    """
    n_heads, n_kv = mask["n_heads"], mask["n_kv"]
    u, hd = 2.0 ** -8, q.shape[2]
    n_b = q.shape[0] // n_heads
    outs, bounds = ([], [], []), ([], [], [])
    for b in range(n_b):
        qs, ds_ = slice(b * n_heads, (b + 1) * n_heads), slice(b * n_kv, (b + 1) * n_kv)
        qf, kf, vf, gf = (t[sl].float() for t, sl in ((q, qs), (k, ds_), (v, ds_),
                                                         (d_out, qs)))
        o = attention_ref(qf, kf, vf, **mask)
        lse = attention_lse_ref(qf, kf, **mask)
        grads = attention_bwd_ref(qf, kf, vf, o, gf, lse, **mask)
        rows = kv_rows(n_heads, n_heads, n_kv, q.device)
        k_full, v_full = kf[rows], vf[rows]
        p = torch.exp(_masked_scores(qf, k_full, mask["causal"], mask["window"])
                      - lse[..., None])
        dp = torch.einsum("rqd,rkd->rqk", gf, v_full)
        delta = (gf * o).sum(-1)
        d_s = p * (dp - delta[..., None])
        d_delta = u * (gf.abs() * o.abs()).sum(-1)
        err_s = (p * (d_delta[..., None] + 2.0 ** -20 * (dp.abs() + delta.abs()[..., None]))
                 + u * d_s.abs()) / hd ** 0.5
        del dp, d_s
        tq = torch.einsum("rqk,rkd->rqd", err_s, k_full.abs())
        tk = _group_sum(torch.einsum("rqk,rqd->rkd", err_s, qf.abs()), n_heads, n_kv)
        tv = _group_sum(torch.einsum("rqk,rqd->rkd", p, gf.abs()), n_heads, n_kv)
        del p, err_s
        for i, (g, t) in enumerate(zip(grads, (tq + u * grads[0].abs(),
                                               tk + u * grads[1].abs(),
                                               u * (tv + grads[2].abs())))):
            outs[i].append(g)
            bounds[i].append(2.0 * t + 1e-6)
    return (tuple(torch.cat(x) for x in outs), tuple(torch.cat(x) for x in bounds))
