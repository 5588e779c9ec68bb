"""Grouped-query attention with RoPE, optional qk-norm and sliding windows —
the counterpart of ``repro/models/attention.py``.

The full-sequence paths (:func:`self_attention`, and :func:`cross_attention`
over an encoder's output; train / prefill) go through the flash-attention
wrapper: the CUDA kernel on the card (with its backward when training), its
plain version on the CPU.  One-token decode (:func:`decode_attention`, and
cross-attention of one token) stays plain PyTorch, as in the reference;
:func:`decode_attention` writes the new key and value into the cache in
place.  On a mesh the cache (and the encoder's output) may be this rank's
tile of the sequence: each rank forms its share of the softmax over its
slots, combined over the sequence's axes (:func:`_sdpa_split`).

Tensor parallelism (Megatron): when the block is handed this rank's columns
of ``wq``/``wk``/``wv`` (its heads, and the KV heads they read) and its rows
of ``wo`` — fewer heads than ``cfg.n_heads`` —, :func:`self_attention` and
:func:`cross_attention` run those heads alone: their inputs pass
:func:`~repro_torch.parallel.sharding.tp_copy` and the row-parallel output
is summed over the model axis by
:func:`~repro_torch.parallel.sharding.tp_reduce`.  The head counts come from
the weights' shapes, so whole weights run as before, bit for bit.  Where the
model axis does not divide the heads the shares are unequal
(:func:`~repro_torch.parallel.sharding.head_range`); a rank with no heads
launches no kernel and adds zeros.  At decode the heads' shares of q and of
the new key and value are gathered over the model axis (q padded to
⌈H/m⌉ heads a rank: the all-gather takes equal shares), since every rank
reads its slots for all heads; a
cross attention whose encoder output is split over T by the model axis too
folds its key and value projections into the query and the output
(:func:`_cross_decode_split`), so that no weight and no cache tile moves.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.layers import dtype_of, init_dense, rms_norm, rope
from repro_torch.parallel import sharding as sh

__all__ = ["NEG_INF", "init_attn_params", "self_attention", "decode_attention",
           "causal_mask", "init_cross_attn_params", "cross_attention"]

NEG_INF = -2.0e38


def init_attn_params(gen, cfg, device) -> dict:
    d, hd, dt = cfg.d_model, cfg.resolved_head_dim, dtype_of(cfg)
    p = {
        "wq": init_dense(gen, (d, cfg.n_heads * hd), dtype=dt, device=device),
        "wk": init_dense(gen, (d, cfg.n_kv_heads * hd), dtype=dt, device=device),
        "wv": init_dense(gen, (d, cfg.n_kv_heads * hd), dtype=dt, device=device),
        "wo": init_dense(gen, (cfg.n_heads * hd, d), dtype=dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, dtype=dt, device=device)
        p["k_norm"] = torch.zeros(hd, dtype=dt, device=device)
    return p


def _is_split(p, cfg) -> bool:
    """Whether ``p`` holds a tensor-parallel share of the heads."""
    return p.wq.shape[-1] != cfg.n_heads * cfg.resolved_head_dim


def _project_qkv(p, x, cfg, positions):
    """q, k, v of the heads whose columns ``p`` holds (all of them unless
    tensor parallel)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p.wq).reshape(b, s, p.wq.shape[-1] // hd, hd)
    k = (x @ p.wk).reshape(b, s, p.wk.shape[-1] // hd, hd)
    v = (x @ p.wv).reshape(b, s, p.wv.shape[-1] // hd, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg):
    """q (B,S,H,hd), k/v (B,T,KV,hd), mask (B,S,T) bool; GQA via head
    grouping, scores and softmax in float32."""
    hd = q.shape[-1]
    b, s, h, _ = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / hd ** 0.5
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, hd)


def causal_mask(s: int, window: int = 0, device=None) -> torch.Tensor:
    """Causal (+ optional sliding window; 0 = global) mask (S, S), True where
    key j is visible from query i."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    mask = j <= i
    return mask & (j > i - window) if window > 0 else mask


def _out_proj(p, out, cfg):
    b, s = out.shape[:2]
    return out.reshape(b, s, p.wo.shape[0]) @ p.wo


def self_attention(p, x, cfg, window: int = 0, positions=None, causal: bool = True):
    """Full-sequence causal self-attention (train / prefill), through the
    flash-attention kernel.  x (B, S, d); ``window`` 0 = global;
    ``positions`` (B, S) the RoPE positions (default 0..S-1).  The mask is
    causal over the sequence's order whatever the positions, as in the
    reference; ``causal=False`` (an encoder) lets every query see every
    key.  On a tensor-parallel share of the heads the output is summed over
    the model axis."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    split = _is_split(p, cfg)
    if split:
        x = sh.tp_copy(x)
    if p.wq.shape[-1]:
        q, k, v = _project_qkv(p, x, cfg, positions)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
    else:  # a model rank with no heads: its (empty) product keeps tp_copy's
        out = (x @ p.wq).reshape(b, s, 0, cfg.resolved_head_dim)  # backward
    out = _out_proj(p, out, cfg)
    return sh.tp_reduce(out) if split else out


def _pad_heads(x, dim: int, width: int):
    """``x`` with zero heads appended along ``dim`` up to ``width``."""
    pad = x.new_zeros(x.shape[:dim] + (width - x.shape[dim],) + x.shape[dim + 1:])
    return torch.cat([x, pad], dim)


def _unpad_heads(x, dim: int, n: int, m: int):
    """Every rank's heads of ``x``, whose ``dim`` holds the ``m`` model
    ranks' shares of ``n`` heads one after another, each padded to ⌈n/m⌉
    (:func:`_pad_heads`): the padding dropped, in model order."""
    width = -(-n // m)
    if width * m == n:
        return x
    ranges = [sh.head_range(n, m, r) for r in range(m)]
    keep = [r * width + i for r, (lo, hi) in enumerate(ranges) for i in range(hi - lo)]
    return x.index_select(dim, torch.tensor(keep, device=x.device))


def _gather_heads(q, k, v, cfg):
    """Every head's q, k and v from this rank's tensor-parallel shares: one
    all-gather over the model axis of the three side by side (q padded to
    ⌈H/m⌉ heads; a KV head replicated over a block of model ranks kept
    once)."""
    mesh = sh.active_mesh()
    m = mesh.shape["model"]
    hq, hk = -(-cfg.n_heads // m), k.shape[2]
    both = sh.all_gather(torch.cat([_pad_heads(q, 2, hq), k, v], dim=2), 2, mesh,
                         ("model",))
    both = both.unflatten(2, (m, hq + 2 * hk))
    q, k, v = (both[:, :, :, a:b].flatten(2, 3) for a, b in
               ((0, hq), (hq, hq + hk), (hq + hk, hq + 2 * hk)))
    rep = m * hk // cfg.n_kv_heads  # model ranks that hold one KV head
    return _unpad_heads(q, 2, cfg.n_heads, m), k[:, :, ::rep], v[:, :, ::rep]


def _sdpa_split(q, k, v, mask, mesh, axes):
    """:func:`_sdpa` over keys split across the ranks of ``axes``: k/v
    (B, T_loc, KV, hd) and mask (B, S, T_loc) are this rank's slots.  The
    softmax in float32 over every rank's slots — the row max (an all-reduce
    max), then the sum of exponentials (an all-reduce sum) — its weights
    cast to the inputs' dtype as :func:`_sdpa` casts them, and the products
    with v summed in float32 over the ranks before one cast, so the
    rounding is :func:`_sdpa`'s up to the order of the sums.  A rank none of
    whose slots is visible adds zeros (its logits stay ``NEG_INF`` below a
    finite max)."""
    hd = q.shape[-1]
    b, s, h, _ = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / hd ** 0.5
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    top = sh.all_reduce(logits.amax(dim=-1, keepdim=True), mesh, axes, op="max")
    w = torch.exp(logits - top)
    w = (w / sh.all_reduce(w.sum(dim=-1, keepdim=True), mesh, axes)).to(q.dtype)
    out = sh.all_reduce(torch.einsum("bkgst,btkd->bskgd", w.float(), v.float()), mesh, axes)
    return out.reshape(b, s, h, hd).to(q.dtype)


def decode_attention(p, x, cache, pos: int, cfg, window: int = 0,
                     ring: bool = False, sharding=None):
    """One-token decode. x (B, 1, d); cache {"k","v"}: (B, S, KV, hd).

    Returns (out (B, 1, d), cache).  ``pos`` is the position of the new
    token (all sequences decode in lockstep).  The new key and value are
    written into ``cache`` in place, at ``pos`` (``pos % S`` with
    ``ring=True``: a sliding-window ring buffer whose keys are cached after
    RoPE, so masking only excludes slots not yet written).  Past the cache's
    end without ``ring`` the write lands on its last slot, as the
    reference's ``dynamic_update_slice`` clamps it.

    ``sharding`` ({"k", "v"}: their
    :class:`~repro_torch.parallel.sharding.NamedSharding`) places ``cache``
    as this rank's tile: slots ``[t·S/n, (t+1)·S/n)`` of the sequence when
    its ``n`` ranks' axes split it (``t`` the rank's index over them).  The
    slot's owner writes it, each rank reads its visible slots, and the
    softmax is combined over those axes (:func:`_sdpa_split`); no
    collective moves the cache.  On a tensor-parallel share of the heads
    the shares of q and of the new key and value are gathered first, and
    the rank's heads of the output go through its rows of ``wo``, summed
    over the model axis.
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    split = _is_split(p, cfg)
    if split:
        q, k_new, v_new = _gather_heads(q, k_new, v_new, cfg)
    axes = sh.dim_axes(sharding and sharding["k"], 1)
    mesh = sharding["k"].mesh if axes else None
    s_loc = cache["k"].shape[1]
    t = sh.axis_index(mesh, axes) if axes else 0
    s = s_loc * (math.prod(mesh.shape[a] for a in axes) if axes else 1)
    slot = pos % s if ring else min(pos, s - 1)
    if slot // s_loc == t:  # this rank holds the slot
        cache["k"][:, slot - t * s_loc] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot - t * s_loc] = v_new[:, 0].to(cache["v"].dtype)
    j = torch.arange(t * s_loc, (t + 1) * s_loc, device=x.device)
    mask = j <= pos
    if not ring and window > 0:
        mask = mask & (j > pos - window)
    mask = mask.expand(b, 1, s_loc)
    k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    out = _sdpa_split(q, k, v, mask, mesh, axes) if axes else _sdpa(q, k, v, mask, cfg)
    if not split:
        return _out_proj(p, out, cfg), cache
    h0, h1 = sh.tp_heads(cfg.n_heads)
    return sh.tp_reduce(_out_proj(p, out[:, :, h0:h1], cfg)), cache


def init_cross_attn_params(gen, cfg, device, d_enc=None) -> dict:
    """Cross-attention projections: queries from the decoder's width, keys
    and values from the encoder's (``d_enc``, default d_model)."""
    d, hd, dt = cfg.d_model, cfg.resolved_head_dim, dtype_of(cfg)
    de = d_enc or d
    return {
        "wq": init_dense(gen, (d, cfg.n_heads * hd), dtype=dt, device=device),
        "wk": init_dense(gen, (de, cfg.n_kv_heads * hd), dtype=dt, device=device),
        "wv": init_dense(gen, (de, cfg.n_kv_heads * hd), dtype=dt, device=device),
        "wo": init_dense(gen, (cfg.n_heads * hd, d), dtype=dt, device=device),
    }


def cross_attention(p, x, enc, cfg, sharding=None):
    """x (B, S, d) attends over the encoder output enc (B, T, d_enc), every
    key visible, no RoPE.  A full sequence goes through the flash-attention
    wrapper (Sq = S, Sk = T, non-causal); one token (decode) through the
    plain ``_sdpa``.  At decode ``sharding`` (``enc``'s
    :class:`~repro_torch.parallel.sharding.NamedSharding`) may name ``enc``
    as this rank's rows of T: the cross keys and values come from them, and
    the softmax is combined over T's axes (:func:`_sdpa_split`).  On a
    tensor-parallel share of the heads the block runs those heads and sums
    its output over the model axis; at decode with T split too, through
    :func:`_cross_decode_split`."""
    b, s, _ = x.shape
    t = enc.shape[1]
    hd = cfg.resolved_head_dim
    split = _is_split(p, cfg)
    axes = sh.dim_axes(sharding, 1) if s == 1 else ()
    if split and axes:
        return _cross_decode_split(p, x, enc, cfg, sharding.mesh, axes)
    if split:
        x, enc = sh.tp_copy(x), sh.tp_copy(enc)
    q = (x @ p.wq).reshape(b, s, p.wq.shape[-1] // hd, hd)
    k = (enc @ p.wk).reshape(b, t, p.wk.shape[-1] // hd, hd)
    v = (enc @ p.wv).reshape(b, t, p.wv.shape[-1] // hd, hd)
    if s == 1:
        mask = torch.ones((b, s, t), dtype=torch.bool, device=x.device)
        out = (_sdpa_split(q, k, v, mask, sharding.mesh, axes) if axes
               else _sdpa(q, k, v, mask, cfg))
    else:
        out = fa.flash_attention(q, k, v, causal=False)
    out = _out_proj(p, out, cfg)
    return sh.tp_reduce(out) if split else out


def _cross_decode_split(p, x, enc, cfg, mesh, axes):
    """One token's cross attention on this rank's heads (its columns of
    ``wq``/``wk``/``wv``, rows of ``wo``) over ``enc`` (B, T_loc, d) split
    over T by ``axes``, which hold the model axis too: no rank has its
    heads' keys for every row of T.  With no RoPE on the cross keys,
    q·k = (q Wkᵀ)·enc and Σ w v = (Σ w enc) Wv, so each rank folds ``wk``
    into its heads' queries, gathers those (B, 1, H, d) over the model axis,
    forms every head's logits over its rows of T (in ``enc``'s dtype,
    float32 after, as :func:`_sdpa`), combines the softmax over T's axes as
    :func:`_sdpa_split` does, sums the weighted rows of ``enc`` over them in
    float32, and applies its heads' ``wv`` and ``wo`` rows; the output is
    summed over the model axis."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    h_loc, kv_loc = p.wq.shape[-1] // hd, p.wk.shape[-1] // hd
    m = mesh.shape["model"]
    q = (x @ p.wq).reshape(b, kv_loc, h_loc // kv_loc, hd)
    wk = p.wk.reshape(-1, kv_loc, hd)
    qk = torch.einsum("bkgh,dkh->bkgd", q.float(), wk.float()).reshape(b, h_loc, -1)
    qk = sh.all_gather(_pad_heads(qk.to(enc.dtype), 1, -(-cfg.n_heads // m)), 1, mesh,
                       ("model",))
    qk = _unpad_heads(qk, 1, cfg.n_heads, m)  # (B, H, d)
    logits = torch.einsum("bhd,btd->bht", qk, enc).float() / hd ** 0.5
    top = sh.all_reduce(logits.amax(dim=-1, keepdim=True), mesh, axes, op="max")
    w = torch.exp(logits - top)
    w = (w / sh.all_reduce(w.sum(dim=-1, keepdim=True), mesh, axes)).to(enc.dtype)
    ctx = sh.all_reduce(torch.einsum("bht,btd->bhd", w, enc).float(), mesh, axes)
    h0, h1 = sh.tp_heads(cfg.n_heads)
    ctx = ctx[:, h0:h1].reshape(b, kv_loc, h_loc // kv_loc, -1)
    wv = p.wv.reshape(-1, kv_loc, hd)
    out = torch.einsum("bkgd,dkh->bkgh", ctx, wv.float()).to(x.dtype)
    return sh.tp_reduce(_out_proj(p, out.reshape(b, 1, h_loc, hd), cfg))
