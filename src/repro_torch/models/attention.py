"""Grouped-query attention with RoPE, optional qk-norm and sliding windows —
the counterpart of ``repro/models/attention.py``.

The full-sequence paths (:func:`self_attention`, and :func:`cross_attention`
over an encoder's output; train / prefill) go through the flash-attention
wrapper: the CUDA kernel on the card (with its backward when training), its
plain version on the CPU.  One-token decode (:func:`decode_attention`, and
cross-attention of one token) stays plain PyTorch, as in the reference;
:func:`decode_attention` writes the new key and value into the cache in
place.

Tensor parallelism (Megatron): when the block is handed this rank's columns
of ``wq``/``wk``/``wv`` (its heads, and the KV heads they read) and its rows
of ``wo`` — fewer heads than ``cfg.n_heads`` —, :func:`self_attention` runs
those heads alone: its input passes :func:`~repro_torch.parallel.sharding.tp_copy`
and its row-parallel output is summed over the model axis by
:func:`~repro_torch.parallel.sharding.tp_reduce`.  The head counts come from
the weights' shapes, so whole weights run as before, bit for bit.
"""

from __future__ import annotations

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


def self_attention(p, x, cfg, window: int = 0, positions=None):
    """Full-sequence causal self-attention (train / prefill), through the
    flash-attention kernel.  x (B, S, d); ``window`` 0 = global;
    ``positions`` (B, S) the RoPE positions (default 0..S-1).  The mask is
    causal over the sequence's order whatever the positions, as in the
    reference.  On a tensor-parallel share of the heads the output is summed
    over the model axis."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    split = _is_split(p, cfg)
    if split:
        x = sh.tp_copy(x)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    out = _out_proj(p, out, cfg)
    return sh.tp_reduce(out) if split else out


def decode_attention(p, x, cache, pos: int, cfg, window: int = 0,
                     ring: bool = False):
    """One-token decode. x (B, 1, d); cache {"k","v"}: (B, S, KV, hd).

    Returns (out (B, 1, d), cache).  ``pos`` is the position of the new
    token (all sequences decode in lockstep).  The new key and value are
    written into ``cache`` in place, at ``pos`` (``pos % S`` with
    ``ring=True``: a sliding-window ring buffer whose keys are cached after
    RoPE, so masking only excludes slots not yet written).
    """
    if _is_split(p, cfg):
        raise NotImplementedError(f"decode_attention on a tensor-parallel share of "
                                  f"the heads ({sh.TP_ROADMAP})")
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    s = cache["k"].shape[1]
    slot = pos % s if ring else pos
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    j = torch.arange(s, device=x.device)
    mask = j <= pos
    if not ring and window > 0:
        mask = mask & (j > pos - window)
    mask = mask.expand(b, 1, s)
    out = _sdpa(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), mask, cfg)
    return _out_proj(p, out, cfg), cache


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


def cross_attention(p, x, enc, cfg):
    """x (B, S, d) attends over the encoder output enc (B, T, d_enc), every
    key visible, no RoPE.  A full sequence goes through the flash-attention
    wrapper (Sq = S, Sk = T, non-causal); one token (decode) through the
    plain ``_sdpa``."""
    b, s, _ = x.shape
    t = enc.shape[1]
    hd = cfg.resolved_head_dim
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, hd)
    k = (enc @ p.wk).reshape(b, t, cfg.n_kv_heads, hd)
    v = (enc @ p.wv).reshape(b, t, cfg.n_kv_heads, hd)
    if s == 1:
        mask = torch.ones((b, s, t), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, cfg)
    else:
        out = fa.flash_attention(q, k, v, causal=False)
    return _out_proj(p, out, cfg)
