"""Shared building blocks: RMSNorm, RoPE, SwiGLU, embeddings, initializers
and the training loss — the counterpart of ``repro/models/layers.py``.
Weights keep the reference's (in, out) layout, so a product is ``x @ w``.

Tensor parallelism over the active mesh's model axis (Megatron): a SwiGLU
MLP on this rank's columns of ``w_gate``/``w_up`` and rows of ``w_down``
(:func:`swiglu_tp`), and the vocabulary split over the model axis: the
embedding's rows (:func:`vocab_parallel_embed`), the logits' columns and
the loss over them (:func:`vocab_parallel_cross_entropy`)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.parallel import sharding as sh

__all__ = ["dtype_of", "rms_norm", "rope", "swiglu", "embed", "unembed",
           "init_dense", "drawing", "softmax_cross_entropy", "swiglu_tp",
           "vocab_parallel_embed", "vocab_parallel_cross_entropy"]

# while a ``drawing`` block runs: what ``init_dense`` hands each drawn leaf to
_take = None


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype named by ``cfg.dtype`` ("bfloat16", "float32")."""
    return getattr(torch, cfg.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm in float32, scaled by ``1 + scale`` (zero-initialized)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Rotary embedding of the two halves of the head dimension (not
    interleaved pairs).  x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def swiglu_tp(x, w_gate, w_up, w_down):
    """SwiGLU on this rank's share of the hidden units (column-parallel
    ``w_gate``/``w_up``, row-parallel ``w_down``), summed over the model
    axis."""
    return sh.tp_reduce(swiglu(sh.tp_copy(x), w_gate, w_up, w_down))


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens`` (``F.embedding``, whose gradient
    on the card sums each row's tokens in a fixed order)."""
    return F.embedding(tokens, table)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return x @ table.T


def _vocab_share(rows: int, ids: torch.Tensor):
    """(ids local to this rank's rows of the vocabulary, 0 outside them;
    whether each id lies inside)."""
    local = ids.long() - sh.tp_rank() * rows
    inside = (local >= 0) & (local < rows)
    return torch.where(inside, local, 0), inside


def vocab_parallel_embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The embedding from this rank's rows of the table (the vocabulary
    split over the model axis): the ids outside them give zeros, and the
    sum over the model axis adds each token's one row to zeros (exact)."""
    local, inside = _vocab_share(table.shape[0], tokens)
    out = F.embedding(local, table) * inside[..., None].to(table.dtype)
    return sh.tp_reduce(out)


def init_dense(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Normal(0, scale) in float32, cast to ``dtype``; ``scale`` defaults to
    1/sqrt(fan_in) with fan_in = ``shape[-2]`` (``shape[0]`` for a vector).
    Inside a :func:`drawing` block the scaled float32 draw goes to its
    ``take(w, dtype)``, whose result is returned instead of the cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    scale = scale if scale is not None else 1.0 / fan_in ** 0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    w.mul_(scale)
    if _take is not None:
        return _take(w, dtype)
    return w.to(dtype)


@contextlib.contextmanager
def drawing(take):
    """Within the block, :func:`init_dense` hands each leaf it draws (the
    float32 draw, scaled) to ``take(w, dtype)`` and returns what it gives
    back, in draw order: a leaf can be cut to a tile before it is cast, and
    the whole draw dropped before the next (``None``: the plain cast)."""
    global _take
    before, _take = _take, take
    try:
        yield
    finally:
        _take = before


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy over the (optionally masked) tokens, in float32;
    logits (..., V), labels int (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    return _mean_nll(nll, mask)


def _mean_nll(nll, mask):
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`softmax_cross_entropy` of logits whose last dim is this rank's
    share of the vocabulary (in order of the model index), in float32: the
    rows' maximum and sum of exponentials are reduced over the model axis,
    and the target's logit comes from the rank that holds it."""
    logits = logits.float()
    m = sh.tp_max(logits.max(dim=-1).values)
    sumexp = sh.tp_reduce(torch.exp(logits - m[..., None]).sum(dim=-1))
    local, inside = _vocab_share(logits.shape[-1], labels)
    gold = sh.tp_reduce(logits.gather(-1, local[..., None])[..., 0] * inside.float())
    return _mean_nll(torch.log(sumexp) + m - gold, mask)
