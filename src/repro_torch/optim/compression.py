"""Gradient compression for the data-parallel axis, with error feedback —
the counterpart of ``repro/optim/compression.py``.

* top-k sparsification (keep the largest ``frac`` of entries per tensor by
  magnitude), with error feedback (the residual comes back next step);
* int8 quantization with one symmetric scale per tensor.

``compress_decompress`` is the hook ``make_train_step`` calls: a lossy round
trip that keeps the numerics of a compressed reduction.  As in the
reference, a "tensor" is an array of the reference's stacked layout (a layer
group's leaf over all its layers, :func:`repro_torch.optim.tree.stacked`),
and tensors of rank < 2 there pass unchanged.

Ties: the top-k threshold is the k-th largest magnitude, a value, and every
entry at or above it is kept; which of several tied entries ``torch.topk``
or ``jax.lax.top_k`` lists first cannot change it, so both packages keep the
same entries (all of a tie at the threshold, possibly more than k).
"""

from __future__ import annotations

import torch

from repro_torch.optim import tree as tree_util

__all__ = ["topk_sparsify", "int8_quantize", "int8_dequantize",
           "compress_decompress", "ErrorFeedback"]


def topk_sparsify(g: torch.Tensor, frac: float = 0.05):
    """Keep the top ``frac`` of entries by magnitude; return (sparse, residual)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k, sorted=True).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat, torch.zeros_like(flat)).reshape(g.shape)
    return kept, g - kept


def int8_quantize(g: torch.Tensor):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def _roundtrip(g: torch.Tensor, scheme: str, frac: float) -> torch.Tensor:
    if g.dim() < 2:
        return g
    if scheme == "topk":
        return topk_sparsify(g.float(), frac)[0]
    q, s = int8_quantize(g.float())
    return int8_dequantize(q, s)


def compress_decompress(grads, scheme: str, frac: float = 0.05):
    """The in-step lossy round trip of ``grads`` (a tree mirroring the
    parameters): ``"topk"`` or ``"int8"`` on every tensor of rank >= 2 in
    the stacked layout, the result in float32 (the others pass as given)."""
    if scheme not in ("topk", "int8"):
        raise ValueError(f"unknown compression scheme {scheme!r}")
    st = tree_util.stacked(grads)
    out = tree_util.unflatten(st, [_roundtrip(g, scheme, frac)
                                   for g in tree_util.leaves(st)])
    return tree_util.unstacked(out, grads)


class ErrorFeedback:
    """Stateful top-k with error feedback for a host-driven training loop:
    each call sparsifies the gradient plus the residual left by the last
    call, per stacked-layout tensor of rank >= 2."""

    def __init__(self, frac: float = 0.05):
        self.frac = frac
        self.residual = None

    def __call__(self, grads):
        st = tree_util.stacked(grads)
        gs = tree_util.leaves(st)
        if self.residual is None:
            self.residual = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                             for g in gs]
        kept, res = [], []
        for g, r in zip(gs, self.residual):
            if g.dim() < 2:
                kept.append(g)
                res.append(r)
                continue
            k_, r_ = topk_sparsify(g.float() + r, self.frac)
            kept.append(k_)
            res.append(r_)
        self.residual = res
        return tree_util.unstacked(tree_util.unflatten(st, kept), grads)

    def compression_ratio(self) -> float:
        """Payload bytes vs dense f32 (index+value for kept entries)."""
        return self.frac * 2.0  # 4B value + 4B index per kept / 4B dense
