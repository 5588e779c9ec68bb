"""Serve-step factories — the counterpart of ``repro/launch/steps.py``'s
``make_serve_step`` and ``make_prefill_step``.  Train steps and shardings are
later slices."""

from __future__ import annotations

from repro_torch.models.api import Model

__all__ = ["make_serve_step", "make_prefill_step"]


def make_serve_step(model: Model, ring: bool = False):
    """(params, cache, token, pos) -> (next_token (B, 1), cache).  ``ring``:
    the cache is a sliding-window ring (``init_cache(..., window_cache=True)``)."""

    def serve_step(params, cache, token, pos):
        logits, cache = model.decode(params, cache, token, pos, ring=ring)
        return logits[:, -1].argmax(dim=-1, keepdim=True).int(), cache

    return serve_step


def make_prefill_step(model: Model):
    """(params, batch) -> the greedy next token (B, 1) after the prompt."""

    def prefill_step(params, batch):
        logits = model.forward(params, batch)
        return logits[:, -1].argmax(dim=-1, keepdim=True).int()

    return prefill_step
