"""AdamW with linear warmup and cosine decay — the counterpart of
``repro/optim/adamw.py``, with its defaults and its arithmetic step for step:
the global-norm clip in float32, the bias corrections from the incremented
step, the learning rate from the step before it, decay only of parameters
whose array in the reference's stacked layout has rank >= 2
(:func:`repro_torch.optim.tree.stacked_ndims`: a per-layer norm scale or
RG-LRU Λ decays, the final norm does not), and each update in float32 cast
back to the parameter's dtype.

``mu`` and ``nu`` are float32 trees that mirror the parameter tree.  The
update writes the parameters (and ``mu``/``nu``) in place and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.optim import tree as tree_util

__all__ = ["AdamWState", "AdamW"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1

    def init(self, params) -> AdamWState:
        """Zero moments (float32 trees shaped like ``params``) at step 0."""
        ps = tree_util.leaves(params)

        def zeros():
            return tree_util.unflatten(params, [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in ps])

        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=ps[0].device),
                          mu=zeros(), nu=zeros())

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup → cosine decay to ``min_lr_ratio``; float32."""
        step = step.float()
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return self.lr * warm * (self.min_lr_ratio + (1 - self.min_lr_ratio) * cos)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, sum_squares=None):
        """One step: (params, new state, {"grad_norm", "lr"}).  ``grads``
        mirrors ``params`` (a tree or a ``Params`` module); the parameters,
        ``mu`` and ``nu`` are written in place.  ``sum_squares`` maps the
        leaves' sums of squares to those of the whole gradient (FSDP: a
        shard's partial sums added over the ranks); ``None`` keeps them."""
        ps = tree_util.leaves(params)
        gs = tree_util.leaves(grads)
        ms, vs = tree_util.leaves(state.mu), tree_util.leaves(state.nu)
        ndims = tree_util.stacked_ndims(params)
        if not len(ps) == len(gs) == len(ms) == len(vs):
            raise ValueError("AdamW.update: grads, params and state disagree")
        # global-norm clip
        sq = [g.float().square().sum() for g in gs]
        if sum_squares is not None:
            sq = sum_squares(sq)
        gnorm = torch.sqrt(sum(sq))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)

        step = state.step + 1
        b1c = 1 - self.b1 ** step.float()
        b2c = 1 - self.b2 ** step.float()
        lr = self.schedule(state.step)
        for p, g, m, v, nd in zip(ps, gs, ms, vs, ndims):
            g32 = g.float() * scale
            m.mul_(self.b1).add_((1 - self.b1) * g32)
            v.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
            u = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if nd >= 2:  # decay matrices only (norms/biases exempt)
                u = u + self.weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
            "grad_norm": gnorm, "lr": lr}
