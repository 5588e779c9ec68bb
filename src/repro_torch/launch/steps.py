"""Train and serve step builders — the counterpart of
``repro/launch/steps.py``.

``make_train_step`` builds the training step: microbatched gradient
accumulation in float32, the model's loss with each block checkpointed as
``StepConfig.remat`` says, the optional gradient-compression hook, then the
AdamW update, in place.  ``make_serve_step`` / ``make_prefill_step`` build the
one-token decode step and the prefill step, under ``torch.inference_mode``.
The sharding assignments (``input_shardings`` and the rest) are the
multi-card slice (ROADMAP 2.3).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.api import Model
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compression import compress_decompress

__all__ = ["StepConfig", "make_train_step", "make_serve_step", "make_prefill_step"]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    remat: bool | str = True  # False | True | "dots"
    compression: str = "none"  # "none" | "topk" | "int8" (DP-axis grads)


def make_train_step(model: Model, opt: AdamW, step_cfg: StepConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` (the model's ``nn.Module``) is updated in place and returned.
    With ``microbatches`` k > 1 the batch's leading axis splits into k
    microbatches whose gradients accumulate as ``grad.float() / k`` into
    float32 buffers, in order, as the reference's scan does (the gradients
    come from ``torch.autograd.grad``: no ``.grad`` field accumulates).
    ``metrics`` holds ``loss`` (the microbatches' mean), ``grad_norm`` and
    ``lr``, as tensors on the device.
    """
    k = step_cfg.microbatches

    def grads_of(params, plist, batch):
        loss, _ = model.loss(params, batch, remat=step_cfg.remat)
        return loss.detach(), torch.autograd.grad(loss, plist)

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        tree = params.tree()
        plist = tree_util.leaves(tree)
        if k > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in plist]
            losses = []
            for i in range(k):
                mb = {key: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
                      for key, x in batch.items()}
                loss, grads = grads_of(params, plist, mb)
                for a, g in zip(acc, grads):
                    a.add_(g.float() / k)
                losses.append(loss)
                del grads
            grads, loss = acc, torch.stack(losses).mean()
        else:
            loss, grads = grads_of(params, plist, batch)
        grads = tree_util.unflatten(tree, list(grads))
        if step_cfg.compression != "none":
            grads = compress_decompress(grads, step_cfg.compression)
        params, opt_state, om = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_serve_step(model: Model, ring: bool = False):
    """(params, cache, token, pos) -> (next_token (B, 1), cache).  ``ring``:
    the cache is a sliding-window ring (``init_cache(..., window_cache=True)``)."""

    @torch.inference_mode()
    def serve_step(params, cache, token, pos):
        logits, cache = model.decode(params, cache, token, pos, ring=ring)
        return logits[:, -1].argmax(dim=-1, keepdim=True).int(), cache

    return serve_step


def make_prefill_step(model: Model):
    """(params, batch) -> the greedy next token (B, 1) after the prompt."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        logits = model.forward(params, batch)
        return logits[:, -1].argmax(dim=-1, keepdim=True).int()

    return prefill_step
