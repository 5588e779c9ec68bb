"""Train and serve step builders — the counterpart of
``repro/launch/steps.py``.

``make_train_step`` builds the training step: microbatched gradient
accumulation in float32, the model's loss with each block checkpointed as
``StepConfig.remat`` says, the optional gradient-compression hook, then the
AdamW update, in place.  ``make_serve_step`` / ``make_prefill_step`` build the
one-token decode step and the prefill step, under ``torch.inference_mode``.

With a mesh (:func:`repro_torch.launch.mesh.make_host_mesh`: one rank per
card) the training step is FSDP, i.e. ZeRO-3: each rank holds its shard of
every parameter and of AdamW's moments along the dim that
:func:`repro_torch.parallel.sharding.param_shardings` names, gathers the
whole parameters before the forward, and reduce-scatters the gradients into
their mean over the ranks after the backward; the update runs on the shards.

``input_shardings`` / ``cache_shardings`` / ``train_state_shardings``
assign a :class:`~repro_torch.parallel.sharding.NamedSharding` to every
batch, cache and train-state leaf per (arch × shape × mesh), by the
reference's rules:
  * batch dims shard over the dp axes when divisible, else stay replicated
    (long_500k has batch 1);
  * decode-cache sequence dims shard over "model" (and over the dp axes too
    when batch cannot absorb them) — the context-parallel KV layout;
  * SSM/recurrent state shards heads/channels over "model".
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.api import Model
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.compression import compress_decompress
from repro_torch.parallel.sharding import (Mesh, NamedSharding, PartitionSpec as P,
                                           check_executable, dp_axes, fit_spec,
                                           gather_tensor, param_shardings,
                                           reduce_gradient, shard_dim, use_mesh)

__all__ = ["StepConfig", "make_train_step", "make_serve_step", "make_prefill_step",
           "input_shardings", "cache_shardings", "train_state_shardings",
           "module_like"]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    remat: bool | str = True  # False | True | "dots"
    compression: str = "none"  # "none" | "topk" | "int8" (DP-axis grads)


def module_like(params, values: list):
    """A parameter module of ``params``' type, architecture and structure
    whose leaves are ``values`` (in ``tree_util.leaves`` order), not copied."""
    return type(params)(params.cfg, tree_util.unflatten(params, values))


def _all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the mesh's ranks (a world of one: ``x``)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size(mesh.group) > 1:
        x = x.clone()
        dist.all_reduce(x, group=mesh.group)
    return x


def make_train_step(model: Model, opt: AdamW, step_cfg: StepConfig,
                    mesh: Mesh | None = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` (the model's ``nn.Module``) is updated in place and returned.
    With ``microbatches`` k > 1 the batch's leading axis splits into k
    microbatches whose gradients accumulate as ``grad.float() / k`` into
    float32 buffers, in order, as the reference's scan does (the gradients
    come from ``torch.autograd.grad``: no ``.grad`` field accumulates).
    ``metrics`` holds ``loss`` (the microbatches' mean), ``grad_norm`` and
    ``lr``, as tensors on the device.

    With a ``mesh`` (its ``model`` axis of size 1) the step is FSDP:
    ``params`` and the moments of ``opt_state`` hold this rank's shards
    (:func:`repro_torch.runtime.trainer.Trainer` makes them), ``batch`` its
    slice of the global batch.  The step gathers every parameter whole (all
    at once: the configurations trained here fit a card whole, and their
    moments are what FSDP divides), runs the forward and backward on the
    whole local tensors — the hand-written kernels among them —, compresses
    the local gradients if ``compression`` says so, reduce-scatters them
    into their float32 mean over the ranks (all-reduces a replicated leaf),
    and updates the shards; the global-norm clip sums each leaf's squares
    over the ranks.  ``loss`` is the mean of the ranks' losses.  On a
    world of one every collective is the identity, so the step gives the
    unsharded step's bits.
    """
    k = step_cfg.microbatches

    def grads_of(params, plist, batch):
        loss, _ = model.loss(params, batch, remat=step_cfg.remat)
        return loss.detach(), torch.autograd.grad(loss, plist)

    def local_grads(params, batch):
        """(loss, gradient tree) of ``batch`` at ``params``."""
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
        return loss, grads

    def train_step(params, opt_state, batch):
        loss, grads = local_grads(params, batch)
        params, opt_state, om = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}

    if mesh is None:
        return train_step
    check_executable(mesh)
    with use_mesh(mesh):
        shardings = tree_util.leaves_of(param_shardings(mesh, model.param_shapes()))
    sharded = [shard_dim(s) is not None for s in shardings]
    n_ranks = mesh.size

    def sum_squares(sq: list) -> list:
        """Each leaf's sum of squares over the whole gradient: the shards'
        partial sums added over the ranks (a replicated leaf's is whole)."""
        idx = [i for i, sh in enumerate(sharded) if sh]
        if idx:
            tot = _all_reduce_sum(torch.stack([sq[i] for i in idx]), mesh)
            sq = list(sq)
            for j, i in enumerate(idx):
                sq[i] = tot[j]
        return sq

    def fsdp_step(shards, opt_state, batch):
        full = module_like(shards, [gather_tensor(x, s) for x, s in
                                    zip(tree_util.leaves(shards), shardings)])
        loss, grads = local_grads(full, batch)
        del full
        grads = [reduce_gradient(g, s)
                 for g, s in zip(tree_util.leaves(grads), shardings)]
        loss = _all_reduce_sum(loss, mesh) / n_ranks
        shards, opt_state, om = opt.update(tree_util.unflatten(shards, grads),
                                           opt_state, shards, sum_squares=sum_squares)
        return shards, opt_state, {"loss": loss, **om}

    return fsdp_step


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


# ---------------------------------------------------------------------------
# sharding assignment
# ---------------------------------------------------------------------------

def _dp_for(mesh: Mesh, n: int):
    """dp axes if they divide n (or n divides them evenly enough): else None."""
    axes = dp_axes(mesh)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    if n % size == 0:
        return axes
    return None


def _map_named(tree, fn, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def input_shardings(mesh: Mesh, cfg: ArchConfig, shape: ShapeConfig, specs) -> dict:
    """A :class:`NamedSharding` per leaf of ``Model.input_specs``."""
    dp = _dp_for(mesh, shape.global_batch)

    def assign(name, leaf):
        nd = len(leaf.shape)
        if name == "cache":
            raise AssertionError  # handled by cache_shardings
        if name in ("tokens", "labels", "mask", "token"):
            spec = P(dp, *([None] * (nd - 1)))
        elif name in ("patches", "frames"):
            spec = P(dp, "model", None)
        else:
            spec = P(*([None] * nd))
        return NamedSharding(mesh, fit_spec(mesh, leaf.shape, spec))

    out = {}
    for key, leaf in specs.items():
        if key == "cache":
            out[key] = cache_shardings(mesh, cfg, shape, leaf)
        else:
            out[key] = assign(key, leaf)
    return out


def cache_shardings(mesh: Mesh, cfg: ArchConfig, shape: ShapeConfig, cache_shapes):
    """Decode-cache shardings in the reference's (stacked) layout: (L, B, S,
    KV, hd) KV caches, SSM/recurrent states, the encoder's output."""
    dp = _dp_for(mesh, shape.global_batch)

    def assign(path, leaf):
        name = str(path[-1]) if path else ""
        nd = len(leaf.shape)
        if name in ("k", "v"):  # (L, B, S, KV, hd)
            if dp is not None:
                spec = P(None, dp, "model", None, None)
            else:
                # batch too small (long_500k): context-parallel over everything
                spec = P(None, None, tuple(dp_axes(mesh)) + ("model",), None, None)
        elif name == "s":  # SSM state (L, B, H, N, P)
            spec = P(None, dp, "model", None, None)
            if leaf.shape[2] % mesh.shape["model"]:
                spec = P(None, dp, None, "model", None)  # shard N instead of H
        elif name == "conv":  # (L, B, K-1, convdim)
            spec = P(None, dp, None, "model")
        elif name == "h":  # rec state (L, B, dr)
            spec = P(None, dp, "model")
        elif name == "enc_out":  # (B, T, d)
            if dp is not None:
                spec = P(dp, "model", None)
            else:
                spec = P(None, tuple(dp_axes(mesh)) + ("model",), None)
        else:
            spec = P(*([None] * nd))
        return NamedSharding(mesh, fit_spec(mesh, leaf.shape, spec))

    return _map_named(cache_shapes, assign)


def train_state_shardings(mesh: Mesh, model: Model, opt: AdamW):
    """(param shardings, opt-state shardings) from the FSDP/TP rules: the
    moments shard as their parameters, the step count is replicated."""
    with use_mesh(mesh):
        pshard = param_shardings(mesh, model.param_shapes())
    oshard = AdamWState(step=NamedSharding(mesh, P()), mu=pshard, nu=pshard)
    return pshard, oshard
