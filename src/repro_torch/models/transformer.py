"""Unified decoder-only model for the ``dense``, ``moe``, ``vlm``,
``hybrid`` and ``ssm`` families — the counterpart of
``repro/models/transformer.py`` for serving.

The reference stacks its layers (leading axis L) and runs them with
``jax.lax.scan`` over ``jax.checkpoint``-wrapped blocks; here every layer is
an entry of a ``ModuleList`` and the forward is a Python loop over them.
Serving (:func:`forward`, :func:`decode_step`) runs under
``torch.inference_mode`` and does not rematerialize; training
(:func:`loss_fn`) checkpoints each block as ``remat`` says (:func:`_ck`).
One card needs no sharding constraints.

Families:
  dense  — pre-norm GQA attention + SwiGLU (qwen3/llama3/deepseek/gemma3);
           gemma3's 5:1 local:global pattern gives each layer its window.
  moe    — attention + GShard MoE FFN (dbrx/mixtral; mixtral adds SWA).
  vlm    — dense backbone taking precomputed patch embeddings (the vision
           frontend is a stub, as in the reference) in front of the tokens.
  hybrid — Griffin super-blocks (rec, rec, local attention), plus trailing
           recurrent blocks when L % 3 != 0 (recurrentgemma).
  ssm    — Mamba2 SSD blocks (attention-free).
``audio`` (the encoder-decoder) is :mod:`repro_torch.models.encdec`.

Decode carries a per-layer cache (lists of dicts, one entry per layer) and
updates it in place; on a mesh, this rank's tile of each leaf
(:func:`decode_step`).

Tensor parallelism (train, prefill and decode on a mesh with a model axis):
a layer handed this rank's share of its weights runs Megatron — the
attention over its heads (:func:`repro_torch.models.attention.self_attention`),
the SwiGLU MLP over its hidden units, the moe over its experts (expert
parallelism, :mod:`repro_torch.models.moe`), the SSD block over its heads
(:mod:`repro_torch.models.ssd`), the RG-LRU block over its channels
(:mod:`repro_torch.models.rglru`), the vocabulary over its rows of the
embedding and columns of the logits, with the vocab-parallel loss (or,
where the model axis does not divide the vocabulary, the unembedding
row-parallel over d).  Which layers get a share is the step's plan
(:func:`repro_torch.launch.steps.leaf_plans`); a layer handed whole weights
runs whole, as on one card.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (dtype_of, embed, init_dense, rms_norm,
                                       softmax_cross_entropy, swiglu, swiglu_tp,
                                       unembed, vocab_parallel_cross_entropy,
                                       vocab_parallel_embed)
from repro_torch.models.params import Params
from repro_torch.parallel import sharding as sh

__all__ = ["FAMILIES", "DecoderLM", "check_family", "init_params",
           "layer_window", "backbone", "forward", "loss_fn", "init_cache",
           "decode_step"]

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not one the port "
            f"serves {FAMILIES}")


def _check_decoder(cfg: ArchConfig) -> None:
    """A decoder-only family (``audio`` is the encoder-decoder of
    :mod:`repro_torch.models.encdec`)."""
    check_family(cfg)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: the audio family is an encoder-decoder "
                         f"(repro_torch.models.encdec)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _mlp(gen, cfg, device) -> dict:
    d, ff, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
    return {"w_gate": init_dense(gen, (d, ff), dtype=dt, device=device),
            "w_up": init_dense(gen, (d, ff), dtype=dt, device=device),
            "w_down": init_dense(gen, (ff, d), dtype=dt, device=device)}


def _norm(cfg, device):
    return torch.zeros(cfg.d_model, dtype=dtype_of(cfg), device=device)


def _attn_block(gen, cfg, device) -> dict:
    """Attention then the FFN: the MoE FFN (``"moe"``) for the moe family,
    SwiGLU (``"mlp"``) otherwise."""
    block = {"norm1": _norm(cfg, device),
             "attn": attn.init_attn_params(gen, cfg, device),
             "norm2": _norm(cfg, device)}
    if cfg.family == "moe":
        block["moe"] = moe_mod.init_moe_params(gen, cfg, device)
    else:
        block["mlp"] = _mlp(gen, cfg, device)
    return block


def _rec_block(gen, cfg, device) -> dict:
    return {"norm1": _norm(cfg, device),
            "rec": rg.init_rglru_params(gen, cfg, device),
            "norm2": _norm(cfg, device),
            "mlp": _mlp(gen, cfg, device)}


def init_params(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """The parameter tree (nested dicts of tensors on ``device``, lists for
    layers) with the reference's keys, drawn from ``gen``."""
    _check_decoder(cfg)
    dt = dtype_of(cfg)
    params = {"embed": init_dense(gen, (cfg.vocab, cfg.d_model), scale=0.02,
                                  dtype=dt, device=device),
              "final_norm": _norm(cfg, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = init_dense(gen, (cfg.d_model, cfg.vocab), dtype=dt,
                                       device=device)
    if cfg.family == "hybrid":
        n_super, n_tail = divmod(cfg.n_layers, 3)
        params["super"] = [{"rec1": _rec_block(gen, cfg, device),
                            "rec2": _rec_block(gen, cfg, device),
                            "attn_blk": _attn_block(gen, cfg, device)}
                           for _ in range(n_super)]
        if n_tail:
            params["tail"] = [_rec_block(gen, cfg, device) for _ in range(n_tail)]
    elif cfg.family == "ssm":
        params["blocks"] = [{"norm1": _norm(cfg, device),
                             "ssd": ssd_mod.init_ssd_params(gen, cfg, device)}
                            for _ in range(cfg.n_layers)]
    else:
        params["blocks"] = [_attn_block(gen, cfg, device)
                            for _ in range(cfg.n_layers)]
    return params


def layer_window(cfg: ArchConfig, layer_idx: int) -> int:
    """The layer's attention window: 0 = global.  gemma3: every
    (ratio+1)-th layer is global, the others local with cfg.window."""
    if cfg.local_global_ratio and cfg.window:
        period = cfg.local_global_ratio + 1
        return 0 if layer_idx % period == period - 1 else cfg.window
    return cfg.window


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _mlp_fwd(m, x, cfg):
    """SwiGLU, tensor parallel when ``m`` holds a share of the hidden units."""
    if m.w_gate.shape[-1] != cfg.d_ff:
        return swiglu_tp(x, m.w_gate, m.w_up, m.w_down)
    return swiglu(x, m.w_gate, m.w_up, m.w_down)


def _ffn_fwd(blk, x, cfg):
    """The block's FFN on its normed input: (out, the MoE's load-balancing
    loss, or None for SwiGLU)."""
    if "moe" in blk:
        return moe_mod.moe_ffn(blk.moe, x, cfg)
    return _mlp_fwd(blk.mlp, x, cfg), None


def _attn_block_fwd(blk, x, cfg, window):
    x = x + attn.self_attention(blk.attn, rms_norm(x, blk.norm1), cfg, window=window)
    out, aux = _ffn_fwd(blk, rms_norm(x, blk.norm2), cfg)
    return x + out, aux


def _rec_block_fwd(blk, x, cfg):
    x = x + rg.recurrent_block(blk.rec, rms_norm(x, blk.norm1))
    return x + _mlp_fwd(blk.mlp, rms_norm(x, blk.norm2), cfg)


def _hybrid_super_fwd(sup, x, cfg):
    x = _rec_block_fwd(sup.rec1, x, cfg)
    x = _rec_block_fwd(sup.rec2, x, cfg)
    return _attn_block_fwd(sup.attn_blk, x, cfg, cfg.window)[0]


def _ssm_block_fwd(blk, x, cfg):
    return x + ssd_mod.ssd_block(blk.ssd, rms_norm(x, blk.norm1), cfg,
                                 chunk=cfg.ssd_chunk)


# matrix products without batch dimensions (x @ w): what ``remat="dots"``
# keeps, as the reference's ``dots_with_no_batch_dims_saveable``
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _ck(remat, run_block=None):
    """How a block runs: ``remat`` False as it is, True under
    ``torch.utils.checkpoint`` (its activations recomputed in the backward),
    ``"dots"`` the same but keeping the outputs of its matrix products.
    Returns ``call(fn, blk, *args)``.  ``run_block(ck, fn, blk, *args)``,
    if given, runs each block in ``ck``'s place (a training step on a mesh
    gathers the block's leaves inside ``ck``'s body:
    :func:`repro_torch.launch.steps.make_train_step`)."""
    if remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _dots_policy)

        def ck(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx)
    elif remat:
        def ck(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False)
    else:
        def ck(fn, *args):
            return fn(*args)
    if run_block is None:
        return ck
    return lambda fn, blk, *args: run_block(ck, fn, blk, *args)


def backbone(params, x, cfg: ArchConfig, remat=False, run_block=None):
    """Apply all blocks to the embedded input x (B, S, d), each as ``remat``
    and ``run_block`` say (:func:`_ck`).  Returns (x, the summed MoE
    load-balancing loss, float32; 0 for the other families)."""
    ck = _ck(remat, run_block)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        for sup in params.super:
            x = ck(_hybrid_super_fwd, sup, x, cfg)
        for blk in params.tail if "tail" in params else ():
            x = ck(_rec_block_fwd, blk, x, cfg)
    elif cfg.family == "ssm":
        for blk in params.blocks:
            x = ck(_ssm_block_fwd, blk, x, cfg)
    else:
        for i, blk in enumerate(params.blocks):
            x, a = ck(_attn_block_fwd, blk, x, cfg, layer_window(cfg, i))
            if a is not None:
                aux = aux + a
    return x, aux


def _vocab_split(params, cfg: ArchConfig) -> bool:
    """Whether ``params`` holds this rank's share of the vocabulary."""
    return params.embed.shape[0] != cfg.vocab


def _embed(params, tokens, cfg: ArchConfig):
    """The token embeddings (from this rank's rows of the table, summed over
    the model axis, where the vocabulary is split)."""
    if _vocab_split(params, cfg):
        return vocab_parallel_embed(tokens, params.embed)
    return embed(tokens, params.embed)


def _project_logits(params, x, cfg: ArchConfig):
    """The logits (of this rank's share of the vocabulary, tensor parallel;
    all of them from an unembedding handed as this rank's rows of d, whose
    partial products are summed over the model axis)."""
    if cfg.tie_embeddings:
        return unembed(sh.tp_copy(x) if _vocab_split(params, cfg) else x,
                       params.embed)  # (V, d) table
    w = params.unembed
    if w.shape[0] != cfg.d_model:  # row-parallel over d
        rows = slice(sh.tp_rank() * w.shape[0], (sh.tp_rank() + 1) * w.shape[0])
        return sh.tp_reduce(sh.tp_copy(x)[..., rows] @ w)
    return (sh.tp_copy(x) if w.shape[1] != cfg.vocab else x) @ w


def _logits(params, tokens, cfg, patches, remat, run_block=None):
    """(logits, aux) of the full sequence; see :func:`forward`."""
    _check_decoder(cfg)
    x = _embed(params, tokens, cfg)
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    x, aux = backbone(params, x, cfg, remat, run_block)
    logits = _project_logits(params, rms_norm(x, params.final_norm), cfg)
    if patches is not None:
        logits = logits[:, patches.shape[1]:]
    return logits, aux


@torch.inference_mode()
def forward(params, tokens: torch.Tensor, cfg: ArchConfig,
            patches: torch.Tensor | None = None) -> torch.Tensor:
    """Logits (B, S, V) for a full sequence of tokens (B, S).  ``patches``
    (B, Np, d), the vlm family's precomputed patch embeddings, go in front of
    the token embeddings; their logits are dropped."""
    return _logits(params, tokens, cfg, patches, False)[0]


def loss_fn(params, batch: dict, cfg: ArchConfig, remat=True, run_block=None):
    """The training loss of ``batch`` (``tokens``, ``labels``, optional
    ``mask`` and, for vlm, ``patches``): cross-entropy + 0.01 · the MoE
    load-balancing loss, and {"ce", "aux"}.  Differentiable; ``remat`` and
    ``run_block`` as :func:`backbone`."""
    logits, aux = _logits(params, batch["tokens"], cfg, batch.get("patches"), remat,
                          run_block)
    ce = (vocab_parallel_cross_entropy if logits.shape[-1] != cfg.vocab
          else softmax_cross_entropy)
    loss = ce(logits, batch["labels"], batch.get("mask"))
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device, dtype=None,
               window_cache: bool = False) -> dict:
    """Per-layer decode state, with KV caches of ``max_seq`` positions.
    ``window_cache``: for a pure sliding-window architecture (mixtral) a
    ring of ``min(max_seq, window)`` positions instead, decoded with
    ``ring=True``."""
    _check_decoder(cfg)
    dt = dtype or dtype_of(cfg)
    hd = cfg.resolved_head_dim
    kv_seq = max_seq
    if window_cache and cfg.window and not cfg.local_global_ratio:
        kv_seq = min(max_seq, cfg.window)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv():
        return {"k": zeros(batch, kv_seq, cfg.n_kv_heads, hd),
                "v": zeros(batch, kv_seq, cfg.n_kv_heads, hd)}

    if cfg.family == "ssm":
        d_inner, h, n = ssd_mod.dims(cfg)
        return {"blocks": [{"s": zeros(batch, h, n, ssd_mod.HEAD_P, dtype=torch.float32),
                            "conv": zeros(batch, cfg.conv_width - 1, d_inner + 2 * n)}
                           for _ in range(cfg.n_layers)]}
    if cfg.family == "hybrid":
        def rec_state():
            return {"h": zeros(batch, cfg.d_model, dtype=torch.float32),
                    "conv": zeros(batch, cfg.conv_width - 1, cfg.d_model)}

        n_super, n_tail = divmod(cfg.n_layers, 3)
        cache = {"super": [{"rec1": rec_state(), "rec2": rec_state(), "attn": kv()}
                           for _ in range(n_super)]}
        if n_tail:
            cache["tail"] = [rec_state() for _ in range(n_tail)]
        return cache
    return {"blocks": [kv() for _ in range(cfg.n_layers)]}


def _rec_step(blk, x, st, cfg, sharding=None):
    out, st = rg.recurrent_block_step(blk.rec, rms_norm(x, blk.norm1), st, sharding)
    x = x + out
    return x + _mlp_fwd(blk.mlp, rms_norm(x, blk.norm2), cfg), st


def _attn_step(blk, x, kv, pos, cfg, window, ring=False, sharding=None):
    out, kv = attn.decode_attention(blk.attn, rms_norm(x, blk.norm1), kv, pos, cfg,
                                    window=window, ring=ring, sharding=sharding)
    x = x + out
    return x + _ffn_fwd(blk, rms_norm(x, blk.norm2), cfg)[0], kv


def _at(shardings, *path):
    """The entry of a cache's sharding tree at ``path`` (``None``: no tree)."""
    for key in path:
        if shardings is None:
            return None
        shardings = shardings[key]
    return shardings


@torch.inference_mode()
def decode_step(params, cache: dict, token: torch.Tensor, pos: int,
                cfg: ArchConfig, ring: bool = False, shardings=None):
    """One new token for every sequence. token (B, 1) int; ``pos`` the
    position of the new token.  Returns (logits (B, 1, V), cache), the cache
    updated in place.  ``ring``: the KV caches are sliding-window rings
    (``init_cache(..., window_cache=True)``).

    On a mesh (:func:`repro_torch.launch.steps.make_serve_step`) ``cache``
    is this rank's tile of every leaf and ``shardings`` their
    :class:`~repro_torch.parallel.sharding.NamedSharding` tree: attention
    combines its partial softmaxes over the cache's sequence axes, the SSD
    and RG-LRU blocks update their share of the state; the layers handed a
    tensor-parallel share of their weights run Megatron, and the logits are
    this rank's share of the vocabulary when the embedding is split."""
    _check_decoder(cfg)
    x = _embed(params, token, cfg)
    if cfg.family == "ssm":
        for i, blk in enumerate(params.blocks):
            out, cache["blocks"][i] = ssd_mod.ssd_block_step(
                blk.ssd, rms_norm(x, blk.norm1), cache["blocks"][i], cfg,
                _at(shardings, "blocks", i))
            x = x + out
    elif cfg.family == "hybrid":
        for i, (sup, st) in enumerate(zip(params.super, cache["super"])):
            tiles = _at(shardings, "super", i) or {}
            x, st["rec1"] = _rec_step(sup.rec1, x, st["rec1"], cfg, tiles.get("rec1"))
            x, st["rec2"] = _rec_step(sup.rec2, x, st["rec2"], cfg, tiles.get("rec2"))
            x, st["attn"] = _attn_step(sup.attn_blk, x, st["attn"], pos, cfg,
                                       cfg.window, sharding=tiles.get("attn"))
        for i, blk in enumerate(params.tail if "tail" in params else ()):
            x, cache["tail"][i] = _rec_step(blk, x, cache["tail"][i], cfg,
                                            _at(shardings, "tail", i))
    else:
        for i, blk in enumerate(params.blocks):
            x, cache["blocks"][i] = _attn_step(blk, x, cache["blocks"][i], pos, cfg,
                                               layer_window(cfg, i), ring,
                                               _at(shardings, "blocks", i))
    logits = _project_logits(params, rms_norm(x, params.final_norm), cfg)
    return logits, cache


class DecoderLM(Params):
    """A decoder-only model: the parameter tree of :func:`init_params` as an
    ``nn.Module`` (``state_dict`` keys follow the reference's parameter
    paths) with the architecture it serves."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        _check_decoder(cfg)
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor,
                patches: torch.Tensor | None = None) -> torch.Tensor:
        return forward(self, tokens, self.cfg, patches)
