"""Encoder–decoder transformer (seamless-m4t backbone; the audio frontend is
a stub) — the counterpart of ``repro/models/encdec.py``.

As in the reference, the encoder consumes *precomputed frame embeddings*
(B, S_enc, d); it is a bidirectional transformer (flash attention with
``causal=False``), and the decoder adds cross-attention to the encoder's
output (flash attention with Sq = S_dec, Sk = S_enc; one-token decode stays
plain).  Decode caches the decoder's self-attention K/V and the encoder's
output, and re-projects the cross K/V from it at every step, as the
reference does.

Layers are ``ModuleList`` entries run by a Python loop (the reference stacks
them and scans); serving runs under ``torch.inference_mode``, training
checkpoints each block as ``remat`` says.  The reference's sharding
constraints (``constrain``) have no counterpart on one card.  On a mesh
with a model axis the blocks run Megatron on the shares the step's plan
hands them (:func:`repro_torch.launch.steps.leaf_plans`): the encoder's
bidirectional attention, the decoder's causal and cross attention on the
rank's heads, the SwiGLU MLPs on its hidden units, and the vocabulary —
the embedding's rows and the logits' columns where the axis divides the
vocabulary, else the unembedding row-parallel over d; decode reads this
rank's tiles of the cache (:func:`decode_step`).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (dtype_of, init_dense, rms_norm,
                                       softmax_cross_entropy, vocab_parallel_cross_entropy)
from repro_torch.models.params import Params
from repro_torch.models.transformer import _ck, _embed, _mlp, _mlp_fwd, _norm, _project_logits

__all__ = ["EncDecLM", "init_params", "encode", "forward", "loss_fn",
           "init_cache", "decode_step"]


def _check_audio(cfg: ArchConfig) -> None:
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name}: encdec takes the audio family, not "
                         f"{cfg.family!r}")


def init_params(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """The parameter tree (the reference's keys; lists for the encoder's and
    the decoder's layers) on ``device``, drawn from ``gen``."""
    _check_audio(cfg)
    dt = dtype_of(cfg)

    def enc_block():
        return {"norm1": _norm(cfg, device),
                "attn": attn.init_attn_params(gen, cfg, device),
                "norm2": _norm(cfg, device),
                "mlp": _mlp(gen, cfg, device)}

    def dec_block():
        return {"norm1": _norm(cfg, device),
                "attn": attn.init_attn_params(gen, cfg, device),
                "norm_x": _norm(cfg, device),
                "xattn": attn.init_cross_attn_params(gen, cfg, device),
                "norm2": _norm(cfg, device),
                "mlp": _mlp(gen, cfg, device)}

    return {
        "embed": init_dense(gen, (cfg.vocab, cfg.d_model), scale=0.02, dtype=dt,
                            device=device),
        "enc_blocks": [enc_block() for _ in range(cfg.encoder_layers)],
        "enc_norm": _norm(cfg, device),
        "dec_blocks": [dec_block() for _ in range(cfg.n_layers)],
        "final_norm": _norm(cfg, device),
        "unembed": init_dense(gen, (cfg.d_model, cfg.vocab), dtype=dt, device=device),
    }


def _enc_block(blk, x, cfg):
    x = x + attn.self_attention(blk.attn, rms_norm(x, blk.norm1), cfg, causal=False)
    return x + _mlp_fwd(blk.mlp, rms_norm(x, blk.norm2), cfg)


def encode(params, frames: torch.Tensor, cfg: ArchConfig, remat=False,
           run_block=None) -> torch.Tensor:
    """frames (B, S_enc, d) -> the encoder's output (B, S_enc, d); each block
    run as ``remat`` and ``run_block`` say (``transformer._ck``)."""
    ck = _ck(remat, run_block)
    x = frames
    for blk in params.enc_blocks:
        x = ck(_enc_block, blk, x, cfg)
    return rms_norm(x, params.enc_norm)


def _dec_block(blk, x, enc_out, cfg, window: int = 0):
    x = x + attn.self_attention(blk.attn, rms_norm(x, blk.norm1), cfg, window=window)
    x = x + attn.cross_attention(blk.xattn, rms_norm(x, blk.norm_x), enc_out, cfg)
    return x + _mlp_fwd(blk.mlp, rms_norm(x, blk.norm2), cfg)


def _logits(params, frames, tokens, cfg, remat, run_block=None):
    _check_audio(cfg)
    enc_out = encode(params, frames, cfg, remat, run_block)
    ck = _ck(remat, run_block)
    x = _embed(params, tokens, cfg)
    for blk in params.dec_blocks:
        x = ck(_dec_block, blk, x, enc_out, cfg)
    return _project_logits(params, rms_norm(x, params.final_norm), cfg)


@torch.inference_mode()
def forward(params, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """The full encoder-decoder pass: frames (B, S_enc, d), tokens (B, S_dec)
    -> logits (B, S_dec, V) (this rank's share of V where the vocabulary is
    split)."""
    return _logits(params, frames, tokens, cfg, False)


def loss_fn(params, batch: dict, cfg: ArchConfig, remat=True, run_block=None):
    """Cross-entropy of ``batch`` (``frames``, ``tokens``, ``labels``,
    optional ``mask``) and {"ce"}; differentiable, each block checkpointed
    as ``remat`` says and run through ``run_block`` if given
    (``transformer._ck``)."""
    logits = _logits(params, batch["frames"], batch["tokens"], cfg, remat, run_block)
    ce = (vocab_parallel_cross_entropy if logits.shape[-1] != cfg.vocab
          else softmax_cross_entropy)
    loss = ce(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, enc_len: int, device,
               dtype=None) -> dict:
    """Decode state: the decoder's per-layer self-attention K/V of
    ``max_seq`` positions and the encoder's output (B, enc_len, d), zeros
    until the caller writes it (:func:`encode`)."""
    _check_audio(cfg)
    dt = dtype or dtype_of(cfg)
    hd = cfg.resolved_head_dim

    def kv():
        return {"k": torch.zeros((batch, max_seq, cfg.n_kv_heads, hd), dtype=dt,
                                 device=device),
                "v": torch.zeros((batch, max_seq, cfg.n_kv_heads, hd), dtype=dt,
                                 device=device)}

    return {"self": [kv() for _ in range(cfg.n_layers)],
            "enc_out": torch.zeros((batch, enc_len, cfg.d_model), dtype=dt,
                                   device=device)}


@torch.inference_mode()
def decode_step(params, cache: dict, token: torch.Tensor, pos: int, cfg: ArchConfig,
                shardings=None):
    """One decoder token (B, 1) against the cached self K/V and encoder
    output.  Returns (logits (B, 1, V), cache), the cache updated in place.
    ``shardings`` (the cache's
    :class:`~repro_torch.parallel.sharding.NamedSharding` tree, on a mesh)
    names ``cache`` as this rank's tiles: the self K/V's slots and the
    encoder output's rows of T, each attention's partial softmaxes combined
    over their axes (``attention._sdpa_split``); the blocks handed a
    tensor-parallel share of their weights run Megatron, and the logits are
    this rank's share of the vocabulary when the embedding is split."""
    _check_audio(cfg)
    x = _embed(params, token, cfg)
    enc_out = cache["enc_out"]
    enc_sh = None if shardings is None else shardings["enc_out"]
    for i, blk in enumerate(params.dec_blocks):
        out, cache["self"][i] = attn.decode_attention(
            blk.attn, rms_norm(x, blk.norm1), cache["self"][i], pos, cfg,
            sharding=None if shardings is None else shardings["self"][i])
        x = x + out
        x = x + attn.cross_attention(blk.xattn, rms_norm(x, blk.norm_x), enc_out, cfg,
                                     enc_sh)
        x = x + _mlp_fwd(blk.mlp, rms_norm(x, blk.norm2), cfg)
    logits = _project_logits(params, rms_norm(x, params.final_norm), cfg)
    return logits, cache


class EncDecLM(Params):
    """The encoder-decoder: the parameter tree of :func:`init_params` as an
    ``nn.Module`` (``state_dict`` keys follow the reference's parameter
    paths) with the architecture it serves."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        _check_audio(cfg)
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, frames, tokens, self.cfg)
