"""Uniform model facade used by the launchers and the tests — the
counterpart of ``repro/models/api.py``.

``Model`` wraps one architecture on one device behind five operations:

  init(seed)                        -> DecoderLM / EncDecLM (the parameters)
  loss(params, batch, remat)        -> (scalar, metrics)      [train]
  forward(params, batch)            -> logits                 [prefill]
  init_cache(batch, max_seq)        -> per-layer decode state
  decode(params, cache, tok, pos)   -> (logits, cache)        [decode]

and, for the sharding plan, ``param_shapes()`` (the parameters on the
``meta`` device) and ``input_specs(shape)`` (a step's inputs as ``meta``
tensors in the reference's layout).

``batch`` holds ``tokens`` (and ``labels`` to train), for the vlm family
``patches`` and for the audio family ``frames``; ``audio`` runs the
encoder-decoder (:mod:`.encdec`), every other family the decoder-only model
(:mod:`.transformer`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.layers import drawing, dtype_of
from repro_torch.optim.tree import stacked

__all__ = ["LONG_CONTEXT_OK", "Model", "build_model", "supports_cell"]

LONG_CONTEXT_OK = ("ssm", "hybrid")  # families that run long_500k natively


def supports_cell(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch × shape) is a valid cell, and why not if not."""
    if shape.name == "long_500k":
        if cfg.family in LONG_CONTEXT_OK:
            return True, ""
        if cfg.window and not cfg.local_global_ratio:
            return True, ""  # pure sliding-window attention (mixtral)
        if cfg.local_global_ratio:
            return True, ""  # gemma3: locals windowed, rare globals full-KV
        return False, ("pure full-attention arch: 500k decode requires "
                       "sub-quadratic attention (skip noted in DESIGN.md)")
    return True, ""


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device

    def init(self, seed: int = 0, take=None):
        """Random parameters drawn from a ``torch.Generator`` on the model's
        device seeded with ``seed``.  ``take(w, dtype)``: what each leaf
        that ``init_dense`` draws becomes in place of its cast
        (:func:`repro_torch.models.layers.drawing`; a rank's tiles,
        :func:`repro_torch.launch.steps.init_tiles`)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._module(self.init_tree(gen, self.device, take))

    def init_tree(self, gen, device, take=None) -> dict:
        """The parameter tree that :meth:`init` wraps (nested dicts and
        lists of the very tensors made), drawn from ``gen`` on ``device``,
        each leaf that ``init_dense`` draws passed through ``take``."""
        with drawing(take):
            if self.cfg.family == "audio":
                return encdec.init_params(gen, self.cfg, device)
            return transformer.init_params(gen, self.cfg, device)

    def _module(self, tree: dict):
        if self.cfg.family == "audio":
            return encdec.EncDecLM(self.cfg, tree)
        return transformer.DecoderLM(self.cfg, tree)

    def loss(self, params, batch: dict, remat=True, run_block=None):
        """(loss, metrics) of ``batch``, differentiable; each block
        checkpointed as ``remat`` says (False, True or ``"dots"``) and, with
        ``run_block(ck, fn, blk, *args)``, run through it (a block is one
        entry of a layer list: ``transformer._ck``)."""
        if self.cfg.family == "audio":
            return encdec.loss_fn(params, batch, self.cfg, remat, run_block)
        return transformer.loss_fn(params, batch, self.cfg, remat, run_block)

    def forward(self, params, batch: dict) -> torch.Tensor:
        if self.cfg.family == "audio":
            return encdec.forward(params, batch["frames"], batch["tokens"], self.cfg)
        return transformer.forward(params, batch["tokens"], self.cfg,
                                   patches=batch.get("patches"))

    def init_cache(self, batch: int, max_seq: int, enc_len: int = 0, dtype=None,
                   window_cache: bool = False) -> dict:
        """Decode state; for the audio family also the encoder's output of
        ``enc_len`` frames (default ``max_seq``)."""
        if self.cfg.family == "audio":
            return encdec.init_cache(self.cfg, batch, max_seq, enc_len or max_seq,
                                     self.device, dtype=dtype)
        return transformer.init_cache(self.cfg, batch, max_seq, self.device,
                                      dtype=dtype, window_cache=window_cache)

    def decode(self, params, cache: dict, token: torch.Tensor, pos: int,
               ring: bool = False, shardings=None):
        """(logits, cache) of one token; ``shardings``: the cache's
        ``NamedSharding`` tree when ``cache`` holds this rank's tiles."""
        if self.cfg.family == "audio":
            return encdec.decode_step(params, cache, token, pos, self.cfg, shardings)
        return transformer.decode_step(params, cache, token, pos, self.cfg,
                                       ring=ring, shardings=shardings)

    # ---- sharding-plan specs ------------------------------------------------
    def param_shapes(self):
        """The parameters (the ``init`` module) on the ``meta`` device: shapes
        and dtypes, nothing allocated."""
        return self._module(self.init_tree(None, torch.device("meta")))

    def input_specs(self, shape: ShapeConfig, cache_dtype=None,
                    window_cache: bool = False) -> dict:
        """Stand-ins (``meta`` tensors: shape and dtype) for the inputs of the
        step the shape cell runs, with the reference's keys; a decode cell's
        ``cache`` in the reference's layout (each layer group stacked along
        a leading axis, :func:`repro_torch.optim.tree.stacked`)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        dt = dtype_of(cfg)

        def meta(*sh, dtype=torch.int32):
            return torch.empty(sh, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            label = shape.kind == "train"
            if cfg.family == "audio":
                out = {"frames": meta(b, s, cfg.d_model, dtype=dt), "tokens": meta(b, s)}
            elif cfg.family == "vlm":
                npatch = cfg.frontend_tokens
                out = {"tokens": meta(b, s - npatch),
                       "patches": meta(b, npatch, cfg.d_model, dtype=dt)}
            else:
                out = {"tokens": meta(b, s)}
            if label:
                out["labels"] = meta(*out["tokens"].shape)
                if cfg.family == "vlm":  # the reference's key order
                    out = {k: out[k] for k in ("tokens", "labels", "patches")}
            return out
        # decode: one token against a seq_len cache
        spec_model = Model(cfg, torch.device("meta"))
        cache = spec_model.init_cache(b, s, enc_len=s, dtype=cache_dtype,
                                      window_cache=window_cache)
        return {"token": meta(b, 1), "cache": stacked(cache)}


def build_model(cfg: ArchConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (``None`` = CUDA; raises without a
    card)."""
    transformer.check_family(cfg)
    return Model(cfg, resolve_device(device))
