"""Uniform model facade used by the launcher and the tests — the
counterpart of ``repro/models/api.py`` for serving.

``Model`` wraps one architecture on one device behind four operations:

  init(seed)                        -> DecoderLM (the parameters)
  forward(params, batch)            -> logits                 [prefill]
  init_cache(batch, max_seq)        -> per-layer decode state
  decode(params, cache, tok, pos)   -> (logits, cache)        [decode]

``batch`` holds ``tokens`` and, for the vlm family, ``patches``.

``loss`` (training) is a later slice and raises.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig, ShapeConfig

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

    def init(self, seed: int = 0) -> transformer.DecoderLM:
        """Random parameters drawn from a ``torch.Generator`` on the model's
        device seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return transformer.DecoderLM(
            self.cfg, transformer.init_params(gen, self.cfg, self.device))

    def loss(self, params, batch):
        raise NotImplementedError("training (Model.loss) is a later slice of "
                                  "the port (ROADMAP 2.9)")

    def forward(self, params, batch: dict) -> torch.Tensor:
        return transformer.forward(params, batch["tokens"], self.cfg,
                                   patches=batch.get("patches"))

    def init_cache(self, batch: int, max_seq: int, dtype=None,
                   window_cache: bool = False) -> dict:
        return transformer.init_cache(self.cfg, batch, max_seq, self.device,
                                      dtype=dtype, window_cache=window_cache)

    def decode(self, params, cache: dict, token: torch.Tensor, pos: int,
               ring: bool = False):
        return transformer.decode_step(params, cache, token, pos, self.cfg,
                                       ring=ring)


def build_model(cfg: ArchConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (``None`` = CUDA; raises without a
    card).  ``audio`` raises ``NotImplementedError``."""
    transformer.check_family(cfg)
    return Model(cfg, resolve_device(device))
