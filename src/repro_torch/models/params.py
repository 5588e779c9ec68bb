"""The parameter tree as an ``nn.Module``: one node per dict of the
reference's parameter pytree, with the same keys, so ``state_dict()`` names
match the reference's paths (stacked layers become ``ModuleList`` entries:
``blocks.3.attn.wq``)."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Params"]


class Params(nn.Module):
    """Tensors become parameters (without gradients: training is a later
    slice), dicts sub-nodes and lists of dicts ``ModuleList``s of sub-nodes."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(key, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, list):
                self.add_module(key, nn.ModuleList(Params(v) for v in value))
            else:
                self.add_module(key, Params(value))

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules
