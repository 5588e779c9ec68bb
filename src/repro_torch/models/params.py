"""The parameter tree as an ``nn.Module``: one node per dict of the
reference's parameter pytree, with the same keys, so ``state_dict()`` names
match the reference's paths (stacked layers become ``ModuleList`` entries:
``blocks.3.attn.wq``)."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Params", "TensorTree"]


class Params(nn.Module):
    """Tensors become parameters, dicts sub-nodes and lists of dicts
    ``ModuleList``s of sub-nodes.  Parameters start without gradients, as
    serving wants them; training turns them on (``requires_grad_()``)."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = tuple(tree)
        for key, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(key, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, list):
                self.add_module(key, nn.ModuleList(Params(v) for v in value))
            else:
                self.add_module(key, Params(value))

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> dict:
        """The parameter tree with the keys and order it was built from:
        nested dicts of this node's parameters, lists for its layer lists."""
        out = {}
        for key in self._keys:
            if key in self._parameters:
                out[key] = self._parameters[key]
            elif isinstance(self._modules[key], nn.ModuleList):
                out[key] = [m.tree() for m in self._modules[key]]
            else:
                out[key] = self._modules[key].tree()
        return out


class TensorTree:
    """A parameter tree's tensors under the names a :class:`Params` node
    gives them (``blk.attn.wq``, ``"moe" in blk``), each the very tensor
    given: not made a parameter, so the output of a differentiable op (a
    leaf gathered inside a training step's checkpointed block) keeps its
    place in the graph."""

    def __init__(self, tree: dict):
        self._tree = tree

    def __contains__(self, key: str) -> bool:
        return key in self._tree

    def __getattr__(self, key: str):
        try:
            value = self.__dict__["_tree"][key]
        except KeyError:
            raise AttributeError(key) from None
        if isinstance(value, dict):
            return TensorTree(value)
        if isinstance(value, list):
            return [TensorTree(v) for v in value]
        return value
