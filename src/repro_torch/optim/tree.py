"""The port's parameter trees and the reference's stacked layout.

A tree is nested dicts of tensors with lists for layer groups (one dict per
layer), as ``Params.tree()`` gives it.  The reference keeps each layer group
as one dict of stacked arrays (leading axis L), which is what its optimizer,
compression and checkpoints see: a per-layer norm scale (d,) is an (L, d)
array there.  :func:`stacked` and :func:`unstacked` convert between the two,
and :func:`stacked_ndims` gives each leaf's rank in the stacked layout.
"""

from __future__ import annotations

import torch

__all__ = ["as_tree", "leaves", "leaves_of", "unflatten", "stacked_ndims", "stacked",
           "unstacked"]


def as_tree(t):
    """``t``'s parameter tree if it is a ``Params`` module, else ``t``."""
    return t.tree() if hasattr(t, "tree") else t


def leaves(tree) -> list:
    """The tensors of ``tree`` (a tree or a ``Params`` module) in order:
    dicts in insertion order, lists in order."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaves_of(tree) -> list:
    """The leaves of a tree of dicts and lists whose leaves are any objects
    (a tree of shardings), in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves_of(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves_of(v)]
    return [tree]


def unflatten(template, values: list):
    """``template``'s structure with its leaves replaced, in order, by
    ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    out = build(as_tree(template))
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than leaves")
    return out


def stacked_ndims(tree) -> list:
    """Each leaf's rank in the reference's stacked layout: its own, plus one
    for every layer list around it."""
    def walk(t, depth):
        if isinstance(t, dict):
            return [n for v in t.values() for n in walk(v, depth)]
        if isinstance(t, (list, tuple)):
            return [n for v in t for n in walk(v, depth + 1)]
        return [t.ndim + depth]

    return walk(as_tree(tree), 0)


def stacked(tree, stack=torch.stack):
    """The reference's layout: every layer list becomes one tree whose
    leaves are the layers' leaves stacked along a new leading axis
    (``stack``: ``torch.stack``, or ``numpy.stack`` for numpy leaves)."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return {k: stacked(v, stack) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        layers = [stacked(v, stack) for v in tree]
        return _zip(layers, stack)
    return tree


def _zip(layers, stack):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _zip([layer[k] for layer in layers], stack) for k in first}
    return stack(layers)


def unstacked(tree, template):
    """Inverse of :func:`stacked`: ``tree`` in the stacked layout split back
    into ``template``'s layer lists."""
    template = as_tree(template)
    if isinstance(template, dict):
        return {k: unstacked(tree[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [unstacked(_index(tree, i), v) for i, v in enumerate(template)]
    return tree


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
