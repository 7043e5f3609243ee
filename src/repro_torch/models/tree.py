"""Trees of tensors: the port's counterpart of the ``jax.tree_util`` calls
that the training stack makes.

A tree is a tensor (a leaf), a dict or :class:`~repro_torch.models.nn.ParamTree`
(children by key), or a list, tuple or ``nn.ModuleList`` (children by
index). Children are visited as JAX visits them: dict keys in sorted
order, sequences in order. A leaf's path is spelled as ``jax.tree_util.keystr``
spells it for the same nesting (``['layers'][0]['ln1']['scale']``), so a
checkpoint's leaf order and paths agree between the two packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch
from torch import nn

from repro_torch.models.nn import ParamTree

__all__ = ["flatten_with_paths", "tree_leaves", "tree_map", "tree_rebuild"]


def _children(node) -> List[Tuple[Any, str]]:
    """(key, path step) of each child of an inner node, in visiting order;
    None for a leaf."""
    if isinstance(node, dict):
        return [(k, f"[{k!r}]") for k in sorted(node)]
    if isinstance(node, ParamTree):
        return [(k, f"[{k!r}]") for k in sorted(node.keys())]
    if isinstance(node, (list, tuple, nn.ModuleList)):
        return [(i, f"[{i}]") for i in range(len(node))]
    if isinstance(node, torch.Tensor):
        return None
    raise TypeError(f"unexpected tree node {type(node).__name__}")


def _walk(node, path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    kids = _children(node)
    if kids is None:
        yield path, node
        return
    for key, step in kids:
        yield from _walk(node[key], path + step)


def flatten_with_paths(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) of every leaf, in JAX's order."""
    return list(_walk(tree, ""))


def tree_leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in _walk(tree, "")]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (indexed by the same keys), in JAX's order. Returns plain
    containers: dicts for dicts and ``ParamTree``, lists for lists and
    ``ModuleList``, tuples for tuples."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    out = [(k, tree_map(fn, tree[k], *(r[k] for r in rest))) for k, _ in kids]
    if isinstance(tree, (dict, ParamTree)):
        return dict(out)
    values = [v for _, v in out]
    return tuple(values) if isinstance(tree, tuple) else values


def tree_rebuild(like, leaves: List[torch.Tensor]):
    """A tree of ``like``'s structure and container types holding
    ``leaves`` (in JAX's order). A leaf under a module becomes an
    ``nn.Parameter`` with its counterpart's ``requires_grad``."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            new = next(it)
            if isinstance(node, nn.Parameter):
                return nn.Parameter(new, requires_grad=node.requires_grad)
            return new
        built = {k: build(node[k]) for k, _ in kids}
        if isinstance(node, ParamTree):
            return ParamTree({k: built[k] for k in node.keys()})
        if isinstance(node, dict):
            return {k: built[k] for k in node}
        values = [built[i] for i in range(len(node))]
        if isinstance(node, nn.ModuleList):
            return nn.ModuleList(values)
        return tuple(values) if isinstance(node, tuple) else values

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
