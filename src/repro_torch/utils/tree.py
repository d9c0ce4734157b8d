"""Nested dict / list / tuple trees of tensors, the port's pytrees.

Leaves are visited in a fixed order (dict keys in insertion order, then
sequence positions), and a leaf's path is written as JAX's ``keystr``
writes it: ``['layers'][0]['mixer']['wq']``.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs in leaf order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_leaves(tree) -> List:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """A tree of the same structure with ``fn(leaf, *other_leaves)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` (in leaf order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
