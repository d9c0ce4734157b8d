"""Pytree helpers: the port of ``repro.utils.trees``.

``tree_bytes`` and ``tree_param_count`` over the port's trees (nested
dicts, lists and tuples of tensors).  They read only shapes and dtypes,
so they count meta tensors (the dryrun's abstract params and state) as
they count real ones.
"""
from __future__ import annotations

import math

from repro_torch.utils.tree import tree_leaves


def _size_bytes(x) -> int:
    return math.prod(x.shape) * x.dtype.itemsize


def tree_bytes(tree) -> int:
    return sum(_size_bytes(x) for x in tree_leaves(tree))


def tree_param_count(tree) -> int:
    return sum(math.prod(x.shape) for x in tree_leaves(tree))
