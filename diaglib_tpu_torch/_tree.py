"""Trees of results: a tensor or plain scalar (a leaf), or a dict, tuple or
list of trees, or a dataclass instance (the package's frozen results)."""

from __future__ import annotations

import dataclasses

__all__ = ["children", "leaves"]


def children(tree):
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def leaves(tree):
    """The leaves of ``tree``, depth first."""
    kids = children(tree)
    if kids is None:
        yield tree
        return
    for _, v in kids:
        yield from leaves(v)
