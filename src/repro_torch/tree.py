"""Nested dicts of tensors: the port's parameter, gradient and optimizer
state trees."""
from __future__ import annotations

from collections.abc import Mapping


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure (the leaves
    of ``tree`` and the matching ones of each of ``rest``), as a new nested
    dict."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree, prefix=""):
    """("a/b/c", leaf) for every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from tree_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v
