"""Nests of tensors: a tensor, or a dict, list or tuple of nests, as the
port's parameters, AEs and optimizer states are (the port's stand-in for
``jax.tree``)."""
from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of nests of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a nest, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out
