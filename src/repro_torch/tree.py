"""Nested containers of tensors ("trees"), the port's stand-in for JAX's
pytrees.

A tree is a dict, list or tuple of trees, or a leaf (anything else).
Dict keys are visited in sorted order, as ``jax.tree`` does, so a state
carried over from the reference package flattens to its leaves in the same
order in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_leaves_with_path",
           "tree_unflatten", "keystr"]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the leaves at the same place
    in each of ``rest``, which must share its structure down to it)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in flattening order; a path is a tuple of dict keys
    and sequence indices."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree)
                for pl in tree_leaves_with_path(x, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in flattening
    order."""
    it = iter(leaves)

    def take(_):
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the structure holds") \
                from None

    out = tree_map(take, like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()


def keystr(path: Tuple) -> str:
    """``('params', 'groups', 0)`` -> ``"['params']['groups'][0]"``, the
    form of ``jax.tree_util.keystr``."""
    return "".join(f"[{k!r}]" for k in path)
