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
           "tree_unflatten", "keystr", "is_layer_list", "stack_layers",
           "unstack_layers", "stacked_leaves_with_path", "tree_get",
           "tree_replace"]


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


def is_layer_list(node, in_list: bool = True) -> bool:
    """A list of per-layer dicts inside a list: the port's form of a layout
    group (``params["groups"][gi]``), which the reference stacks into
    ``[R, ...]`` leaves.  A list of dicts directly under a dict key is not
    one (``cache["groups"]`` holds one dict per layout group)."""
    return in_list and isinstance(node, list) and bool(node) \
        and all(isinstance(e, dict) for e in node)


def stack_layers(node, *, clone: bool = False, _in_list: bool = False):
    """Per-layer lists of dicts -> one dict of stacked ``[R, ...]`` leaves,
    the reference's layout.  Other leaves are kept as they are, or copied
    with ``clone=True`` (so that the result shares no tensor with
    ``node``)."""
    if is_layer_list(node, _in_list):
        import torch
        return tree_map(lambda *xs: torch.stack(xs), node[0], *node[1:])
    if isinstance(node, dict):
        return {k: stack_layers(v, clone=clone) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(stack_layers(x, clone=clone, _in_list=True)
                          for x in node)
    if clone and hasattr(node, "clone"):
        return node.clone()
    return node


def unstack_layers(stacked, like, _in_list: bool = False):
    """Inverse of `stack_layers` against the port's tree ``like``: each
    stacked group leaf goes back to a per-layer list of views, and every
    other leaf is reshaped to ``like``'s shape where it differs."""
    if is_layer_list(like, _in_list):
        n = len(like)
        return [tree_map(
            lambda s, l, r=r: s.reshape((n,) + tuple(l.shape))[r],
            stacked, like[r]) for r in range(n)]
    if isinstance(like, dict):
        return {k: unstack_layers(stacked[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(unstack_layers(s, l, True)
                          for s, l in zip(stacked, like))
    if tuple(stacked.shape) != tuple(like.shape):
        return stacked.reshape(like.shape)
    return stacked


def stacked_leaves_with_path(tree, path: Tuple = (), _in_list: bool = False):
    """``[(ref_path, parts)]`` in the flattening order of
    ``stack_layers(tree)``, without stacking: ``ref_path`` is the leaf's
    path in the reference's layout (a layer list's index dropped) and
    ``parts`` the ``[(port_path, tensor)]`` it stacks, one per layer (one
    part for a leaf outside the layer lists)."""
    if is_layer_list(tree, _in_list):
        return [(path + inner, [(path + (r,) + inner, tree_get(layer, inner))
                                for r, layer in enumerate(tree)])
                for inner, _ in tree_leaves_with_path(tree[0])]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in stacked_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree)
                for pl in stacked_leaves_with_path(x, path + (i,), True)]
    return [(path, [(path, tree)])]


def tree_get(tree, path: Tuple):
    """The leaf (or subtree) at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def tree_replace(tree, path: Tuple, value):
    """``tree`` with the leaf at ``path`` swapped for ``value``: the
    containers along the path are copied, everything else is shared."""
    if not path:
        return value
    k, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {**tree, k: tree_replace(tree[k], rest, value)}
    items = list(tree)
    items[k] = tree_replace(items[k], rest, value)
    return type(tree)(items)
