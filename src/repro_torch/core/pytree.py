"""Trees of tensors as the JAX package's pytrees: nested dicts, tuples and
lists whose leaves are tensors (or arrays, or scalars).

The order is ``jax.tree_util``'s: a dict's keys sorted, a tuple's or a
list's items in order; ``None`` is an empty subtree.  A leaf's path key
is its keys and indices joined by "/" (``"0/g0/attn/wq"`` for a
``(params, opt)`` tuple), as ``jax.tree_util``'s path entries print.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in the JAX package's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def path_key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template, new_leaves):
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the template has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])


def dict_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts ``tree`` and the same keys
    of ``rest``; only dicts are nodes, so a leaf may be a tuple (a
    PartitionSpec, a ``(shape, dtype)`` pair)."""
    if isinstance(tree, dict):
        return {k: dict_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
