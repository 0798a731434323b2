# Port of the jax.tree helpers that repro/optim, repro/checkpoint and
# repro/launch/train.py call (jax.tree.map, jax.tree.leaves,
# jax.tree_util.tree_flatten_with_path), over the port's trees.
"""Trees: nested dicts, lists and tuples whose other values are leaves
(tensors, arrays, numbers).

The order is jax's: a dict's entries by sorted key, a list's or tuple's
by index. A leaf's path joins its keys and indices with ``/``
(``segments/0/1/mixer/w_q``), as the reference's checkpoint manager
names a leaf, so the two managers read each other's files.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (each with ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in jax's order."""
    if not is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, v in _children(tree):
        out += leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in jax's order, by
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            new = {k: build(v) for k, v in _children(node)}
            return {k: new[k] for k in node}          # keep the key order
        if isinstance(node, (list, tuple)):
            out = [build(v) for v in node]
            return out if isinstance(node, list) else tuple(out)
        return next(it)
    return build(tree)
