"""Nested parameter trees: dicts, lists and tuples of tensors or arrays, with
``None`` standing for an empty subtree, as in the JAX package's pytrees.

The multi-bucket trainer keeps its parameters and optimizer moments in the
JAX package's tree layout, every leaf stacked over a leading bucket axis, so
that checkpoints and parity tests map leaf for leaf onto ``jax.vmap``-ed
trees.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of the same structure; ``None``
    subtrees stay ``None``. Dict subclasses keep their type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, tree[k], *(r[k] for r in rest)))
                          for k in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in the order JAX flattens the same tree (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def take(tree: Any, b: int) -> Any:
    """Bucket ``b`` of a stacked tree."""
    return tree_map(lambda a: a[b], tree)
