"""Nested dicts of tensors as the port's pytrees.

The JAX package keeps parameters, optimizer state and unit state as
pytrees of nested dicts; the port keeps the same dicts of tensors.  These
helpers walk them in ``jax.tree_util``'s order (dict keys sorted) and name
each leaf by its ``jax.tree_util.keystr`` path (``"['l0']['wqkv']"``), so a
leaf list or a checkpoint key lines up with the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_unflatten", "leaves_with_paths"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which have its structure), into a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util`` order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """A tree with the structure of ``like`` whose leaves are ``leaves``,
    given in ``tree_leaves(like)`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)
