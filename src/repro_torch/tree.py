"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree``.

Parameter, adapter, optimizer and count trees are plain nested dicts.
Leaves are visited in sorted key order at every level, the order
``jax.tree`` flattens dicts in, so a sum over leaves adds in the
reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

Tree = Any


def leaves(tree: Tree) -> Iterator[Any]:
    """Every non-dict leaf, in sorted key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key])
    else:
        yield tree


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Tree, path: tuple = ()) -> Tree:
    """``fn(path, leaf)`` on every leaf, ``path`` the tuple of keys from
    the root.  Leaf rules that look other trees up by path use this rather
    than a nested recursive function: such a function refers to itself
    through its closure, a reference cycle that keeps every tree it
    closes over alive (on the card, its memory) until Python's cyclic
    collector runs."""
    if isinstance(tree, dict):
        return {key: tree_map_with_path(fn, tree[key], path + (key,))
                for key in tree}
    return fn(path, tree)


def subtree(tree: Tree, path: tuple) -> Tree:
    """The node at ``path``, or None where the path leaves the tree."""
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree
