"""Nested dicts, lists and tuples of tensors (the port's pytrees), walked in
the JAX package's leaf order: dict keys sorted, sequences by index, as
``jax.tree_util`` flattens them there. Anything that is not a dict, list
or tuple is a leaf.

The optimizers, gradient compression and checkpoints walk trees through
these helpers, so leaf order (the global norm's summation order, a
checkpoint's keys) is the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

PyTree = Any


def leaves_with_path(tree: PyTree, path: tuple = ()
                     ) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs in leaf order; a path is the tuple of dict keys
    and sequence indices from the root."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def leaves(tree: PyTree) -> list:
    return [x for _, x in leaves_with_path(tree)]


def _get(tree: PyTree, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def leaves_up_to(tree: PyTree, other: PyTree) -> list:
    """The subtrees of ``other`` at the leaf positions of ``tree`` (JAX's
    ``treedef.flatten_up_to``): ``other`` may branch further below them."""
    return [_get(other, p) for p, _ in leaves_with_path(tree)]


def unflatten(tree: PyTree, values) -> PyTree:
    """``tree``'s structure with its leaves replaced, in leaf order, by
    ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(tree)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` of each leaf of ``tree`` and the subtrees of ``rest`` at the
    same position."""
    return unflatten(tree, [fn(x, *(_get(r, p) for r in rest))
                            for p, x in leaves_with_path(tree)])
