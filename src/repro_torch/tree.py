"""Nested params as plain containers: dicts (keys in sorted order, as JAX
flattens them), lists and tuples, with tensors at the leaves."""
from __future__ import annotations

from typing import Callable


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def names(tree, prefix: str = "") -> list:
    """Dotted paths of the leaves of ``tree`` (``"blocks.0.w"``), in
    ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def unflatten(like, values) -> object:
    """A tree shaped like ``like`` holding ``values`` (in ``leaves``
    order) at its leaves."""
    return _build(like, iter(values))


def _build(t, it):
    # a module-level function, not a recursive closure: a closure that
    # calls itself is a reference cycle, and it would keep ``values`` (a
    # tree of grads, gigabytes on the card) alive until the garbage
    # collector runs
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest`` (trees of the
    same shape), in a tree shaped like ``tree``."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree),
                                                    *(leaves(r) for r in rest))])
