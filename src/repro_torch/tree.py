"""Nested trees of tensors, walked in ``jax.tree_util``'s order.

The training half carries parameters, gradients and optimizer state as
nested dicts of tensors (a ``models.params.ParamTree`` reads as its
dict), tuples and NamedTuples.  The reference's functions walk them with
``jax.tree.map``/``jax.tree.leaves``: dict keys sorted, sequences by
index, a NamedTuple's fields in order.  Sums over leaves (the global
norm) and the checkpoint's keys follow that order, so it is kept here.
"""
from __future__ import annotations

from typing import Callable


def _node(tree):
    from repro_torch.models.params import ParamTree   # deferred: models import this
    return tree.tree() if isinstance(tree, ParamTree) else tree


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, path=()) -> list:
    """``[(path, leaf), ...]`` in ``jax.tree_util``'s order; a path element
    is a dict key, a sequence index (int) or ``"." + field`` for a
    NamedTuple's field (``str`` of JAX's ``GetAttrKey``).  ``None`` is an
    empty subtree, as in JAX."""
    tree = _node(tree)
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_path(tree[k], path + (k,))
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += leaves_with_path(getattr(tree, f), path + ("." + f,))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_path(v, path + (i,))
        return out
    return [(path, tree)]


def leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves``'s order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), called in :func:`leaves` order, keeping
    ``tree``'s structure (a ``ParamTree`` comes back as its dict)."""
    tree = _node(tree)
    rest = [_node(r) for r in rest]
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, values):
    """``tree``'s structure with ``values`` (in :func:`leaves` order) at
    its leaves."""
    it = iter(values)
    out = tree_map(lambda _: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map_n(fn: Callable, n: int, tree, *rest) -> tuple:
    """``fn`` returning ``n`` values at each leaf: ``n`` trees of
    ``tree``'s structure."""
    outs = [fn(*ls) for ls in zip(leaves(tree), *(leaves(r) for r in rest))]
    return tuple(unflatten(tree, [o[i] for o in outs]) for i in range(n))
