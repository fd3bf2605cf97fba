"""Minimal pytrees for the port's parameter and cache structures.

Nested dicts (keys visited in sorted order, as JAX orders them),
tuples, lists and NamedTuples, with tensors or arrays at the leaves and
``None`` as an empty node. ``flatten`` / ``unflatten`` round-trip a
structure through its leaf list; the serve engine and the KV coordinator
use them to turn one cache unit into one byte payload and back.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _flat(t, out: list):
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", keys, [_flat(t[k], out) for k in keys])
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return ("namedtuple", type(t), [_flat(x, out) for x in t])
    if isinstance(t, (tuple, list)):
        return (type(t).__name__, None, [_flat(x, out) for x in t])
    if t is None:
        return ("none", None, [])
    out.append(t)
    return ("leaf", None, [])


def flatten(tree) -> Tuple[List[Any], tuple]:
    """(leaves, treedef)."""
    out: List[Any] = []
    return out, _flat(tree, out)


def _build(node, it):
    kind, aux, kids = node
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    vals = [_build(k, it) for k in kids]
    if kind == "dict":
        return dict(zip(aux, vals))
    if kind == "namedtuple":
        return aux(*vals)
    return tuple(vals) if kind == "tuple" else list(vals)


def unflatten(treedef: tuple, leaves) -> Any:
    return _build(treedef, iter(leaves))


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (same
    structure)."""
    ls, treedef = flatten(tree)
    others = [leaves(r) for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(ls, *others)])


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in :func:`leaves` order, each key the leaf's
    path joined with ``/`` as the reference's ``train.checkpoint`` writes
    it from JAX key paths: a dict key bare, a sequence index as its
    number, a NamedTuple field with a leading dot (``.master/embed``,
    ``.adam/.step``)."""
    out: List[Tuple[str, Any]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + [str(k)])
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for name, x in zip(t._fields, t):
                walk(x, path + ["." + name])
        elif isinstance(t, (tuple, list)):
            for i, x in enumerate(t):
                walk(x, path + [str(i)])
        elif t is not None:
            out.append(("/".join(path), t))

    walk(tree, [])
    return out
