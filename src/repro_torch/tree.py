"""Trees of tensors (parameters, optimizer states, caches) in the JAX
package's flatten order.

A tree is made of dicts, lists, tuples, NamedTuples, the dataclasses
registered with :func:`register_dataclass` and leaves; ``None`` is an
empty node, which holds no leaf.  Leaves come in JAX's order: a dict's
values by sorted key, a list's or tuple's items by index, a
NamedTuple's fields in order, a registered dataclass's data fields in
the order given.  A checkpoint's ``leaf_%05d.npy`` files follow that
order, so one written by either package restores in the other.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

_DATACLASSES: dict[type, tuple[str, ...]] = {}


def register_dataclass(cls: type, data_fields: tuple[str, ...]) -> type:
    """Make instances of the dataclass ``cls`` inner nodes whose children
    are ``data_fields`` (its other fields are static, as in
    ``jax.tree_util.register_dataclass``)."""
    _DATACLASSES[cls] = tuple(data_fields)
    return cls


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> tuple[list, Callable[[list], Any]] | None:
    """(children in JAX's order, rebuild from new children) of an inner
    node; None for a leaf."""
    if node is None:
        return [], lambda _: None
    if isinstance(node, dict):
        keys = sorted(node)
        # the rebuilt dict keeps the node's own key order
        return [node[k] for k in keys], lambda ch: {k: dict(zip(keys, ch))[k] for k in node}
    if _is_namedtuple(node):
        return list(node), lambda ch: type(node)(*ch)
    if isinstance(node, (list, tuple)):
        return list(node), lambda ch: type(node)(ch)
    fields = _DATACLASSES.get(type(node))
    if fields is not None:
        return ([getattr(node, f) for f in fields],
                lambda ch: dataclasses.replace(node, **dict(zip(fields, ch))))
    return None


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    out: list = []

    def walk(node):
        ch = _children(node)
        if ch is None:
            out.append(node)
        else:
            for c in ch[0]:
                walk(c)

    walk(tree)
    return out


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in JAX's order)."""
    leaves = list(leaves)
    n = len(tree_leaves(like))
    if n != len(leaves):
        raise ValueError(f"the tree has {n} leaves, got {len(leaves)}")
    it = iter(leaves)

    def build(node):
        ch = _children(node)
        if ch is None:
            return next(it)
        children, rebuild = ch
        return rebuild([build(c) for c in children])

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves of rest at that place)`` over ``tree``'s leaves;
    each of ``rest`` has ``tree``'s structure down to ``tree``'s leaves,
    where it may hold a subtree (or ``None``), as with
    ``treedef.flatten_up_to``.  A dict's values are visited in its own
    key order (``init_params`` draws its weights in that order) and
    matched with ``rest`` by key."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    ch = _children(tree)
    if ch is None:
        return fn(tree, *rest)
    children, rebuild = ch
    rest_children = [_children(r)[0] for r in rest]
    return rebuild([tree_map(fn, c, *(rc[i] for rc in rest_children))
                    for i, c in enumerate(children)])
