"""Nested containers of tensors (the reference's pytrees) for the training
state: dicts, lists, tuples and NamedTuples, walked in the reference's
order — a dict's keys sorted, a sequence by index — so that flat keys,
optimizer state and checkpoints line up with ``jax.tree_util``'s.

A path element is a dict key, a sequence index, or ``.field`` for a
NamedTuple's field (``str`` of JAX's ``GetAttrKey``), so that
``(params, AdamWState(step, mu, nu))`` flattens to ``0::embed``,
``1::.step``, ``1::.mu::stack::attn::wq`` …, as the reference's
checkpointer names them.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

SEP = "::"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """``[(flat key, leaf)]`` in the reference's order."""
    out = []

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for name, child in kids:
            walk(child, f"{prefix}{SEP}{name}" if prefix else name)
    walk(tree, "")
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _rebuild(tree, values: list):
    """A new container of ``tree``'s type holding ``values`` (one per
    child, in ``tree``'s own order)."""
    if isinstance(tree, dict):
        return dict(zip(tree, values))
    if _is_namedtuple(tree):
        return type(tree)(*values)
    return type(tree)(values)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``), in new containers of the same structure."""
    if _children(tree) is None:
        return fn(tree, *rest)
    keys = list(tree) if isinstance(tree, dict) else range(len(tree))
    return _rebuild(tree, [tree_map(fn, tree[k], *(r[k] for r in rest))
                           for k in keys])


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(flat key, leaf)`` over the leaves of ``tree``, in new
    containers of the same structure."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    mapped = {name: tree_map_with_path(
        fn, child, f"{prefix}{SEP}{name}" if prefix else name)
        for name, child in kids}
    if isinstance(tree, dict):
        return {k: mapped[str(k)] for k in tree}
    return _rebuild(tree, [mapped[name] for name, _ in kids])


def unflatten(flat) -> dict:
    """``{"a::b": leaf}`` → ``{"a": {"b": leaf}}`` (dict nodes only)."""
    out: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(SEP)
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def structure(tree) -> str:
    """The containers of ``tree`` with ``*`` for each leaf (the checkpoint
    meta file's ``treedef``)."""
    kids = _children(tree)
    if kids is None:
        return "*"
    inner = ", ".join(f"{k}: {structure(v)}" for k, v in kids)
    if isinstance(tree, dict):
        return "{" + inner + "}"
    return f"{type(tree).__name__}({inner})"
