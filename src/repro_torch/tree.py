"""Trees of tensors in the JAX package's order.

The train state is the reference's pytree: nested dicts, and the
optimizer's ``OptState`` named tuple, with tensors as leaves.  JAX walks a
dict in sorted key order and a named tuple in field order, and names a
leaf by its path: dict keys as they are, a named tuple's field as
``.<field>`` (``jax.tree_util.GetAttrKey``), joined by ``/``.  These
helpers walk the port's trees the same way, so that a sum over leaves
(``adamw.global_norm``) runs in the reference's order and a checkpoint's
leaf paths (``checkpoint.manager``) equal the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in JAX's order; ``None`` is an
    empty subtree, as in JAX."""
    def join(key: str) -> str:
        return f"{prefix}/{key}" if prefix else key

    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], join(str(k)))
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += flatten_with_path(getattr(tree, f), join(f".{f}"))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten_like(tree, new_leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}        # the caller's key order
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if node is None:
            return None
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten_like: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("tree_map: trees with different numbers of leaves")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*flat)])
