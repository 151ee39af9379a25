"""Minimal pytree helpers over nested dicts / lists / tuples of tensors —
the parameter and optimizer-state layout the port shares with the JAX
reference (``{"layers": [{"w": ..., "b": ...}]}``)."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply `fn` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the order ``tree_map`` visits them (dict insertion order)."""
    if isinstance(tree, dict):
        return [l for k in tree for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]
