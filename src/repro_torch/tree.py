"""Nested dicts of tensors (port-only module): the few pytree operations the
training path needs, in the reference's leaf order.

A tree is a dict of trees or a leaf; dicts are walked in sorted key order,
as ``jax.tree_util`` flattens them, and ``None`` is an empty subtree.  A
leaf's path is its keys joined by ``/`` (``"stage0/b0/ffn/wi"``), the
reference's ``join_path`` form.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def walk(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key tuple, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], prefix + (str(k),))
    elif tree is not None:
        yield prefix, tree


def named_leaves(tree: Any) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's flattening order."""
    for path, leaf in walk(tree):
        yield "/".join(path), leaf


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in named_leaves(tree)]


def flatten(tree: Any) -> Dict[str, Any]:
    """{path: leaf}."""
    return dict(named_leaves(tree))


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return None if tree is None else fn(tree, *rest)


def unflatten(tree_like: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    """A tree of ``tree_like``'s structure whose leaves are ``flat[path]``
    (a missing path raises ``KeyError``)."""
    if isinstance(tree_like, dict):
        return {k: unflatten(v, flat, f"{prefix}{k}/") for k, v in tree_like.items()}
    return None if tree_like is None else flat[prefix[:-1]]
