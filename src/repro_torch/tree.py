"""Nested-dict parameter trees: the slice of ``jax.tree_util`` the port uses.

Parameters stay a dict of tensors in the JAX package's tree layout (nested
dicts, stacked layers on a leading axis).  JAX flattens a dict with its
keys SORTED, and the checkpoint/flat-layout path of a leaf joins its keys
with "/" (``repro.checkpoint._path_str``); these helpers reproduce that
order exactly, so the port's flat buffers line up element by element with
the reference's.  Anything that is not a dict is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's flatten order (sorted keys, depth first)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaves_with_path(tree[k], f"{prefix}/{k}" if prefix
                                    else str(k)))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def pick(tree: Any, i: int) -> Any:
    """The i-th element of every tuple leaf of ``tree`` (to split a tree of
    pairs, as ``tree_map`` over a function returning tuples makes)."""
    if isinstance(tree, dict):
        return {k: pick(v, i) for k, v in tree.items()}
    return tree[i]


def from_paths(pairs: List[Tuple[str, Any]]) -> Dict[str, Any]:
    """Inverse of :func:`leaves_with_path`: rebuild the nested dict."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out
