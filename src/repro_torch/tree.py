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


# ------------------------------------------------------------ state trees
# The algorithms' states nest NamedTuples (FlatWorkerState, CommState,
# AdamState, ...), tuples and dicts; the checkpoint keys of their leaves
# are ``jax.tree_util.tree_flatten_with_path``'s as
# ``repro.checkpoint._path_str`` joins them: a NamedTuple field by its
# NAME, a dict key by its value (sorted), a tuple or list entry by its
# index.  ``None`` and empty containers hold no leaf.  A NamedTuple's
# fields keep the class's order, so two classes whose fields differ in
# order but not in name yield the same keys (in another order).

def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def state_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(key, leaf)] of a state tree, the keys the JAX package's
    checkpoints use; a leaf is anything but a dict, tuple, list or
    None."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(state_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def state_map(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """The state tree with every leaf replaced by ``fn(key, leaf)`` (keys
    as :func:`state_leaves`), the containers rebuilt as they were."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: state_map(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(state_map(fn, getattr(tree, f),
                                      f"{prefix}/{f}" if prefix else f)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(state_map(fn, v, f"{prefix}/{i}" if prefix
                                    else str(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)
