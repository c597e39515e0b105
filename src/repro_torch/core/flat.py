"""Flat-buffer layout for the algorithm engine (``repro.core.flat``).

The paper's per-step math is elementwise over model-sized buffers, so the
engine keeps parameters and Δ not as a parameter tree but as one
contiguous (rows, lanes) buffer per worker: every leaf raveled in the
tree's flatten order, concatenated, zero-padded to a whole number of
``block``-row tiles.  Worker-stacked state is (W, R, C).

The spec is built from shapes alone (meta tensors or ``(shape, dtype)``
pairs), so nothing is allocated for it, and ``meta()`` is field-for-field
the reference's: with the same template the two packages lay out the same
leaves at the same offsets, and their buffers compare element by element.

``unflatten_*`` return VIEWS into the buffer wherever no dtype cast is
needed — the model forward reads the engine's parameter buffer directly,
and writing the buffer (the update kernels do, in place) is seen by the
tree.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_mod

_BLOCK_CANDIDATES = (1024, 512, 256, 128, 64, 32, 16, 8)


def dtype_name(dt: torch.dtype) -> str:
    """torch.float32 -> "float32" (the reference's numpy-style name)."""
    return str(dt).replace("torch.", "")


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class LeafSpec(NamedTuple):
    path: str          # "/"-joined key path (checkpoint key style)
    shape: Tuple[int, ...]
    dtype: str
    offset: int        # element offset into the flat vector
    size: int


class FlatSpec(NamedTuple):
    leaves: Tuple[LeafSpec, ...]
    size: int                       # total real elements
    lanes: int                      # C — last dim of the 2D buffer
    rows: int                       # R — padded row count (multiple of block)
    block: int                      # row tile height of the layout
    dtype: str                      # buffer dtype for the params buffer
    shards: int = 1                 # row-block shard count: rows are a
                                    # multiple of block * shards, so each
                                    # of S ranks can hold R / S whole
                                    # tiles (core.engine.RowShards)

    @property
    def padded(self) -> int:
        return self.rows * self.lanes

    def meta(self) -> dict:
        """JSON-safe description; equals ``repro.core.flat`` ``meta()``."""
        return {
            "leaves": [{"path": l.path, "shape": list(l.shape),
                        "dtype": l.dtype, "offset": l.offset, "size": l.size}
                       for l in self.leaves],
            "size": self.size, "lanes": self.lanes, "rows": self.rows,
            "block": self.block, "dtype": self.dtype, "shards": self.shards,
        }


def choose_block(rows: int, *, target: int = 1024,
                 max_waste: float = 0.25) -> int:
    """Largest candidate block whose row padding wastes <= ``max_waste``."""
    rows = max(int(rows), 1)
    for b in _BLOCK_CANDIDATES:
        if b > target:
            continue
        padded = -(-rows // b) * b
        if (padded - rows) / padded <= max_waste:
            return b
    return _BLOCK_CANDIDATES[-1]


def _shape_dtype(leaf: Any) -> Tuple[Tuple[int, ...], torch.dtype]:
    if isinstance(leaf, torch.Tensor):
        return tuple(int(s) for s in leaf.shape), leaf.dtype
    shape, dt = leaf
    return tuple(int(s) for s in shape), dt


def make_spec(template: Any, *, lanes: int = 256, block: int = 0,
              max_waste: float = 0.25, shards: int = 1) -> FlatSpec:
    """Build the unravel spec from a SINGLE-MODEL parameter tree.

    Leaves may be tensors (meta tensors allocate nothing) or
    ``(shape, dtype)`` pairs; only shapes and dtypes are read.  ``shards``
    pads rows up to a multiple of ``block * shards``: only zero pad rows
    are added (inert through every update), and ``shards=1`` is the
    unsharded layout.
    """
    leaves = []
    dtypes = []
    off = 0
    for path, leaf in tree_mod.leaves_with_path(template):
        shape, dt = _shape_dtype(leaf)
        size = 1
        for s in shape:
            size *= s
        leaves.append(LeafSpec(path=path, shape=shape, dtype=dtype_name(dt),
                               offset=off, size=size))
        dtypes.append(dt)
        off += size
    if not leaves:
        raise ValueError("empty template tree")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    dtype = dtype_name(functools.reduce(torch.promote_types, dtypes))
    rows_needed = -(-off // lanes)
    blk = int(block) if block else choose_block(rows_needed,
                                                max_waste=max_waste)
    quantum = blk * int(shards)
    rows = -(-rows_needed // quantum) * quantum
    return FlatSpec(leaves=tuple(leaves), size=off, lanes=lanes, rows=rows,
                    block=blk, dtype=dtype, shards=int(shards))


def _check(spec: FlatSpec, tree: Any, stacked: bool) -> list:
    pairs = tree_mod.leaves_with_path(tree)
    if len(pairs) != len(spec.leaves):
        raise ValueError(f"tree has {len(pairs)} leaves, spec has "
                         f"{len(spec.leaves)}")
    lead = 1 if stacked else 0
    for (path, got), want in zip(pairs, spec.leaves):
        if path != want.path or tuple(got.shape[lead:]) != want.shape:
            raise ValueError(f"leaf {path} {tuple(got.shape)} does not match "
                             f"spec {want.path} {want.shape} "
                             f"(stacked={stacked})")
    return [leaf for _, leaf in pairs]


def flatten_tree(spec: FlatSpec, tree: Any,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Single-model tree -> (R, C) buffer.  Exact: pad-only."""
    leaves = _check(spec, tree, stacked=False)
    dt = dtype or dtype_of(spec.dtype)
    out = torch.zeros(spec.padded, dtype=dt, device=leaves[0].device)
    for l, leaf in zip(spec.leaves, leaves):
        out[l.offset:l.offset + l.size].copy_(leaf.reshape(-1))
    return out.view(spec.rows, spec.lanes)


def flatten_stacked(spec: FlatSpec, tree: Any,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Worker-stacked tree (leading axis W on every leaf) -> (W, R, C)."""
    leaves = _check(spec, tree, stacked=True)
    w = leaves[0].shape[0]
    dt = dtype or dtype_of(spec.dtype)
    out = torch.zeros((w, spec.rows, spec.lanes), dtype=dt,
                      device=leaves[0].device)
    vec = out.view(w, -1)
    for l, leaf in zip(spec.leaves, leaves):
        vec[:, l.offset:l.offset + l.size].copy_(leaf.reshape(w, -1))
    return out


def _piece(piece: torch.Tensor, dtype: str) -> torch.Tensor:
    """The leaf in its own dtype: the view itself when the buffer's dtype
    is the leaf's, else a cast copy."""
    want = dtype_of(dtype)
    return piece if piece.dtype == want else piece.to(want)


def unflatten_tree(spec: FlatSpec, buf: torch.Tensor) -> Any:
    """(R, C) buffer -> single-model tree of views into ``buf``."""
    vec = buf.reshape(-1)
    return tree_mod.from_paths(
        [(l.path, _piece(vec[l.offset:l.offset + l.size].view(l.shape),
                         l.dtype)) for l in spec.leaves])


def unflatten_stacked(spec: FlatSpec, buf: torch.Tensor) -> Any:
    """(W, R, C) buffer -> worker-stacked tree ((W, ...) leaves), views."""
    w = buf.shape[0]
    vec = buf.reshape(w, -1)
    return tree_mod.from_paths(
        [(l.path, _piece(vec[:, l.offset:l.offset + l.size]
                         .view((w,) + l.shape), l.dtype))
         for l in spec.leaves])


# ------------------------------------------------- pod-major (P, D, R, C)
# The hierarchical engine carries its worker population as a pod-major grid:
# axis 0 indexes pods (slow cross-pod links), axis 1 the workers inside a
# pod (fast intra-pod links).  The flat layout per worker is IDENTICAL to
# the (W, R, C) one — a grid buffer is the stacked buffer with its worker
# axis split (P, D) — so these are exact reshapes around the stacked
# converters and the same FlatSpec round-trips both.

def flatten_grid(spec: FlatSpec, tree: Any,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Grid-stacked tree ((P, D, ...) leaves) -> (P, D, R, C)."""
    p, d = tree_mod.leaves(tree)[0].shape[:2]
    stacked = tree_mod.tree_map(
        lambda x: x.reshape((p * d,) + tuple(x.shape[2:])), tree)
    buf = flatten_stacked(spec, stacked, dtype=dtype)
    return buf.view(p, d, spec.rows, spec.lanes)


def unflatten_grid(spec: FlatSpec, buf: torch.Tensor) -> Any:
    """(P, D, R, C) buffer -> grid-stacked tree ((P, D, ...) leaves), views
    where no dtype cast is needed."""
    p, d, r, c = buf.shape
    tree = unflatten_stacked(spec, buf.view(p * d, r, c))
    return tree_mod.tree_map(
        lambda x: x.view((p, d) + tuple(x.shape[1:])), tree)
