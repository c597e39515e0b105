"""Logical-axis -> partition-spec rules (``repro.sharding.specs``), the
rank's blocks they give, and the engine's row-shard axis.

``ParamDef`` axes (``models/param.py``) map onto the production grid's
axes by the ``MeshConfig``'s roles (``configs.registry.mesh_roles``).  A
spec is a plain tuple with one entry a dimension: a mesh-axis name, a
tuple of names, or None (replicated) — the entries of the reference's
``PartitionSpec``.  ``rank_params`` cuts a whole parameter tree to one
rank's contiguous block of every leaf, each dim split over its entry's
axes (the tensor axes and, for kimi-k2's serving layout, the FSDP axes
too): the counterpart of the reference placing its weights with
``shardings``.  Serving runs on those blocks (tensor parallelism over
"model", ``models``' ``tp=`` / ``fsdp=`` groups, ``serve.engine``), each
rank given its rows of the served batch (``batch_sharding_spec``) and its
block of the KV cache (``cache_specs``: kv heads over the tensor axis
where they divide it, else the cache's sequence); the dry run
(``launch.dryrun``) reads the same specs for rank 0's blocks
(``block_shape``).  Training splits no weight over "model": a worker's
batch splits over the FSDP axes (``batch_spec``), its state's rows over
the engine's shard axis.  The reference's ``make_mesh`` and
``shardings`` build JAX objects and have no counterpart.

The flat-buffer engine splits every (W, R, C) buffer's rows over the rank
grid's "shard" axis (``comm.collectives.SHARD``), one block of R / S rows
a rank (``engine_shard_axis``, decided against the port's rank grid,
``comm.collectives.WorkerMesh``: its ``axes`` and ``shape``).  The
reference names the axis in ``EngineConfig.shard_axis``; the port's mesh
builders (``launch.mesh``) place only "shard", so the name is fixed.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..comm.collectives import SHARD
from ..configs.base import MeshConfig, ModelConfig
from ..models.param import ParamDef
from .. import tree as tree_mod


def axis_rules(cfg: ModelConfig, mesh_cfg: MeshConfig) -> dict:
    """{logical axis: mesh axes (a tuple) or None} for ``cfg`` on
    ``mesh_cfg``."""
    tensor = tuple(mesh_cfg.tensor_axes)
    fsdp = tuple(mesh_cfg.fsdp_axes)
    worker = tuple(mesh_cfg.worker_axes)
    t = mesh_cfg.tensor_size
    experts_sharded = bool(cfg.num_experts) and cfg.num_experts % t == 0
    return {
        "layers": None,
        "worker": worker if worker else None,
        "vocab": tensor,
        "embed": fsdp if fsdp else None,
        "heads": tensor if cfg.num_heads and cfg.num_heads % t == 0 else None,
        "kv_heads": (tensor if cfg.num_kv_heads
                     and cfg.num_kv_heads % t == 0 else None),
        # expert-parallel: the expert dim takes the tensor axis, so the
        # expert (and shared-expert) ff stays unsharded (no axis twice)
        "ff": None if experts_sharded else tensor,
        "experts": tensor if experts_sharded else None,
        "expert_embed": fsdp if fsdp else None,
        "expert_ff": None,
        "ssm_inner": (tensor if cfg.ssm_state
                      and cfg.ssm_d_inner % t == 0 else None),
        None: None,
    }


def _norm(r):
    """() or None -> None; a 1-tuple -> its name; an n-tuple stays."""
    if not r:
        return None
    if isinstance(r, tuple) and len(r) == 1:
        return r[0]
    return r


def spec_for(d: ParamDef, rules: dict) -> Tuple:
    return tuple(_norm(rules.get(ax, None)) for ax in d.axes)


def partition_specs(defs, cfg: ModelConfig, mesh_cfg: MeshConfig):
    """A tree of specs mirroring a ``ParamDef`` tree."""
    rules = axis_rules(cfg, mesh_cfg)
    return tree_mod.tree_map(lambda d: spec_for(d, rules), defs)


def worker_stacked_spec(spec: Tuple, mesh_cfg: MeshConfig) -> Tuple:
    """The worker axes prepended to an existing spec."""
    return (_norm(tuple(mesh_cfg.worker_axes)), *spec)


def batch_spec(mesh_cfg: MeshConfig, *, worker_stacked: bool,
               extra_dims: int) -> Tuple:
    """Spec of (W, local_batch, ...) train batches or (batch, ...) serve
    batches."""
    w = tuple(mesh_cfg.worker_axes)
    f = tuple(mesh_cfg.fsdp_axes)
    if worker_stacked:
        return (_norm(w), _norm(f), *([None] * extra_dims))
    # serving: the batch over every data-like axis
    return (_norm(w + f), *([None] * extra_dims))


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (a name, a tuple of names, None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh_cfg: MeshConfig, axes: Sequence[str]) -> int:
    sizes = dict(zip(mesh_cfg.axis_names, mesh_cfg.shape))
    return math.prod(sizes[a] for a in axes) if axes else 1


def data_axes(mesh_cfg: MeshConfig) -> Tuple[str, ...]:
    """The data-like axes a served batch splits over: the worker axes,
    then the FSDP axes (the reference's ``_data_axes``)."""
    return tuple(mesh_cfg.worker_axes) + tuple(mesh_cfg.fsdp_axes)


def batch_sharding_spec(mesh_cfg: MeshConfig, batch: int, extra: int, *,
                        worker_stacked: bool) -> Tuple:
    """``batch_spec`` with its batch entry replicated (None) where its
    ranks do not divide ``batch`` (the reference's dry-run rule)."""
    spec = list(batch_spec(mesh_cfg, worker_stacked=worker_stacked,
                           extra_dims=extra))
    i = 1 if worker_stacked else 0
    if batch % axis_size(mesh_cfg, entry_axes(spec[i])):
        spec[i] = None
    return tuple(spec)


def cache_specs(cfg: ModelConfig, mesh_cfg: MeshConfig, batch: int,
                seq_len: int = 0):
    """The reference's spec tree of ``init_cache``'s (layer-stacked)
    structure: the batch over the data-like axes, kv heads over the
    tensor axis when they divide it, else the cache's sequence dim (the
    distributed flash-decode, ``models.attention.decode_attend``)."""
    t = mesh_cfg.tensor_size
    bax = batch_sharding_spec(mesh_cfg, batch, 0, worker_stacked=False)[0]
    tax = _norm(tuple(mesh_cfg.tensor_axes))
    kvh = seq_ax = None
    if cfg.num_kv_heads and cfg.num_kv_heads % t == 0:
        kvh = tax
    elif seq_len and seq_len % t == 0:
        seq_ax = tax
    ssmh = tax if cfg.ssm_state and cfg.ssm_num_heads % t == 0 else None
    attn = {"k": (None, bax, seq_ax, kvh, None),
            "v": (None, bax, seq_ax, kvh, None)}
    ssm_c = {"state": (None, bax, ssmh, None, None),
             "conv": (None, bax, None, None)}
    if cfg.family == "ssm":
        return ssm_c
    if cfg.family == "hybrid":
        return {"attn": attn, "ssm": ssm_c}
    return attn


def block_shape(shape: Sequence[int], spec: Tuple,
                sizes: dict, skip: Sequence[str] = ()) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` laid out by
    ``spec`` over a grid of axis ``sizes``: each dim ÷ the ranks of its
    entry's axes (those in ``skip`` held whole); a dim they do not divide
    is refused."""
    out = []
    for i, n in enumerate(shape):
        axes = [a for a in entry_axes(spec[i] if i < len(spec) else None)
                if a not in skip]
        k = math.prod(sizes[a] for a in axes)
        if n % k:
            raise ValueError(f"a dim of {n} does not split over the {k} "
                             f"ranks of {tuple(axes)} (spec {spec})")
        out.append(n // k)
    return tuple(out)


def _block_index(entry, mesh) -> Tuple[int, int]:
    """(this rank's block index, the block count) along one spec entry's
    axes of ``mesh``, the entry's first axis slowest."""
    axes = entry_axes(entry)
    if not axes:
        return 0, 1
    sizes = [mesh.size((a,)) for a in axes]
    return (int(np.ravel_multi_index(mesh.index(axes), sizes)),
            math.prod(sizes))


def rank_block(t: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """This rank's contiguous block of ``t`` laid out by ``spec`` over
    ``mesh`` (a ``comm.collectives.WorkerMesh`` whose axes the spec
    names): each dim's i-th of n equal parts, i this rank's index along
    the entry's axes.  A copy of its own where any dim splits (the whole
    tensor can be freed), ``t`` itself where none does."""
    out = t
    for dim, entry in enumerate(spec):
        i, n = _block_index(entry, mesh)
        if n == 1:
            continue
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"a dim of {size} does not split over the {n} "
                             f"ranks of {entry_axes(entry)}")
        out = out.narrow(dim, i * (size // n), size // n)
    return out if out is t else out.clone(
        memory_format=torch.contiguous_format)


def rank_params(params, specs, mesh):
    """This rank's block of every leaf of a whole parameter tree, each dim
    split over its spec entry's axes (``partition_specs`` of the model's
    defs on the serving ``MeshConfig``): the weights a rank of the
    serving grid holds."""
    return tree_mod.tree_map(lambda t, s: rank_block(t, s, mesh), params,
                             specs)


def engine_shard_axis(mesh, ecfg) -> Optional[str]:
    """The mesh axis the engine's rows split over, or None.

    None when sharding is off (``shards <= 1``), or when ``mesh`` is None,
    lacks the axis or has it at size 1: the rows then pad to shard boundaries and every
    rank holds all of them (layout only).  An axis of the wrong size
    raises — a silent half-shard would desync the per-shard
    all-reduce."""
    if mesh is None or getattr(ecfg, "shards", 1) <= 1:
        return None
    sizes = dict(zip(mesh.axes, mesh.shape))
    ax = SHARD
    if sizes.get(ax, 1) == 1:
        return None
    if sizes[ax] != ecfg.shards:
        raise ValueError(
            f"engine shards={ecfg.shards} but mesh axis {ax!r} has size "
            f"{sizes[ax]} — the row-shard count must equal the mesh axis "
            f"backing it")
    return ax
