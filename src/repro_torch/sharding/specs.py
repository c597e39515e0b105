"""Logical-axis -> partition-spec rules (``repro.sharding.specs``), and the
engine's row-shard axis.

``ParamDef`` axes (``models/param.py``) map onto the production grid's
axes by the ``MeshConfig``'s roles (``configs.registry.mesh_roles``).  A
spec is a plain tuple with one entry a dimension: a mesh-axis name, a
tuple of names, or None (replicated) — the entries of the reference's
``PartitionSpec``.  The port runs no tensor parallelism; the dry run
(``launch.dryrun``) reads these specs for what rank 0 of the production
grid holds: its block of every input (``batch_spec``, its batch dim split
over the data-like axes, which a training step takes as its fsdp slice)
and whether a served model's weights split over FSDP axes, which it
refuses (``partition_specs``, ``worker_stacked_spec``).  The reference's
``make_mesh`` and ``shardings`` build JAX objects and have no
counterpart.

The flat-buffer engine splits every (W, R, C) buffer's rows over the rank
grid's "shard" axis (``comm.collectives.SHARD``), one block of R / S rows
a rank (``engine_shard_axis``, decided against the port's rank grid,
``comm.collectives.WorkerMesh``: its ``axes`` and ``shape``).  The
reference names the axis in ``EngineConfig.shard_axis``; the port's mesh
builders (``launch.mesh``) place only "shard", so the name is fixed.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
