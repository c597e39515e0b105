"""The engine's row-shard axis (``repro.sharding.specs``
``engine_shard_axis``).

The flat-buffer engine splits every (W, R, C) buffer's rows over the rank
grid's "shard" axis (``comm.collectives.SHARD``), one block of R / S rows
a rank.  The placement is decided here, against the port's rank grid
(``comm.collectives.WorkerMesh``: its ``axes`` and ``shape``).  The
reference names the axis in ``EngineConfig.shard_axis``; the port's mesh
builders (``launch.mesh``) place only "shard", so the name is fixed.
"""
from __future__ import annotations

from typing import Optional

from ..comm.collectives import SHARD


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
