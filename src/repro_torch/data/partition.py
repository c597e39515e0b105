"""Shard→unit data assignment — the port's copy of
``repro.data.partition.contiguous_assignment``."""
from __future__ import annotations

import numpy as np


def contiguous_assignment(n_shards: int,
                          num_units: int) -> list[np.ndarray]:
    """Fresh shard→unit assignment: ``n_shards`` data shards split
    contiguously over ``num_units`` units (the assignment a run starts
    from)."""
    if num_units < 1:
        raise ValueError(f"num_units must be >= 1, got {num_units}")
    if n_shards < num_units:
        raise ValueError(
            f"cannot give every unit a shard: {n_shards} shards "
            f"< {num_units} units")
    shards = np.arange(n_shards, dtype=np.int64)
    return [np.asarray(p, dtype=np.int64)
            for p in np.array_split(shards, num_units)]
