# The production layout's partition specs and the engine's row-shard axis
# (``repro.sharding``; ``make_mesh``, ``shardings`` and ``maybe_constrain``
# build or hint JAX layouts and have no counterpart).
from repro_torch.sharding.specs import (  # noqa: F401
    axis_rules,
    batch_spec,
    engine_shard_axis,
    partition_specs,
    spec_for,
    worker_stacked_spec,
)
