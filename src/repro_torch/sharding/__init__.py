# The production layout's partition specs, a rank's blocks of them and the
# engine's row-shard axis (``repro.sharding``; ``make_mesh``, ``shardings``
# and ``maybe_constrain`` build or hint JAX layouts and have no
# counterpart: ``rank_params`` places a rank's weights).
from repro_torch.sharding.specs import (  # noqa: F401
    axis_rules,
    batch_spec,
    engine_shard_axis,
    partition_specs,
    rank_params,
    spec_for,
    worker_stacked_spec,
)
