# Synthetic data, partitions and the per-worker loader (``repro.data``):
# numpy, the reference's draws in the reference's order.
from repro_torch.data.loader import WorkerLoader  # noqa: F401
from repro_torch.data.partition import (  # noqa: F401
    assignment_from_meta,
    assignment_to_meta,
    class_shard_partition,
    contiguous_assignment,
    dirichlet_partition,
    iid_partition,
    label_skew,
    repartition,
)
from repro_torch.data.synthetic import (  # noqa: F401
    ClassificationData,
    assigned_token_stream,
    feature_classification,
    gaussian_classification,
    lm_token_stream,
)
