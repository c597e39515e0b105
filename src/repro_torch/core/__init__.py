# The paper's algorithms: VRL-SGD and its baselines as thin AlgoSpec
# descriptions executed by core/engine.py (the per-leaf reference executor
# that get_algorithm returns, or the flat-buffer engine over the CUDA
# kernels that make_engine builds).
from repro_torch.core.api import (  # noqa: F401
    Algorithm,
    get_algorithm,
    get_spec,
    list_algorithms,
)
from repro_torch.core.engine import (  # noqa: F401
    BACKENDS,
    AlgoSpec,
    Engine,
    comm_schedule,
    flat_algorithms,
    hier_config,
    make_engine,
    resolve_backend,
)
from repro_torch.core.schedule import (  # noqa: F401
    CommSchedule,
    const_comm,
    custom_stages,
    parse_schedule,
    stagewise_doubling,
)
from repro_torch.core.types import (  # noqa: F401
    CommState,
    FlatWorkerState,
    HierCommState,
    HierFlatState,
    HierState,
    MemberState,
    WorkerState,
)
