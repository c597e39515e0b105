"""State checkpoints in the JAX package's file format
(``repro.checkpoint``): atomic single-file npz, the step-dir layout, the
flat-engine helpers and the resharding restore."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    ArrayFile,
    Block,
    SimulatedKill,
    kill_save,
    latest_step,
    load_meta,
    moments_meta,
    restore,
    restore_flat_state,
    save,
    save_flat_state,
    save_step,
    step_dir,
    validate_flat_meta,
)
from repro_torch.checkpoint.reshard import (  # noqa: F401
    restore_resharded,
    saved_workers,
)
