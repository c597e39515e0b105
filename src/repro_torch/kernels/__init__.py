# The port's hand-written CUDA kernels (csrc/, built by build.py) behind
# their wrappers (vrl_update.py, flash_attention.py, ssd_scan.py), with
# plain PyTorch versions beside them (torch_update.py, flash_attention.py,
# ssd_scan.py); ops.py holds the user-facing ops: the attention op, the SSD
# op and the tree-update API over whole parameter trees.
from repro_torch.kernels.ops import (  # noqa: F401
    mha_flash,
    ssd_chunk_scan,
    vrl_local_update_tree,
    vrl_sync_update_tree,
)
