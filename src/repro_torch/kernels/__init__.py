# The port's hand-written CUDA kernels (csrc/, built by build.py) behind
# their wrappers (vrl_update.py), with plain PyTorch versions beside them
# (torch_update.py); ops.py is the tree-update API over whole parameter
# trees.
from repro_torch.kernels.ops import (  # noqa: F401
    vrl_local_update_tree,
    vrl_sync_update_tree,
)
