# The paper's own workload (§6, Appendices E-F): the MLP task's training
# protocol (task.py, the port's copy of benchmarks/common.py) and the
# figures built on it (figures.py; python -m repro_torch.paper.figures).
from repro_torch.paper.task import (  # noqa: F401
    TaskRun,
    mlp_init,
    mlp_logits,
    mlp_loss,
    mlp_task,
    run_mlp_task,
    worker_grads,
)
